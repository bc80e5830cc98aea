"""qwen3-4b [dense] 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family]"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    pattern=(BlockSpec(rope_base=1_000_000.0),),
    repeats=36,
    qk_norm=True,
).validate()


def smoke_config():
    return ModelConfig(
        name="qwen3-4b-smoke",
        family="dense",
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=509,
        pattern=(BlockSpec(rope_base=1_000_000.0),),
        repeats=2,
        qk_norm=True,
    ).validate()
