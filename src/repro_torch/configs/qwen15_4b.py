"""qwen1.5-4b [dense] 40L d_model=2560 20H (MHA kv=20) d_ff=6912
vocab=151936 — QKV bias.  [hf:Qwen/Qwen1.5-0.5B family]"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    pattern=(BlockSpec(),),
    repeats=40,
    qkv_bias=True,
).validate()


def smoke_config():
    return ModelConfig(
        name="qwen1.5-4b-smoke",
        family="dense",
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=160,
        vocab_size=503,
        pattern=(BlockSpec(),),
        repeats=2,
        qkv_bias=True,
    ).validate()
