"""gemma3-27b [dense] 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5 local (window 1024) : 1 global, 128k context.
[hf:google/gemma-3 family]"""

from repro_torch.models.config import BlockSpec, ModelConfig

_LOCAL = BlockSpec(window=1024, rope_base=10_000.0)
_GLOBAL = BlockSpec(window=0, rope_base=1_000_000.0)

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    repeats=10,
    suffix=(_LOCAL, _LOCAL),        # 62 = 6*10 + 2
    qk_norm=True,
).validate()


def smoke_config():
    return ModelConfig(
        name="gemma3-27b-smoke",
        family="dense",
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=160,
        vocab_size=601,
        pattern=(BlockSpec(window=16), BlockSpec(window=16),
                 BlockSpec(window=0, rope_base=1e6)),
        repeats=2,
        suffix=(BlockSpec(window=16),),
        qk_norm=True,
    ).validate()
