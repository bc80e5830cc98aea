"""llama-3.2-vision-11b [vlm] 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers every 5th; vision frontend STUBBED
(input_specs provides precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision]"""

from repro_torch.models.config import (
    BlockSpec, CROSS, ModelConfig, VisionStubConfig,
)

_SELF = BlockSpec(rope_base=500_000.0)
_CROSS = BlockSpec(mixer=CROSS)

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    pattern=(_SELF, _SELF, _SELF, _SELF, _CROSS),   # 40 = 5 * 8
    repeats=8,
    vision=VisionStubConfig(seq_len=1601, embed_dim=4096),
).validate()


def smoke_config():
    return ModelConfig(
        name="llama-3.2-vision-11b-smoke",
        family="vlm",
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=160,
        vocab_size=601,
        pattern=(BlockSpec(), BlockSpec(mixer=CROSS)),
        repeats=2,
        vision=VisionStubConfig(seq_len=17, embed_dim=48),
    ).validate()
