"""recurrentgemma-9b [hybrid] 38 blocks d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000 — RG-LRU : local-attn 2:1 (Griffin), window 2048.
[arXiv:2402.19427]"""

from repro_torch.models.config import BlockSpec, ModelConfig, RGLRU, RGLRUConfig

_REC = BlockSpec(mixer=RGLRU)
_ATT = BlockSpec(window=2048)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    pattern=(_REC, _REC, _ATT),
    repeats=12,
    suffix=(_REC, _REC),            # 38 = 3*12 + 2
    rglru=RGLRUConfig(width=4096, conv_width=4),
).validate()


def smoke_config():
    return ModelConfig(
        name="recurrentgemma-9b-smoke",
        family="hybrid",
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=160,
        vocab_size=613,
        pattern=(BlockSpec(mixer=RGLRU), BlockSpec(mixer=RGLRU),
                 BlockSpec(window=16)),
        repeats=2,
        suffix=(BlockSpec(mixer=RGLRU),),
        rglru=RGLRUConfig(width=64, conv_width=4),
    ).validate()
