"""mamba2-1.3b [ssm] 48L d_model=2048 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality), d_inner=4096, 64 heads x 64.
[arXiv:2405.21060]"""

from repro_torch.models.config import BlockSpec, ModelConfig, NONE, SSD, SSDConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    d_model=2048,
    num_heads=64,            # SSD heads (d_inner / head_dim)
    num_kv_heads=64,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    pattern=(BlockSpec(mixer=SSD, mlp=NONE),),
    repeats=48,
    ssd=SSDConfig(d_inner=4096, d_state=128, head_dim=64, n_groups=1,
                  conv_width=4, chunk=256),
).validate()


def smoke_config():
    return ModelConfig(
        name="mamba2-1.3b-smoke",
        family="ssm",
        d_model=64,
        num_heads=8,
        num_kv_heads=8,
        head_dim=16,
        d_ff=0,
        vocab_size=761,
        pattern=(BlockSpec(mixer=SSD, mlp=NONE),),
        repeats=2,
        ssd=SSDConfig(d_inner=128, d_state=16, head_dim=16, n_groups=1,
                      conv_width=4, chunk=8),
    ).validate()
