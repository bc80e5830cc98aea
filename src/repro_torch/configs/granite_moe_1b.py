"""granite-moe-1b-a400m [moe] 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m]"""

from repro_torch.models.config import BlockSpec, MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    pattern=(BlockSpec(mlp=MOE),),
    repeats=24,
    moe=MoEConfig(num_experts=32, experts_per_token=8, d_ff=512,
                  capacity_factor=1.25,
                  use_shard_map=True),   # the reference's choice (its meshes)
    vocab_pad_multiple=2048,             # 49155 -> TP-divisible
).validate()


def smoke_config():
    return ModelConfig(
        name="granite-moe-1b-a400m-smoke",
        family="moe",
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=64,
        vocab_size=515,
        pattern=(BlockSpec(mlp=MOE),),
        repeats=2,
        moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff=48,
                      capacity_factor=1.25),
    ).validate()
