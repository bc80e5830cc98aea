"""deepseek-v2-236b [moe] 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400 — MLA (kv_lora=512, q_lora=1536, rope_dim=64), 2 shared + 160
routed experts top-6; first layer dense (d_ff=12288).  [arXiv:2405.04434]"""

import dataclasses

from repro_torch.models.config import (
    BlockSpec, MLA, MLAConfig, MOE, ModelConfig, MoEConfig,
)

_DENSE = BlockSpec(mixer=MLA, mlp="swiglu")
_MOE = BlockSpec(mixer=MLA, mlp=MOE)

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,        # MLA: per-head K/V decompressed from latent
    head_dim=128,            # nope head dim; rope adds 64
    d_ff=12288,              # dense (first-layer) FFN width
    vocab_size=102400,
    prefix=(_DENSE,),
    pattern=(_MOE,),
    repeats=59,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=160, experts_per_token=6, d_ff=1536,
                  num_shared_experts=2, shared_d_ff=2 * 1536,
                  capacity_factor=1.25, seq_chunks=8,
                  dispatch_pin=False,    # E=160: worse in the reference
                  use_shard_map=True),   # the reference's choice (its meshes)
).validate()


def smoke_config():
    return ModelConfig(
        name="deepseek-v2-236b-smoke",
        family="moe",
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=419,
        prefix=(_DENSE,),
        pattern=(_MOE,),
        repeats=2,
        mla=MLAConfig(kv_lora_rank=24, q_lora_rank=32, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(num_experts=8, experts_per_token=3, d_ff=32,
                      num_shared_experts=2, shared_d_ff=64,
                      capacity_factor=1.25, seq_chunks=2),
    ).validate()
