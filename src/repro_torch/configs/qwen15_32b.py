"""qwen1.5-32b [dense] 64L d_model=5120 40H (MHA kv=40) d_ff=27392
vocab=152064 — QKV bias.  [hf:Qwen/Qwen1.5-0.5B family]"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    pattern=(BlockSpec(),),
    repeats=64,
    qkv_bias=True,
).validate()


def smoke_config():
    return ModelConfig(
        name="qwen1.5-32b-smoke",
        family="dense",
        d_model=96,
        num_heads=6,
        num_kv_heads=6,
        head_dim=16,
        d_ff=256,
        vocab_size=640,
        pattern=(BlockSpec(),),
        repeats=2,
        qkv_bias=True,
    ).validate()
