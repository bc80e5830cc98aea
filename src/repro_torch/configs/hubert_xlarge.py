"""hubert-xlarge [audio] 48L d_model=1280 16H d_ff=5120 vocab=504 —
encoder-only (bidirectional), frame-classification head; the CNN feature
extractor frontend is STUBBED (input_specs provides 512-d conv features).
[arXiv:2106.07447]"""

from repro_torch.models.config import AudioStubConfig, BlockSpec, GELU, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    pattern=(BlockSpec(mlp=GELU),),
    repeats=48,
    causal=False,
    audio=AudioStubConfig(feat_dim=512),
).validate()


def smoke_config():
    return ModelConfig(
        name="hubert-xlarge-smoke",
        family="audio",
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=160,
        vocab_size=97,
        pattern=(BlockSpec(mlp=GELU),),
        repeats=2,
        causal=False,
        audio=AudioStubConfig(feat_dim=24),
    ).validate()
