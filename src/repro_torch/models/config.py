"""Model configuration (the port's copy of ``repro.models.config``).

A model is described as a sequence of residual blocks:

    prefix blocks + (pattern blocks) * repeats + suffix blocks

The reference runs the repeated pattern with ``jax.lax.scan`` over
stacked parameters; the port runs one block per repeat, in order, each
with its own parameters.  Every assigned architecture maps onto this
scheme:

    gemma3-27b          pattern=(local x5, global), repeats=10, suffix=(local x2)
    recurrentgemma-9b   pattern=(rglru, rglru, local), repeats=12, suffix=(rglru, rglru)
    llama-3.2-vision    pattern=(self x4, cross), repeats=8
    deepseek-v2         prefix=(mla+dense), pattern=(mla+moe,), repeats=59
    qwen/hubert/mamba2  pattern=(block,), repeats=num_layers
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.numerics.approx_ops import ApproxNumericsConfig

# Mixer kinds.
ATTN = "attn"          # self attention (global or windowed via `window`)
CROSS = "cross"        # cross attention over stub vision embeddings
MLA = "mla"            # DeepSeek multi-head latent attention
RGLRU = "rglru"        # RecurrentGemma real-gated LRU block
SSD = "ssd"            # Mamba-2 state-space duality block

# MLP kinds.
SWIGLU = "swiglu"
GELU = "gelu"          # 2-matrix GELU MLP (HuBERT)
MOE = "moe"
NONE = "none"          # SSD blocks carry their own channel mixing


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str = ATTN
    mlp: str = SWIGLU
    window: int = 0            # 0 = full (causal) attention
    rope_base: float = 10_000.0

    def __post_init__(self):
        assert self.mixer in (ATTN, CROSS, MLA, RGLRU, SSD), self.mixer
        assert self.mlp in (SWIGLU, GELU, MOE, NONE), self.mlp


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    # Sequence is processed in this many sequential chunks inside the MoE
    # layer to bound the (B, E, C, D) dispatch buffers (memory knob).
    seq_chunks: int = 1
    router_jitter: float = 0.0
    # Manual shard_map expert-parallel dispatch (local expert slicing +
    # one psum combine) — the beyond-GSPMD path; see models/moe.py.
    use_shard_map: bool = False
    # Pin dispatch buffers batch-sharded so gathers stay shard-local; the
    # reference sets it per arch (it helps narrow expert sets and hurts
    # wide ones on the reference's meshes; not measured on the port).
    dispatch_pin: bool = True


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # Decode path: "decompress" (naive baseline) or "absorbed" (latent-space
    # attention; the optimized variant).
    decode_mode: str = "decompress"


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    width: int = 4096          # recurrence width
    conv_width: int = 4
    c_exponent: float = 8.0    # the fixed `c` of a_t = exp(-c softplus(L) r_t)


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    d_inner: int = 4096
    d_state: int = 128
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256           # SSD chunk length


@dataclasses.dataclass(frozen=True)
class VisionStubConfig:
    """Precomputed patch embeddings are the model input (frontend stubbed)."""
    seq_len: int = 1601        # 1 CLS + 40x40 patches (Llama-3.2 tile)
    embed_dim: int = 4096      # already projected to d_model width


@dataclasses.dataclass(frozen=True)
class AudioStubConfig:
    """Precomputed conv-feature frames are the model input."""
    feat_dim: int = 512


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    prefix: Tuple[BlockSpec, ...] = ()
    pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)
    repeats: int = 1
    suffix: Tuple[BlockSpec, ...] = ()
    causal: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rglru: Optional[RGLRUConfig] = None
    ssd: Optional[SSDConfig] = None
    vision: Optional[VisionStubConfig] = None
    audio: Optional[AudioStubConfig] = None
    approx: ApproxNumericsConfig = ApproxNumericsConfig()
    # Attention memory knob: kv-chunk size for the online-softmax path.
    attn_kv_chunk: int = 1024
    # Activation checkpointing policy: "none" | "block" (remat each block).
    remat: str = "block"
    # Sequence parallelism: shard the residual stream (and the remat-saved
    # scan carry) over the "model" axis between blocks (Megatron-SP style;
    # GSPMD inserts the all-gather/reduce-scatter pairs at region edges).
    seq_shard: bool = False
    # Pad the vocab (embedding + lm head) to a multiple of this so the
    # vocab dim shards over TP even for awkward sizes (e.g. granite's
    # 49155); padded logits are masked to -inf in the loss (exact CE).
    vocab_pad_multiple: int = 1

    @property
    def num_layers(self) -> int:
        return len(self.prefix) + len(self.pattern) * self.repeats + len(self.suffix)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m if m > 1 else self.vocab_size

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def all_blocks(self) -> Tuple[BlockSpec, ...]:
        return self.prefix + self.pattern * self.repeats + self.suffix

    def with_approx(self, approx: ApproxNumericsConfig) -> "ModelConfig":
        return dataclasses.replace(self, approx=approx)

    def validate(self) -> "ModelConfig":
        assert self.num_heads % self.num_kv_heads == 0, "GQA group must divide"
        for b in self.all_blocks():
            if b.mlp == MOE:
                assert self.moe is not None
            if b.mixer == MLA:
                assert self.mla is not None
            if b.mixer == RGLRU:
                assert self.rglru is not None
            if b.mixer == SSD:
                assert self.ssd is not None
            if b.mixer == CROSS:
                assert self.vision is not None
        return self
