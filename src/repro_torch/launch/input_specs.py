"""Meta-device stand-ins for every model input (no allocation): the port
of ``repro.launch.input_specs``.

``batch_specs(cfg, shape_name)`` returns (step_kind, batch_specs, seq)
where batch_specs are the inputs of the corresponding step function:

  train   : {"tokens"/"frames", "labels" [, "vision"]}
  prefill : {"tokens"/"frames" [, "vision"]}
  decode  : {"tokens" (B, 1)}, plus pos and the cache built separately
"""

from __future__ import annotations

import torch

from repro_torch.configs import SHAPES
from repro_torch.models.config import ModelConfig


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape_name: str):
    seq, gbatch, kind = SHAPES[shape_name]
    if kind == "decode":
        # the vision embeddings were consumed at prefill; decode reads the
        # cross-attention cache, so tokens are its only input
        return kind, {"tokens": _meta((gbatch, 1), torch.int32)}, seq
    specs = {}
    if cfg.audio is not None:
        specs["frames"] = _meta((gbatch, seq, cfg.audio.feat_dim),
                                torch.bfloat16)
    else:
        specs["tokens"] = _meta((gbatch, seq), torch.int32)
    if cfg.vision is not None:
        specs["vision"] = _meta((gbatch, cfg.vision.seq_len,
                                 cfg.vision.embed_dim), torch.bfloat16)
    if kind == "train":
        specs["labels"] = _meta((gbatch, seq), torch.int32)
    return kind, specs, seq
