"""Deterministic, resumable synthetic data pipeline (the port's copy of
``repro.data.pipeline``: the same numpy streams, so its batches are the
reference's bit for bit).

Every batch is a pure function of (seed, step) so restart-from-checkpoint
reproduces the exact stream with NO data-loader state to persist — the
fault-tolerance property the runtime relies on.  Host sharding: each data-
parallel host materializes only its slice of the global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 512
    global_batch: int = 8
    seed: int = 1234
    # optional host slicing (host_id, num_hosts)
    host_id: int = 0
    num_hosts: int = 1


def _rng_for(cfg: DataConfig, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence((cfg.seed, step, host)))


def synthetic_batch(model_cfg: ModelConfig, cfg: DataConfig,
                    step: int) -> Dict[str, np.ndarray]:
    """Token stream with local structure (Zipf unigrams + copy motif) so a
    model actually LEARNS something measurable in a few hundred steps."""
    assert cfg.global_batch % cfg.num_hosts == 0
    local = cfg.global_batch // cfg.num_hosts
    rng = _rng_for(cfg, step, cfg.host_id)
    v = model_cfg.vocab_size
    if model_cfg.audio is not None:
        frames = rng.normal(0, 1, (local, cfg.seq_len,
                                   model_cfg.audio.feat_dim)).astype(np.float32)
        labels = rng.integers(0, v, (local, cfg.seq_len), dtype=np.int64)
        return {"frames": frames, "labels": labels.astype(np.int32)}
    # Zipfian unigram base
    toks = rng.zipf(1.3, size=(local, cfg.seq_len + 1)).astype(np.int64)
    toks = np.minimum(toks, v - 1)
    # periodic copy motif: second half of each 64-window repeats the first
    w = 64
    for s0 in range(0, cfg.seq_len + 1 - w, w):
        toks[:, s0 + w // 2:s0 + w] = toks[:, s0:s0 + w // 2]
    batch = {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }
    if model_cfg.vision is not None:
        batch["vision"] = rng.normal(
            0, 1, (local, model_cfg.vision.seq_len,
                   model_cfg.vision.embed_dim)).astype(np.float32)
    return batch


class DataIterator:
    """Step-indexed iterator; `skip_to(step)` is O(1) (resume support)."""

    def __init__(self, model_cfg: ModelConfig, cfg: DataConfig,
                 start_step: int = 0):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.step = start_step

    def skip_to(self, step: int):
        self.step = step

    def __iter__(self):
        return self

    def __next__(self):
        b = synthetic_batch(self.model_cfg, self.cfg, self.step)
        self.step += 1
        return b
