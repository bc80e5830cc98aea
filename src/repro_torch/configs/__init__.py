"""Architecture registry: ``get_config(name)`` / ``--arch <id>`` (the
port's copy of ``repro.configs``).

Each module defines ``CONFIG`` (full size) and ``smoke_config()`` (a
reduced same-family config for CPU tests), plus the per-arch input-shape
table used by the launcher.  Every family's configs are here; the port's
transformer runs the dense, MoE, hybrid (RG-LRU + local attention) and
SSM families and raises for the vision and audio ones' cross attention
and inputs (ROADMAP Queue A item 3).
"""

from __future__ import annotations

import importlib
from typing import Dict

_ARCHS = {
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "gemma3-27b": "gemma3_27b",
    "qwen1.5-4b": "qwen15_4b",
    "qwen1.5-32b": "qwen15_32b",
    "qwen3-4b": "qwen3_4b",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-1.3b": "mamba2_13b",
}

# (seq_len, global_batch, step kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# Cells skipped per the brief (documented in DESIGN.md §shape-skips).
SKIPS = {
    ("hubert-xlarge", "decode_32k"): "encoder-only: no autoregressive decode",
    ("hubert-xlarge", "long_500k"): "encoder-only: no autoregressive decode",
}
_FULL_ATTN = ("llama-3.2-vision-11b", "deepseek-v2-236b",
              "granite-moe-1b-a400m", "gemma3-27b", "qwen1.5-4b",
              "qwen1.5-32b", "qwen3-4b")
for _a in _FULL_ATTN:
    SKIPS[(_a, "long_500k")] = "pure full-attention arch (brief: skip 500k)"


def arch_names():
    return tuple(_ARCHS)


def _module(name: str):
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).smoke_config()


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells, skips excluded by default."""
    out = []
    for a in _ARCHS:
        for s in SHAPES:
            if not include_skipped and (a, s) in SKIPS:
                continue
            out.append((a, s))
    return out
