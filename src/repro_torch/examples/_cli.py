"""The examples' device flags."""

from __future__ import annotations

import argparse
from typing import Tuple

import torch

from repro_torch.ax.backends import get_backend
from repro_torch.ax.engine import resolve_device


def add_device_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--backend", default=None, choices=("cuda", "torch"),
                    help="cuda: the kernels (the card's default); torch: "
                         "their plain versions (the CPU's only choice)")


def backend_and_device(args) -> Tuple[str, torch.device]:
    """(backend name, device) of the flags: ``--device cuda`` is the card
    (raising without one, as the engines do), ``--device cpu`` the
    ``"torch"`` backend on the CPU."""
    backend = args.backend or ("cuda" if args.device == "cuda" else "torch")
    return backend, resolve_device(get_backend(backend), args.device)
