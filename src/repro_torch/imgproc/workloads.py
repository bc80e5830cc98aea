"""Workload registry: named image-processing tasks over the port's
engines (the port of ``repro.imgproc.workloads``).

A workload maps a batch of uint8 images to processed uint8 images (a host
array) for a given adder kind/backend/device, paired with the ideal
reference output the corpus scores against.  Three sources register
here:

- every operator in :mod:`repro_torch.imgproc.ops`, run once on the
  whole batch,
- every stock pipeline in :data:`repro_torch.imgproc.plan.PIPELINES`,
- ``conv3x3``, a 3x3 MAC convolution through ``engine.conv2d`` (every
  tap product through the approximate multiplier, the taps through the
  N=16 adder), and
- the paper's Fig-5 FFT -> IFFT reconstruction
  (:func:`repro_torch.image.pipeline.reconstruct`) at the paper's N=32
  adders, whose reference is the source image itself.

Binary operators pair each image with the next one in the batch
(``roll(imgs, 1)``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.imgproc import ops as ops_lib


@dataclasses.dataclass(frozen=True)
class Workload:
    """One registered task.

    Attributes:
      name: registry key.
      run: ``(imgs, kind, backend, fast, strategy, device, **kw) -> uint8
        batch`` (host array).
      reference: ``(imgs, **kw) -> uint8 batch`` (ideal float path).
      batched: one of the batched image operators or pipelines (False
        for the FFT reconstruction, which the corpus only includes on
        request).
    """

    name: str
    run: Callable
    reference: Callable
    batched: bool = True


WORKLOADS: Dict[str, Workload] = {}


def register_workload(workload: Workload) -> Workload:
    if workload.name in WORKLOADS:
        raise ValueError(f"workload {workload.name!r} already registered")
    WORKLOADS[workload.name] = workload
    return workload


def get_workload(name: str) -> Workload:
    try:
        return WORKLOADS[name]
    except KeyError:
        raise KeyError(f"unknown workload {name!r}; registered: "
                       f"{sorted(WORKLOADS)}") from None


def workload_names(batched_only: bool = False) -> Tuple[str, ...]:
    return tuple(sorted(n for n, w in WORKLOADS.items()
                        if w.batched or not batched_only))


# ------------------------------------------------- operator workloads --

def _pair(imgs):
    """Second operand for binary operators: each image with the next."""
    return np.roll(np.asarray(imgs), 1, axis=0)


def _operator_workload(op: ops_lib.ImageOp) -> Workload:
    def run(imgs, kind="haloc_axa", backend=None, fast=False,
            strategy=None, device=None, **kw):
        ax = ops_lib.make_image_engine(kind, backend=backend, fast=fast,
                                       strategy=strategy, device=device)
        imgs = np.asarray(imgs)
        if op.n_inputs == 2:
            out = op.fn(imgs, _pair(imgs), ax, **kw)
        else:
            out = op.fn(imgs, ax, **kw)
        return out.cpu().numpy()

    def reference(imgs, **kw):
        imgs = np.asarray(imgs)
        if op.n_inputs == 2:
            return op.reference(imgs, _pair(imgs), **kw)
        return op.reference(imgs, **kw)

    return Workload(name=op.name, run=run, reference=reference)


for _op in ops_lib.OPERATORS.values():
    register_workload(_operator_workload(_op))


# ------------------------------------------------ pipeline workloads --

def _pipeline_workload(name: str, stages) -> Workload:
    def _reject_kw(kw):
        # Pipeline options belong to their stage spec; a flat kwarg can't
        # name its stage, so dropping it silently would skew the cell.
        if kw:
            raise ValueError(
                f"pipeline workload {name!r} takes no per-call kwargs "
                f"(got {sorted(kw)}); bake options into the stage "
                f"specs of repro_torch.imgproc.plan.PIPELINES")

    def run(imgs, kind="haloc_axa", backend=None, fast=False,
            strategy=None, device=None, requant="stage", **kw):
        from repro_torch.imgproc.plan import run_pipeline
        _reject_kw(kw)
        return run_pipeline(stages, imgs, kind=kind, backend=backend,
                            fast=fast, strategy=strategy, requant=requant,
                            device=device)

    def reference(imgs, requant="stage", **kw):
        # requant is an execution knob: both modes score against the
        # SAME golden.
        del requant
        _reject_kw(kw)
        x = np.asarray(imgs)
        for st in stages:
            op_name, okw = (st, {}) if isinstance(st, str) else st
            x = ops_lib.get_operator(op_name).reference(x, **okw)
        return x

    return Workload(name=name, run=run, reference=reference)


def _register_pipelines():
    from repro_torch.imgproc.plan import PIPELINES
    for name, stages in PIPELINES.items():
        register_workload(_pipeline_workload(name, stages))


_register_pipelines()


# -------------------------------------------------- MAC conv workload --

#: 3x3 learned-style smoothing kernel with a non-power-of-two weight sum
#: (21): every tap product must run a real multiplier (no shift-and-add
#: escape), which is what the MAC datapath (engine.conv2d) exists for.
CONV3X3_KERNEL = ((1, 3, 1), (3, 5, 3), (1, 3, 1))
_CONV3X3_SUM = 21


def conv3x3_normalize(v: torch.Tensor) -> torch.Tensor:
    """The workload's exact rounded /21 of the conv sums, clipped to
    uint8, where ``v`` lies: ``clip((v + 10) // 21, 0, 255)`` with floor
    division (approximate adders can make sums negative or above
    255 * 21)."""
    out = torch.div(v + _CONV3X3_SUM // 2, _CONV3X3_SUM,
                    rounding_mode="floor")
    return out.clamp_(0, 255).to(torch.uint8)


def _conv3x3_run(imgs, kind="haloc_axa", backend=None, fast=False,
                 strategy=None, device=None, mul=None):
    """3x3 MAC convolution through ``engine.conv2d``: pixel values
    (|q| < 2^8, the 8-bit multiplier operand domain) hit the approximate
    multiplier at every tap, tap sums fold through the N=16 approximate
    adder (headroom: 255 * 21 = 5355 < 2^15), and the /21 normalization
    is one exact rounded division on the engine's device, so only the
    uint8 result comes back.  ``mul`` accepts a MulSpec or kind name
    (default: truncated t=3)."""
    from repro_torch.ax.mul import MulSpec
    if mul is None:
        mul = MulSpec("truncated", n_bits=8, trunc_bits=3)
    ax = ops_lib.make_image_engine(kind, backend=backend, fast=fast,
                                   strategy=strategy,
                                   device=device).replace(mul=mul)
    q = ax.tensor(np.asarray(imgs)).to(torch.int32)
    return conv3x3_normalize(ax.conv2d(q, CONV3X3_KERNEL)).cpu().numpy()


def _conv3x3_reference(imgs, mul=None, **_kw):
    """Exact integer conv and the same rounded /21, so an exact adder AND
    an exact multiplier reproduce it bit for bit (``mul`` is an execution
    knob; every configuration scores against this one golden)."""
    del mul
    x = np.asarray(imgs).astype(np.int64)
    p = np.pad(x, [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)], mode="edge")
    h, w = x.shape[-2], x.shape[-1]
    acc = np.zeros_like(x)
    for dy, row in enumerate(CONV3X3_KERNEL):
        for dx, wt in enumerate(row):
            acc = acc + wt * p[..., dy:dy + h, dx:dx + w]
    out = (acc + _CONV3X3_SUM // 2) // _CONV3X3_SUM
    return np.clip(out, 0, 255).astype(np.uint8)


register_workload(Workload(name="conv3x3", run=_conv3x3_run,
                           reference=_conv3x3_reference))


# -------------------------------------------- FFT->IFFT reconstruction --

def _fft_run(imgs, kind="haloc_axa", backend=None, fast=False,
             strategy=None, device=None, frac_bits: int = 6,
             block: int = 16):
    """Paper Fig-5 reconstruction: block FFT -> IFFT of each image through
    the N=32 adder datapath, the whole batch in one transform.
    ``fast``/``strategy`` are part of the uniform workload call signature
    but have no effect here: the butterflies' adds are bit-identical in
    every form."""
    del fast, strategy
    from repro_torch.core.specs import paper_spec
    from repro_torch.image.pipeline import reconstruct
    out = reconstruct(np.asarray(imgs), paper_spec(kind),
                      frac_bits=frac_bits, block=block, backend=backend,
                      device=device)
    return out.cpu().numpy()


def _fft_reference(imgs, **_kw):
    """An exact FFT->IFFT round trip is the identity: the source batch."""
    return np.asarray(imgs).astype(np.uint8)


register_workload(Workload(name="fft_reconstruct", run=_fft_run,
                           reference=_fft_reference, batched=False))
