"""Compiled image-processing pipelines (the port of
``repro.imgproc.plan``): a chain of operators as one callable.

The reference compiles the chain as ``jit(vmap(chain))``; PyTorch runs
eagerly, so here the chain runs once on the whole (B, H, W) batch —
every operator takes leading batch dims — and each operator's
separable passes are one kernel launch on the ``"cuda"`` backend.

Two requantization modes select what flows BETWEEN stages:

- ``requant="stage"`` (default): each stage rounds and saturates to
  uint8 exactly as the standalone operators do — bit-identical to
  running the stages one by one.
- ``requant="fused"``: the chain runs end to end in the int32
  fixed-point domain through the operators' raw Q-forms (one quantize
  at entry, one round/clip at exit, three integer ops per seam).
  Bit-identical to stage mode for chains whose q-forms are all
  ``exact`` (every stock pipeline); :func:`fused_psnr_gate` scores both
  modes against the ideal float reference.

    from repro_torch.imgproc import compile_pipeline

    pipe = compile_pipeline(("gaussian_blur", "sharpen", "downsample2x"),
                            kind="haloc_axa", requant="fused")
    out = pipe(batch)            # uint8 (B, H, W) in -> uint8 tensor out
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, \
    Tuple, Union

import numpy as np
import torch

from repro_torch.ax.backends import resolve_strategy
from repro_torch.imgproc import ops as ops_lib

#: One stage: an operator name, optionally with fixed keyword arguments.
StageSpec = Union[str, Tuple[str, Dict[str, Any]]]

#: Legal inter-stage requantization modes.
REQUANT_MODES = ("stage", "fused")

#: Stock multi-stage pipelines swept by the corpus (registered as
#: workloads): a denoise->enhance->shrink chain and an edge pipeline.
PIPELINES: Dict[str, Tuple[StageSpec, ...]] = {
    "pipe_blur_sharpen_down": ("gaussian_blur", "sharpen", "downsample2x"),
    "pipe_blur_sobel": ("gaussian_blur", "sobel"),
}


def check_requant(requant: str) -> str:
    if requant not in REQUANT_MODES:
        raise ValueError(
            f"unknown requant mode {requant!r}; one of {REQUANT_MODES}")
    return requant


def _norm_stages(stages: Sequence[StageSpec]):
    """Hashable ((name, ((kw, val), ...)), ...) form; validates ops."""
    norm = []
    for st in stages:
        name, kw = (st, {}) if isinstance(st, str) else st
        op = ops_lib.get_operator(name)
        if op.n_inputs != 1:
            raise ValueError(
                f"pipelines chain unary operators; {name!r} takes "
                f"{op.n_inputs} images")
        norm.append((name, tuple(sorted(kw.items()))))
    if not norm:
        raise ValueError("empty pipeline")
    return tuple(norm)


@dataclasses.dataclass(frozen=True)
class CompiledPipeline:
    """A chain of operators as one callable.

    Attributes:
      stages: normalized (name, kwargs-items) tuples, in order.
      engine: the shared base image engine.
      requant: inter-stage requantization mode ("stage" | "fused").
      chain: ``uint8 (..., H, W) -> uint8`` tensor on the engine's
        device; calling the pipeline runs it on the whole batch.
      halos: per-stage receptive-field radius, in that stage's input
        pixels.
      downs: per-stage integer output downscale factor.
    """

    stages: Tuple[Tuple[str, Tuple], ...]
    engine: Any
    requant: str
    chain: Callable = dataclasses.field(compare=False)
    halos: Tuple[int, ...] = ()
    downs: Tuple[int, ...] = ()

    def __call__(self, imgs) -> torch.Tensor:
        return self.chain(self.engine.tensor(imgs))

    @property
    def stage_names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.stages)

    @property
    def total_down(self) -> int:
        """The chain's overall integer downscale factor per axis."""
        d = 1
        for di in self.downs:
            d *= di
        return d

    @property
    def receptive_halo(self) -> int:
        """The chain's receptive-field radius in INPUT pixels: stage
        halos scaled by the downsampling accumulated before them."""
        h, scale = 0, 1
        for hi, di in zip(self.halos, self.downs):
            h += hi * scale
            scale *= di
        return h

    def out_size(self, in_size: int) -> int:
        """Output extent along one spatial axis for ``in_size`` input
        pixels (filters preserve extent; each 2x stage floors)."""
        for d in self.downs:
            in_size //= d
        return in_size


def _stage_chain(stages, ax) -> Callable:
    """requant="stage": the standalone operators back to back."""

    def chain(img):
        x = img
        for name, kw_items in stages:
            x = ops_lib.get_operator(name).fn(x, ax, **dict(kw_items))
        return x

    return chain


def _fused_chain(stages, ax) -> Callable:
    """requant="fused": chain the operators' raw Q-forms in the int32
    fixed-point domain.  One exact quantize at entry (``uint8 << frac``);
    at each seam a rounding shift to whole gray levels, a clamp, and an
    exact shift into the next stage's scale; one round/clip at exit."""
    qforms = [ops_lib.get_operator(name).qform for name, _ in stages]

    def chain(img):
        q = ax.tensor(img).to(torch.int32) << qforms[0].in_frac
        for i, ((name, kw_items), qf) in enumerate(zip(stages, qforms)):
            q = qf.fn(q, ax, **dict(kw_items))
            f = qf.out_frac
            if i + 1 < len(qforms):
                if f:
                    q = (q + (1 << (f - 1))) >> f
                q = torch.clamp(q, 0, 255) << qforms[i + 1].in_frac
        return ops_lib._finish_q(q, f)

    return chain


@functools.lru_cache(maxsize=None)
def _compile_cached(stages, kind, backend_name, strategy, n_bits,
                    requant, device) -> CompiledPipeline:
    ax = ops_lib.make_image_engine(kind, backend=backend_name,
                                   strategy=strategy, n_bits=n_bits,
                                   device=device)
    qforms = [ops_lib.get_operator(name).qform for name, _ in stages]
    if requant == "fused":
        missing = [name for (name, _), qf in zip(stages, qforms)
                   if qf is None]
        if missing:
            raise ValueError(
                f"requant='fused' chains raw Q-forms, but {missing} "
                f"registered no QForm; use requant='stage'")
        chain = _fused_chain(stages, ax)
    else:
        chain = _stage_chain(stages, ax)
    geom = all(qf is not None for qf in qforms)
    return CompiledPipeline(
        stages=stages, engine=ax, requant=requant, chain=chain,
        halos=tuple(qf.halo for qf in qforms) if geom else (),
        downs=tuple(qf.down for qf in qforms) if geom else ())


def compile_pipeline(stages: Sequence[StageSpec],
                     kind="haloc_axa",
                     backend: Optional[str] = None,
                     fast: bool = False,
                     strategy: Optional[str] = None,
                     n_bits: int = ops_lib.IMAGE_N_BITS,
                     requant: str = "stage",
                     device=None,
                     fault=None) -> CompiledPipeline:
    """Compile ``stages`` (operator names, or (name, kwargs) pairs) into
    one callable over a batch of uint8 images, on the card unless
    ``backend``/``device`` say otherwise.

    The result is cached by (stages, kind, backend, strategy, n_bits,
    requant, device).  ``kind`` is a registered kind name or a full
    :class:`~repro_torch.core.specs.AdderSpec`."""
    strategy = resolve_strategy(strategy, fast)
    check_requant(requant)
    ax = ops_lib.make_image_engine(kind, backend=backend, strategy=strategy,
                                   n_bits=n_bits, device=device,
                                   fault=fault)
    return _compile_cached(_norm_stages(stages), kind, ax.backend.name,
                           ax.strategy, ax.spec.n_bits, requant, ax.device)


def run_pipeline(stages: Sequence[StageSpec], imgs, *,
                 kind="haloc_axa", backend: Optional[str] = None,
                 fast: bool = False, strategy: Optional[str] = None,
                 requant: str = "stage", device=None) -> np.ndarray:
    """One-shot convenience: compile (or fetch) the plan, run it, and
    return a host uint8 array."""
    pipe = compile_pipeline(stages, kind=kind, backend=backend, fast=fast,
                            strategy=strategy, requant=requant,
                            device=device)
    return pipe(imgs).cpu().numpy()


class GateResult(NamedTuple):
    """One :func:`fused_psnr_gate` measurement (PSNRs clamped at 99 dB so
    a lossless cell compares as 99.0, not inf)."""

    psnr_stage: float
    psnr_fused: float
    bit_identical: bool

    @property
    def delta_db(self) -> float:
        return self.psnr_fused - self.psnr_stage

    def admissible(self, bound_db: float = 0.1) -> bool:
        return abs(self.delta_db) <= bound_db


def fused_psnr_gate(stages: Sequence[StageSpec], imgs, *,
                    kind: str = "haloc_axa",
                    backend: Optional[str] = None,
                    strategy: Optional[str] = None,
                    tile: Optional[Tuple[int, int]] = None,
                    device=None) -> GateResult:
    """The quality gate on the fused-requant path: both requant modes
    scored against the ideal float reference on ``imgs``.  The fused side
    runs tiled when ``tile`` is given."""
    from repro_torch.image.quality import psnr
    imgs = np.asarray(imgs)
    ref = imgs.astype(np.float64)
    for name, kw_items in _norm_stages(stages):
        ref = ops_lib.get_operator(name).reference(ref, **dict(kw_items))

    def score(got):
        return float(np.mean([min(psnr(r, o), 99.0)
                              for r, o in zip(ref, got)]))

    kw = dict(kind=kind, backend=backend, strategy=strategy, device=device)
    out_stage = run_pipeline(stages, imgs, requant="stage", **kw)
    if tile is None:
        out_fused = run_pipeline(stages, imgs, requant="fused", **kw)
    else:
        from repro_torch.imgproc.tiles import run_tiled
        out_fused = run_tiled(
            compile_pipeline(stages, requant="fused", **kw), imgs, tile=tile)
    return GateResult(psnr_stage=score(out_stage),
                      psnr_fused=score(out_fused),
                      bit_identical=bool(np.array_equal(out_stage,
                                                        out_fused)))
