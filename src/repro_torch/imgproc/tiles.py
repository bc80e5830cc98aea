"""Halo-aware tile streaming (the port of ``repro.imgproc.tiles``): run
any compiled plan over megapixel images region by region, bit-identical
to untiled execution.

The reference sweeps the tile grid with a ``lax.scan``; here it is a
Python loop over the same static grid that writes each region's valid
core into one preallocated output.  Bit-identity is by construction:

- every input region is expanded past its output tile by the chain's
  receptive-field halo, so replicate padding at an INTERIOR region edge
  only pollutes rows/columns that are cropped away;
- a region edge that would cross the image boundary is clamped to land
  EXACTLY on it, so the stage's own replicate padding there is the
  image's;
- with a downsampling chain every region start is aligned to the
  chain's total downscale factor.

    pipe = compile_pipeline(("gaussian_blur", "sharpen", "downsample2x"),
                            kind="haloc_axa", requant="fused")
    out = run_tiled(pipe, batch, tile=(256, 256))

With telemetry on, a call records a ``tiles:dispatch`` span around one
``tiles:tile`` span a region and counts ``tiles.dispatches`` and
``tiles.tiles_dispatched``; the executor's ``raw`` attribute is the
same loop with no hook at all, the baseline the overhead check times.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.imgproc.plan import CompiledPipeline, compile_pipeline
from repro_torch.obs import drift as _drift
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _obs
from repro_torch.obs.caches import register_lru as _register_lru


@dataclasses.dataclass(frozen=True)
class AxisTiles:
    """Static tile geometry along one image axis.

    ``starts[i]``/``size`` locate the i-th input region; ``outs[i]`` is
    where its output tile lands in final-output coordinates and
    ``offs[i]`` where that tile begins inside the region's chain output;
    ``tile_out`` is the uniform output-tile extent.
    """

    starts: Tuple[int, ...]
    outs: Tuple[int, ...]
    offs: Tuple[int, ...]
    size: int
    tile_out: int


def _axis_tiles(in_size: int, out_size: int, tile: int, halo: int,
                down: int) -> AxisTiles:
    """Plan one axis: uniform regions of ``tile + 2 * halo`` input
    pixels (aligned to ``down``), output tiles of ``tile // down``."""
    if tile < 1:
        raise ValueError(f"tile extent must be >= 1; got {tile}")
    tile_in = max(down, tile // down * down)
    pad = -(-halo // down) * down
    size = tile_in + 2 * pad
    tile_out = tile_in // down
    if size >= in_size or tile_out >= out_size:
        # One region spans the whole axis: both edges are image edges.
        return AxisTiles((0,), (0,), (0,), in_size, out_size)
    n = -(-out_size // tile_out)
    starts, outs, offs = [], [], []
    for i in range(n):
        t0 = min(i * tile_out, out_size - tile_out)
        start = min(max(t0 * down - pad, 0), in_size - size)
        starts.append(start)
        outs.append(t0)
        offs.append(t0 - start // down)
    return AxisTiles(tuple(starts), tuple(outs), tuple(offs), size,
                     tile_out)


def _plan_geometry(pipe: CompiledPipeline, shape: Tuple[int, ...],
                   tile: Tuple[int, int], halo: Optional[int]):
    """Resolve and validate the 2D tile grid for ``shape`` images."""
    if not pipe.halos and pipe.stages:
        raise ValueError(
            f"pipeline {pipe.stage_names} has stages without a QForm, "
            f"so its receptive field is unknown; tiling needs every "
            f"operator to declare halo/down geometry")
    if len(shape) < 2:
        raise ValueError(f"run_tiled needs (..., H, W) images; "
                         f"got shape {shape}")
    h, w = shape[-2:]
    down = pipe.total_down
    if down > 1 and (h % down or w % down):
        raise ValueError(
            f"tiled execution of a {down}x-downsampling chain needs "
            f"image extents divisible by {down} (phase alignment of "
            f"the 2x grids); got {h}x{w} — crop the input first")
    min_halo = pipe.receptive_halo
    if halo is None:
        halo = min_halo
    elif halo < min_halo:
        raise ValueError(
            f"halo={halo} is narrower than the chain's receptive "
            f"field radius {min_halo}; tiles would read polluted "
            f"replicate-padding rims")
    rows = _axis_tiles(h, pipe.out_size(h), int(tile[0]), halo, down)
    cols = _axis_tiles(w, pipe.out_size(w), int(tile[1]), halo, down)
    return rows, cols


@functools.lru_cache(maxsize=None)
def _compile_tiled_cached(pipe: CompiledPipeline, shape: Tuple[int, ...],
                          tile: Tuple[int, int], halo: Optional[int]):
    rows, cols = _plan_geometry(pipe, shape, tile, halo)
    grid = [(rs, ro, rf, cs, co, cf)
            for rs, ro, rf in zip(rows.starts, rows.outs, rows.offs)
            for cs, co, cf in zip(cols.starts, cols.outs, cols.offs)]
    out_hw = (pipe.out_size(shape[-2]), pipe.out_size(shape[-1]))

    def prepare(imgs):
        imgs = pipe.engine.tensor(imgs)
        if tuple(imgs.shape) != shape:
            raise ValueError(f"this tiled executor was compiled for shape "
                             f"{shape}; got {tuple(imgs.shape)}")
        return imgs, torch.empty(imgs.shape[:-2] + out_hw,
                                 dtype=torch.uint8, device=imgs.device)

    def raw(imgs) -> torch.Tensor:
        imgs, out = prepare(imgs)
        for rs, ro, rf, cs, co, cf in grid:
            y = pipe.chain(imgs[..., rs:rs + rows.size, cs:cs + cols.size])
            out[..., ro:ro + rows.tile_out, co:co + cols.tile_out] = \
                y[..., rf:rf + rows.tile_out, cf:cf + cols.tile_out]
        return out

    def traced(imgs) -> torch.Tensor:
        # Host-side spans: they measure enqueue time, never force a sync
        # (that would serialize the streaming runner's overlap).
        imgs, out = prepare(imgs)
        with _obs.span("tiles:dispatch", tiles=len(grid), shape=shape):
            for rs, ro, rf, cs, co, cf in grid:
                with _obs.span("tiles:tile", row=ro, col=co):
                    y = pipe.chain(imgs[..., rs:rs + rows.size,
                                        cs:cs + cols.size])
                out[..., ro:ro + rows.tile_out, co:co + cols.tile_out] = \
                    y[..., rf:rf + rows.tile_out, cf:cf + cols.tile_out]
        _metrics.counter("tiles.dispatches").inc()
        _metrics.counter("tiles.tiles_dispatched").inc(len(grid))
        return out

    cuda = pipe.engine.backend.name == "cuda"

    def run(imgs) -> torch.Tensor:
        # One branch a call when telemetry is off; ``run.raw`` is the
        # hook-free loop itself.
        if not _obs._ENABLED:
            return raw(imgs)
        if cuda:
            with _drift.suppressed():
                return traced(imgs)
        return traced(imgs)

    run.raw = raw
    run.device = pipe.engine.device
    return run


_register_lru("imgproc.tiles.compiled", _compile_tiled_cached)


def compile_tiled(pipe: CompiledPipeline, shape: Sequence[int],
                  tile: Tuple[int, int] = (512, 512),
                  halo: Optional[int] = None):
    """The cached tiled executor for ``pipe`` on ``shape``-shaped
    batches: ``uint8 (..., H, W) -> uint8`` tensor on the engine's
    device (on the card the launches are asynchronous: the streaming
    runner overlaps them with the host).  ``tile`` is the output-tile
    extent in INPUT pixels; ``halo`` overrides the per-side region
    overlap (default: the chain's receptive-field radius; wider is valid
    and recomputes more)."""
    return _compile_tiled_cached(pipe, tuple(shape), tuple(tile), halo)


def run_tiled(pipe, imgs, tile: Tuple[int, int] = (512, 512),
              halo: Optional[int] = None, **pipeline_kw) -> np.ndarray:
    """One-shot tiled execution, host array out.  ``pipe`` is a
    :class:`CompiledPipeline` or a stage sequence compiled on the fly
    (``pipeline_kw`` forwarded to :func:`compile_pipeline`)."""
    if not isinstance(pipe, CompiledPipeline):
        pipe = compile_pipeline(pipe, **pipeline_kw)
    elif pipeline_kw:
        raise ValueError(f"pipeline_kw {sorted(pipeline_kw)} only apply "
                         f"when compiling from stages")
    fn = compile_tiled(pipe, tuple(np.shape(imgs)), tile, halo)
    return fn(imgs).cpu().numpy()
