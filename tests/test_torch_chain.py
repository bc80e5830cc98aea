"""The port's filter chain against the reference's ``"jax"`` (per-stage)
and ``"pallas"`` (interpret) chains, bit for bit, on edge shapes: planes
of 1x1, 1xN, Nx1, 2x2 and 3x5, ragged sizes, sobel's mixed axes and
(1, -1) offsets, and chains with several stages on one axis.

The CUDA chain kernel runs only on the card; a Python model of its
tiling (regions walked backwards from each output tile, widened by each
stage's tap reach and clipped to the image, taps clamped to the image
per stage) is held against the plain chain here, so the tiling that
keeps the reference's per-stage replicate edges is checked on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.ax import backends as be_j
from repro.core import specs as specs_j
from repro_torch.ax import backends as be_t
from repro_torch.core import specs as specs_t
from repro_torch.kernels import accumulate as acc_k
from repro_torch.kernels import conv_chain as chain_k

FS_J, FS_T = be_j.FilterStage, be_t.FilterStage


def _specs(kind, n_bits, m, k):
    return (specs_j.AdderSpec(kind, n_bits, m, k),
            specs_t.AdderSpec(kind, n_bits, m, k))


CHAINS = {
    "box": (FS_T(-1, (-1, 0, 1), (1, 1, 1)), FS_T(-2, (-1, 0, 1), (1, 1, 1))),
    "gauss": (FS_T(-1, (-1, 0, 1), (1, 2, 1), 2),
              FS_T(-2, (-1, 0, 1), (1, 2, 1), 2)),
    "sobel_gx": (FS_T(-2, (-1, 0, 1), (1, 2, 1)), FS_T(-1, (1, -1), (1, -1))),
    "sobel_gy": (FS_T(-1, (-1, 0, 1), (1, 2, 1)), FS_T(-2, (1, -1), (1, -1))),
    "same_axis": (FS_T(-1, (-2, 0, 3), (1, -3, 2), 1),
                  FS_T(-1, (-1, 1), (2, 1)),
                  FS_T(-2, (0, 2), (1, 1), 1)),
    "wide": (FS_T(-2, (-4, -3, -2, -1, 0, 1, 2, 3, 4),
                  (1, 2, 3, 4, 5, 4, 3, 2, 1), 3),),
}
SHAPES = [(1, 1), (1, 7), (7, 1), (2, 2), (3, 5), (2, 3, 4), (2, 37, 70)]


def _chain_j(stages):
    return tuple(FS_J(s.axis, s.offsets, s.weights, s.shift) for s in stages)


def _signed(rng, shape, n_bits, lim):
    return rng.integers(-lim, lim, shape).astype(np.int32)


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_filter_chain_matches_jax(chain):
    rng = np.random.default_rng(len(chain))
    stages = CHAINS[chain]
    for kind in ("haloc_axa", "loa", "accurate"):
        sj, st = _specs(kind, 16, 8, 4)
        for shape in SHAPES:
            q = _signed(rng, shape, 16, 1500)
            want = np.asarray(be_j.get_backend("jax").filter_chain(
                jnp.asarray(q), sj, _chain_j(stages), strategy="reference"))
            got = be_t.get_backend("torch").filter_chain(
                torch.as_tensor(q), st, stages, strategy="reference")
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{kind} {shape}")
            plain = chain_k.filter_chain(torch.as_tensor(q), st, stages,
                                         fast=True)
            np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("chain", ["sobel_gx", "same_axis", "gauss"])
def test_filter_chain_matches_pallas(chain):
    rng = np.random.default_rng(3)
    stages = CHAINS[chain]
    sj, st = _specs("haloc_axa", 16, 8, 4)
    for shape in [(1, 1), (2, 3), (3, 5), (2, 9, 13)]:
        q = _signed(rng, shape, 16, 1500)
        want = np.asarray(be_j.get_backend("pallas").filter_chain(
            jnp.asarray(q), sj, _chain_j(stages), strategy="fused"))
        got = chain_k.filter_chain(torch.as_tensor(q), st, stages, fast=True)
        np.testing.assert_array_equal(got.numpy(), want)


def _tiled_chain_model(q, spec, stages, tile):
    """The CUDA chain kernel's algorithm in Python: per output tile, walk
    the stages backwards to the region each must produce (widened by its
    tap reach, clipped to the image), load the first region, run every
    stage on its region with taps clamped to the image, keep the tile."""
    stages = chain_k.norm_stages(stages, q.ndim)
    h, w = q.shape[-2:]
    mask, sign = (1 << spec.n_bits) - 1, 1 << (spec.n_bits - 1)
    out = torch.empty_like(q)
    for ty in range(0, h, tile[0]):
        for tx in range(0, w, tile[1]):
            r = [ty, min(ty + tile[0], h), tx, min(tx + tile[1], w)]
            regs = [list(r)]
            for st in reversed(stages):
                lo = max(-min(st.offsets), 0)
                hi = max(max(st.offsets), 0)
                if st.axis == -1:
                    r[2], r[3] = max(r[2] - lo, 0), min(r[3] + hi, w)
                else:
                    r[0], r[1] = max(r[0] - lo, 0), min(r[1] + hi, h)
                regs.insert(0, list(r))
            y0, y1, x0, x1 = regs[0]
            cur = q[..., y0:y1, x0:x1]
            for s, st in enumerate(stages):
                ri, ro = regs[s], regs[s + 1]
                ys = torch.arange(ro[0], ro[1])
                xs = torch.arange(ro[2], ro[3])
                taps = []
                for o in st.offsets:
                    if st.axis == -1:
                        sx = (xs + o).clamp(0, w - 1) - ri[2]
                        v = cur[..., ys - ri[0], :][..., sx]
                    else:
                        sy = (ys + o).clamp(0, h - 1) - ri[0]
                        v = cur[..., sy, :][..., xs - ri[2]]
                    taps.append(v)
                acc = acc_k.accumulate_plain(torch.stack(taps) & mask, spec,
                                             st.weights)
                acc = (acc ^ sign) - sign
                if st.shift:
                    acc = (acc + (1 << (st.shift - 1))) >> st.shift
                cur = acc
            out[..., regs[-1][0]:regs[-1][1], regs[-1][2]:regs[-1][3]] = cur
    return out


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_tiled_chain_model_equals_plain_chain(chain):
    rng = np.random.default_rng(5)
    st = specs_t.AdderSpec("haloc_axa", 16, 8, 4)
    for shape in SHAPES + [(1, 9, 10)]:
        q = torch.as_tensor(_signed(rng, shape, 16, 1500))
        want = chain_k.filter_chain_plain(q, st, CHAINS[chain])
        tiles = ((2, 3), (1, 1), (4, 4)) if q.numel() < 200 else \
            ((8, 16), (5, 7))
        for tile in tiles:
            got = _tiled_chain_model(q, st, CHAINS[chain], tile)
            assert torch.equal(got, want), (shape, tile)
