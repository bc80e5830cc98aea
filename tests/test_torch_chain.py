"""The port's filter chain against the reference's ``"jax"`` (per-stage)
and ``"pallas"`` (interpret) chains, bit for bit, on edge shapes: planes
of 1x1, 1xN, Nx1, 2x2 and 3x5, ragged sizes, sobel's mixed axes and
(1, -1) offsets, and chains with several stages on one axis.

The CUDA chain kernel runs only on the card; a Python model of its
tiling is held against the plain chain here, so the tiling that keeps
the reference's per-stage replicate edges is checked on the CPU, on both
of the kernel's routes: "general" (regions walked backwards from each
output tile, widened by each stage's tap reach and clipped to the image,
taps clamped to the image per stage) and "sep2" (two stages, one per
axis: the tile plus a one-pixel frame loaded as it is inside the image
and with clamped coordinates on its border, no clamp after the load).
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


def _finish_stage(taps, spec, st):
    """Fold the stacked taps of one stage, sign-extend, round."""
    mask, sign = (1 << spec.n_bits) - 1, 1 << (spec.n_bits - 1)
    acc = acc_k.accumulate_plain(torch.stack(taps) & mask, spec, st.weights)
    acc = (acc ^ sign) - sign
    if st.shift:
        acc = (acc + (1 << (st.shift - 1))) >> st.shift
    return acc


def _tiled_chain_model(q, spec, stages, tile, route="general", stats=None):
    """The CUDA chain kernel's algorithm in Python, per output tile.

    "general": walk the stages backwards to the region each must produce
    (widened by its tap reach, clipped to the image), load the first
    region, run every stage on its region with taps clamped to the image,
    keep the tile.

    "sep2" (two stages on different axes, offsets in [-1, 1]): load the
    tile plus a one-pixel frame: an interior tile (frame inside the image)
    as it is, a border tile at clamped (replicate) coordinates; run stage
    0 over the rows (horizontal first) or columns (vertical first) that
    stage 1 reads, then stage 1 over the tile, with no clamp after the
    load; keep the part of the tile inside the image.  ``stats`` counts
    the interior and border tiles."""
    stages = chain_k.norm_stages(stages, q.ndim)
    h, w = q.shape[-2:]
    out = torch.empty_like(q)
    for ty in range(0, h, tile[0]):
        for tx in range(0, w, tile[1]):
            if route == "sep2":
                out[..., ty:ty + tile[0], tx:tx + tile[1]] = _sep2_tile(
                    q, spec, stages, tile, ty, tx, stats)
                continue
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
                cur = _finish_stage(taps, spec, st)
            out[..., regs[-1][0]:regs[-1][1], regs[-1][2]:regs[-1][3]] = cur
    return out


def _sep2_tile(q, spec, stages, tile, ty, tx, stats):
    h, w = q.shape[-2:]
    th, tw = tile
    if ty >= 1 and tx >= 1 and ty + th + 1 <= h and tx + tw + 1 <= w:
        frame = q[..., ty - 1:ty + th + 1, tx - 1:tx + tw + 1]
        kind = "interior"
    else:
        ys = torch.arange(ty - 1, ty + th + 1).clamp(0, h - 1)
        xs = torch.arange(tx - 1, tx + tw + 1).clamp(0, w - 1)
        frame = q[..., ys, :][..., xs]
        kind = "border"
    if stats is not None:
        stats[kind] = stats.get(kind, 0) + 1
    # frame[r, c] is pixel (ty - 1 + r, tx - 1 + c).
    first, second = stages
    if first.axis == -1:  # stage 0 on rows ty-1..ty+th, the tile's columns
        mid = _finish_stage([frame[..., :, 1 + o:1 + o + tw]
                             for o in first.offsets], spec, first)
        res = _finish_stage([mid[..., 1 + o:1 + o + th, :]
                             for o in second.offsets], spec, second)
    else:  # stage 0 on the tile's rows, columns tx-1..tx+tw
        mid = _finish_stage([frame[..., 1 + o:1 + o + th, :]
                             for o in first.offsets], spec, first)
        res = _finish_stage([mid[..., :, 1 + o:1 + o + tw]
                             for o in second.offsets], spec, second)
    return res[..., :min(th, h - ty), :min(tw, w - tx)]


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


def test_chain_route():
    """The operators' chains take the sep2 route; three stages, two on
    one axis, or wide taps take the general one."""
    routes = {name: chain_k.chain_route(chain_k.norm_stages(st, 2))
              for name, st in CHAINS.items()}
    assert routes == {"box": "sep2", "gauss": "sep2", "sobel_gx": "sep2",
                      "sobel_gy": "sep2", "same_axis": "general",
                      "wide": "general"}
    two_on_w = (FS_T(-1, (-1, 0, 1), (1, 2, 1)), FS_T(-1, (-1, 1), (1, 1)))
    reach_2 = (FS_T(-1, (-2, 0, 2), (1, 2, 1)), FS_T(-2, (-1, 0), (1, 1)))
    four_taps = (FS_T(-1, (-1, 0, 1, 1), (1, 1, 1, 1)),
                 FS_T(-2, (0,), (1,)))
    one_stage = (FS_T(-1, (-1, 0, 1), (1, 2, 1)),)
    for stages in (two_on_w, reach_2, four_taps, one_stage):
        assert chain_k.chain_route(chain_k.norm_stages(stages, 2)) == \
            "general"


@pytest.mark.parametrize("chain", ["box", "gauss", "sobel_gx", "sobel_gy"])
def test_sep2_chain_model_equals_plain_chain(chain):
    """The sep2 route's model, at the kernel's 32 x 128 tile and at small
    tiles, on planes with interior and border tiles and W not a multiple
    of 4, equals the plain chain in both forms."""
    rng = np.random.default_rng(6)
    st = specs_t.AdderSpec("haloc_axa", 16, 8, 4)
    assert chain_k.SEP2_TILE == (32, 128)
    cases = [(shape, ((2, 3), (1, 1), (4, 4))) for shape in SHAPES] + [
        ((1, 9, 10), ((2, 3), (3, 2))), ((2, 37, 70), ((4, 8), (5, 7))),
        ((1, 100, 390), (chain_k.SEP2_TILE,)),
        ((1, 66, 258), (chain_k.SEP2_TILE, (32, 64)))]
    interior = 0
    for shape, tiles in cases:
        q = torch.as_tensor(_signed(rng, shape, 16, 1500))
        for fast in (False, True):
            want = chain_k.filter_chain_plain(q, st, CHAINS[chain], fast)
            for tile in tiles:
                stats = {}
                got = _tiled_chain_model(q, st, CHAINS[chain], tile,
                                         route="sep2", stats=stats)
                assert torch.equal(got, want), (shape, tile, fast)
                interior += stats.get("interior", 0)
    assert interior > 0
