"""The port's MAC convolution kernel, ``kernels/conv2d_mac``, in a Python
model of its tiling, against the plain version and the reference.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).  Here its algorithm runs in Python, tile by tile: the
input tile with the kernel's halo rows and :func:`frame_cols` columns on
each side, taken as it is inside the image and at clamped (replicate)
coordinates on its border; each value turned into its row of
:func:`signed_tap_tables`, ``(v + 2^w) * T``; each tap one gather at that
row plus t, folded left to right through the adder; the sign extension
and the int32 rounding; the part of the tile inside the image kept.  The
model is held against ``conv2d_mac_plain`` (which
``tests/test_torch_mac.py`` holds against the reference's backends) at
the kernel's tile and at small tiles, on planes with interior and border
tiles, and the tables and :func:`conv_route` are checked at their edges.
"""

import numpy as np
import pytest
import torch

from repro.ax.backends import get_backend as get_backend_j
from repro.ax.mul import MulSpec as MulSpec_j
from repro.core import specs as specs_j
from repro_torch.ax.backends import check_conv_kernel
from repro_torch.ax.mul import MulSpec, tap_tables
from repro_torch.core import specs as specs_t
from repro_torch.core.adders import approx_add_mod
from repro_torch.kernels import conv2d_mac as conv_k
from repro_torch.kernels.approx_add import signed32, u32_lanes

K3 = ((1, 3, 1), (3, -5, 3), (1, 3, 1))


def _conv_tile_model(q, spec, mul_spec, kernel, shift, tile, fast=False,
                     stats=None):
    """``conv2d_mac_kernel`` in Python, per output tile of ``tile`` (rows,
    columns); ``stats`` counts the interior and border tiles."""
    kh, kw, weights = check_conv_kernel(kernel)
    taps, entries = kh * kw, 1 << mul_spec.n_bits
    tabs = u32_lanes(conv_k.signed_tap_tables(mul_spec, weights,
                                              spec.n_bits, "cpu").reshape(-1))
    cy, cx, xl = kh // 2, kw // 2, conv_k.frame_cols(kw)
    th, tw = tile
    rows, sw = th + kh - 1, tw + 2 * xl
    h, w = q.shape[-2:]
    sign = 1 << (spec.n_bits - 1)
    out = torch.empty_like(q)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            gy0, gx0 = y0 - cy, x0 - xl
            if gy0 >= 0 and gy0 + rows <= h and gx0 >= 0 and gx0 + sw <= w:
                part, where = q[..., gy0:gy0 + rows, gx0:gx0 + sw], "interior"
            else:
                ys = torch.arange(gy0, gy0 + rows).clamp(0, h - 1)
                xs = torch.arange(gx0, gx0 + sw).clamp(0, w - 1)
                part, where = q[..., ys, :][..., xs], "border"
            if stats is not None:
                stats[where] = stats.get(where, 0) + 1
            idx = part.to(torch.int64) * taps + entries * taps
            acc = None
            for dy in range(kh):
                for dx in range(kw):
                    c0 = xl - cx + dx
                    u = tabs[idx[..., dy:dy + th, c0:c0 + tw]
                             + dy * kw + dx]
                    acc = u if acc is None else approx_add_mod(
                        acc, u, spec, fast=fast)
            s = signed32(((acc ^ sign) - sign) + (1 << shift >> 1)) >> shift
            out[..., y0:y0 + th, x0:x0 + tw] = \
                s[..., :min(th, h - y0), :min(tw, w - x0)].to(torch.int32)
    return out


def _kernel(rng, kh, kw, lim=9):
    return tuple(tuple(int(x) for x in row)
                 for row in rng.integers(-lim, lim + 1, (kh, kw)))


@pytest.mark.parametrize("kind", specs_t.ALL_KINDS)
def test_tile_model_equals_plain_conv(kind):
    """At the kernel's 64 x 32 tile (planes with interior tiles, W % 4 !=
    0) and at small tiles, 3 x 3, 5 x 5, 1 x 1, 3 x 5 and 7 x 7 kernels,
    w = 8 and 10, n16 (both forms) and n32, shift 0 and 3."""
    rng = np.random.default_rng(50 + len(kind))
    assert conv_k.TILE == (64, 32)
    cases = [(MulSpec("truncated", 8, 3), K3),
             (MulSpec("truncated", 8, 3), _kernel(rng, 5, 5)),
             (MulSpec("mitchell", 10), _kernel(rng, 3, 5, 30)),
             (MulSpec("broken_array", 8, 3, 1), ((7,),)),
             (MulSpec("mitchell", 10), _kernel(rng, 7, 7))]
    interior = 0
    for n_bits, m, k in ((16, 8, 4), (32, 10, 5)):
        spec = specs_t.AdderSpec(kind, n_bits, m, k)
        for ms, kernel in cases:
            lim = (1 << ms.n_bits) - 1
            for shape, tiles in (((1, 131, 69), (conv_k.TILE,)),
                                 ((2, 13, 17), ((5, 8),)),
                                 ((1, 1), ((4, 8),)), ((9, 2), ((2, 4),))):
                q = torch.as_tensor(rng.integers(-lim, lim + 1, shape)
                                    .astype(np.int32))
                for shift in (0, 3):
                    for fast in ((False, True) if n_bits == 16 else (False,)):
                        want = conv_k.conv2d_mac_plain(q, spec, ms, kernel,
                                                       shift, fast)
                        for tile in tiles:
                            stats = {}
                            got = _conv_tile_model(q, spec, ms, kernel,
                                                   shift, tile, fast, stats)
                            assert torch.equal(got, want), (ms, shape, tile)
                            interior += stats.get("interior", 0)
    assert interior > 0


def test_tile_model_equals_reference_on_the_workload_kernel():
    """The conv3x3 workload's kernel and multiplier at the kernel's tile
    equal the reference's numpy backend on an 8-bit image."""
    from repro.imgproc.workloads import CONV3X3_KERNEL
    rng = np.random.default_rng(51)
    q = rng.integers(0, 256, (2, 130, 70)).astype(np.int32)
    for kind in specs_j.TABLE1_KINDS:
        want = np.asarray(get_backend_j("numpy").conv2d(
            q, specs_j.AdderSpec(kind, 16, 8, 4), MulSpec_j("truncated", 8, 3),
            CONV3X3_KERNEL))
        got = _conv_tile_model(torch.as_tensor(q),
                               specs_t.AdderSpec(kind, 16, 8, 4),
                               MulSpec("truncated", 8, 3), CONV3X3_KERNEL, 0,
                               conv_k.TILE)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=kind)


@pytest.mark.parametrize("n_bits", [16, 32])
def test_signed_tap_tables(n_bits):
    """Row v + 2^w, column t: (sign(v) * tap_tables[t][|v|]) & ones(N);
    row 0 (v = -2^w) is 0; cached per device."""
    ms = MulSpec("mitchell", 8)
    weights = (3, -7, 0, 1, -128)
    got = conv_k.signed_tap_tables(ms, weights, n_bits, "cpu")
    assert got.shape == (512, len(weights)) and got.dtype == torch.int32
    assert got.is_contiguous()
    tab = tap_tables(ms, weights).astype(np.int64)
    v = np.arange(-255, 256)
    want = np.where(v < 0, -tab[:, np.abs(v)], tab[:, np.abs(v)]).T \
        & ((1 << n_bits) - 1)
    np.testing.assert_array_equal(u32_lanes(got[1:]).numpy(), want)
    assert not got[0].any()
    assert conv_k.signed_tap_tables(ms, list(weights), n_bits, "cpu") is got


@pytest.mark.parametrize("kh,kw,entries,route", [
    (3, 3, 256, (3, "shared")), (5, 5, 256, (5, "shared")),
    (5, 5, 1024, (5, "shared")), (5, 5, 2048, (0, "global")),
    (3, 3, 2048, (3, "shared")), (3, 3, 4096, (0, "global")),
    (1, 1, 256, (0, "shared")), (3, 5, 256, (0, "shared")),
    (7, 7, 256, (0, "shared")), (7, 7, 1024, (0, "global")),
    (9, 9, 2, (0, "shared"))])
def test_conv_route(kh, kw, entries, route):
    """The 3 x 3 and 5 x 5 instances stage their tables; other sizes take
    the general instance; tables past what a block may have beside its
    tile go to global memory (5 x 5 at w = 10 is 200 KiB and stays; at
    w = 11, 400 KiB, does not)."""
    assert conv_k.conv_route(kh, kw, entries) == route
    staged = conv_k.tile_bytes(kh, kw) + 8 * entries * kh * kw
    assert (staged <= conv_k.MAX_SMEM) == (route[1] == "shared")


def test_tile_bytes_and_frame():
    assert [conv_k.frame_cols(kw) for kw in (1, 3, 5, 7, 9, 11)] == \
        [0, 4, 4, 4, 4, 8]
    assert conv_k.tile_bytes(3, 3) == 4 * 66 * 40
    assert conv_k.tile_bytes(5, 5) + 8 * 1024 * 25 <= conv_k.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        conv_k.conv_route(1801, 1, 256)
