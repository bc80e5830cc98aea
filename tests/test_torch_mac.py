"""The port's MAC datapaths against the reference's, bit for bit:
``engine.conv2d``, both ``engine.matmul`` paths and the ``conv3x3``
workload (``kernels/conv2d_mac``, ``kernels/mac_matmul`` and
``kernels/approx_matmul``, plain versions, on the CPU).

- ``conv2d`` on ``tests/test_mul.py``'s signed (3, 17, 29) input with its
  negative-weight kernel, shift 2, equals the reference's ``numpy``,
  ``jax`` and ``pallas`` backends in the reference and fused forms, and
  ``jax``'s lut; an input with ``|q| >= 2^w`` raises ``ValueError`` with
  the ``numpy`` backend's message;
- the MAC ``matmul`` on the ragged (16, 300) @ (300, 24) at n32 and n16,
  and on a single K tile, equals all three reference backends;
- the exact-product ``matmul`` equals ``pallas``/``jax`` at n32 and n16;
  below N = 32 the reference's ``numpy`` oracle disagrees with them (it
  keeps the carry-out), and the port follows ``jax``/``pallas``;
- the ``conv3x3`` workload equals the reference's for the seven Table-1
  kinds, and an exact adder with an exact multiplier reproduces its
  golden.

Inputs are made with numpy from a seed and given to both packages.  The
CUDA kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.ax.backends import get_backend as get_backend_j
from repro.ax.mul import MulSpec as MulSpec_j
from repro.core import specs as specs_j
from repro.imgproc.workloads import get_workload as get_workload_j
from repro.kernels.ref import ref_approx_matmul
from repro_torch.ax import backends as be_t
from repro_torch.ax import make_engine
from repro_torch.ax.mul import MulSpec, signed_mul_table
from repro_torch.core import specs as specs_t
from repro_torch.imgproc import get_workload, synthetic_batch
from repro_torch.kernels import approx_add as add_k
from repro_torch.kernels import approx_matmul as mm_k
from repro_torch.kernels import conv2d_mac as conv_k
from repro_torch.kernels import mac_matmul as mac_k
from repro_torch.numerics.fixed_point import FixedPointFormat

CPU = dict(backend="torch", device="cpu")
KERNEL = ((1, 3, 1), (3, -5, 3), (1, 3, 1))
TORCH = be_t.get_backend("torch")
#: The two adder widths of the MAC paths: the paper's n32m10k5 and the
#: image datapath's n16m8k4.
WIDTHS = {"n32": (32, 10, 5), "n16": (16, 8, 4)}


def _specs(kind, width):
    n, m, k = WIDTHS[width]
    return specs_t.AdderSpec(kind, n, m, k), specs_j.AdderSpec(kind, n, m, k)


def _ragged():
    """tests/test_mul.py's MAC operands: rng(21), int8 (16, 300) @
    (300, 24), so bk 128 gives two full tiles and a ragged third."""
    rng = np.random.default_rng(21)
    a = rng.integers(-128, 128, size=(16, 300), dtype=np.int8)
    b = rng.integers(-128, 128, size=(300, 24), dtype=np.int8)
    return a, b


def _pallas_and_jax(name, *args, **kw):
    return [np.asarray(getattr(get_backend_j(be), name)(
        *(jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in args),
        **kw)) for be in ("jax", "pallas")]


# --------------------------------------------------------------- conv2d --

@pytest.mark.parametrize("mul", [("broken_array", 8, 3, 1),
                                 ("truncated", 8, 3, 0),
                                 ("mitchell", 8, 0, 0)],
                         ids=lambda c: c[0])
def test_conv2d_matches_reference(mul):
    rng = np.random.default_rng(11)
    q = rng.integers(-255, 256, size=(3, 17, 29)).astype(np.int32)
    st, sj = _specs("haloc_axa", "n16")
    ms, msj = MulSpec(*mul), MulSpec_j(*mul)
    want = np.asarray(get_backend_j("numpy").conv2d(
        q, sj, msj, KERNEL, shift=2, strategy="reference"))
    for strategy in ("reference", "fused"):
        for got_j in _pallas_and_jax("conv2d", q, sj, msj, KERNEL, shift=2,
                                     strategy=strategy):
            np.testing.assert_array_equal(got_j, want)
        got = TORCH.conv2d(torch.as_tensor(q), st, ms, KERNEL, shift=2,
                           strategy=strategy)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=strategy)
        np.testing.assert_array_equal(
            conv_k.conv2d_mac(torch.as_tensor(q), st, ms, KERNEL, shift=2,
                              fast=strategy == "fused").numpy(), want)
    lut_j = np.asarray(get_backend_j("jax").conv2d(
        jnp.asarray(q), sj, msj, KERNEL, shift=2, strategy="lut"))
    got = TORCH.conv2d(torch.as_tensor(q), st, ms, KERNEL, shift=2,
                       strategy="lut")
    np.testing.assert_array_equal(got.numpy(), lut_j)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", ["n32", "n16"])
@pytest.mark.parametrize("shift", [0, 2])
def test_conv2d_kinds_shapes_and_5x5(width, shift):
    """Every adder kind, a 5 x 5 kernel with negative weights, 1-wide
    kernels, edge shapes and leading batch dims, against the reference's
    host oracle (which test_mul holds equal to jax and pallas); at n16
    also through the engine."""
    rng = np.random.default_rng(12)
    k5 = tuple(tuple(int(x) for x in row)
               for row in rng.integers(-9, 10, (5, 5)))
    ms, msj = MulSpec("truncated", 8, 3), MulSpec_j("truncated", 8, 3)
    for kind in specs_j.ALL_KINDS:
        st, sj = _specs(kind, width)
        eng = make_engine(st, fmt=FixedPointFormat(16, 0), mul=ms, **CPU) \
            if width == "n16" else None
        for shape, kernel in (((1, 1), KERNEL), ((2, 3), k5),
                              ((2, 2, 9, 6), k5), ((5, 4), ((2,),)),
                              ((3, 8), ((1, -2, 1),))):
            q = rng.integers(-255, 256, size=shape).astype(np.int32)
            want = np.asarray(get_backend_j("numpy").conv2d(
                q, sj, msj, kernel, shift=shift))
            got = TORCH.conv2d(torch.as_tensor(q), st, ms, kernel,
                               shift=shift)
            assert tuple(got.shape) == shape
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{kind} {shape}")
            if eng is not None:
                np.testing.assert_array_equal(
                    eng.conv2d(q, kernel, shift=shift).numpy(), want)


def test_conv2d_rounding_add_wraps_in_int32():
    """At N=32 with 15-bit products the sums reach 2^31, and the rounding
    add wraps in int32 as the reference's jax and pallas backends do
    (shift 31 takes every sum at or above 2^30 past it); the reference's
    numpy oracle rounds in int64 and does not wrap."""
    rng = np.random.default_rng(13)
    q = rng.integers(-(1 << 15) + 1, 1 << 15, size=(2, 6, 7)).astype(np.int32)
    kernel = tuple(tuple(int(x) for x in row)
                   for row in rng.integers(-(1 << 15) + 1, 1 << 15, (3, 3)))
    for kind in ("accurate", "haloc_axa"):
        st, sj = _specs(kind, "n32")
        for mk in ("accurate", "truncated"):
            ms, msj = MulSpec(mk, 15, 7 * (mk != "accurate")), \
                MulSpec_j(mk, 15, 7 * (mk != "accurate"))
            for shift in (0, 1, 4, 31):
                want = np.asarray(get_backend_j("jax").conv2d(
                    jnp.asarray(q), sj, msj, kernel, shift=shift))
                got = TORCH.conv2d(torch.as_tensor(q), st, ms, kernel,
                                   shift=shift)
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{kind} {mk} {shift}")
    st, sj = _specs("accurate", "n32")
    host = get_backend_j("numpy").conv2d(q, sj, MulSpec_j("accurate", 15),
                                         kernel, shift=31)
    got = TORCH.conv2d(torch.as_tensor(q), st, MulSpec("accurate", 15),
                       kernel, shift=31)
    assert (np.asarray(host) != got.numpy()).sum() == 18


def test_conv2d_out_of_range_raises_as_numpy_backend():
    """|q| >= 2^w: the numpy backend raises, and the port raises the same
    message on both backends' paths (jax and pallas return a wrong value
    from a gather past the table instead)."""
    st, sj = _specs("haloc_axa", "n16")
    ms, msj = MulSpec("truncated", 8, 3), MulSpec_j("truncated", 8, 3)
    for v in (300, -256, 256):
        q = np.array([[v, 1], [2, 3]], np.int32)
        with pytest.raises(ValueError, match=r"\|q\| < 2\^8") as ref:
            get_backend_j("numpy").conv2d(q, sj, msj, KERNEL)
        with pytest.raises(ValueError, match=r"\|q\| < 2\^8") as got:
            TORCH.conv2d(torch.as_tensor(q), st, ms, KERNEL)
        assert str(got.value) == str(ref.value)
        with pytest.raises(ValueError, match=r"\|q\| < 2\^8"):
            conv_k.conv2d_mac(torch.as_tensor(q), st, ms, KERNEL)
    ok = np.array([[255, -255]], np.int32)
    assert TORCH.conv2d(torch.as_tensor(ok), st, ms, KERNEL).shape == (1, 2)


def test_conv2d_argument_errors():
    st, _ = _specs("haloc_axa", "n16")
    ms = MulSpec("truncated", 8, 3)
    q = torch.zeros((4, 4), dtype=torch.int32)
    for bad in ((), ((1, 1),), ((1, 1, 1), (1, 1))):
        with pytest.raises(ValueError, match="kernel"):
            TORCH.conv2d(q, st, ms, bad)
    with pytest.raises(ValueError, match="kernel rows"):
        TORCH.conv2d(q, st, ms, ((1, 1, 1), (1, 1, 1), (1, 1)))
    with pytest.raises(ValueError, match=r"\(\.\.\., H, W\)"):
        TORCH.conv2d(q[0], st, ms, KERNEL)
    with pytest.raises(ValueError, match="shift"):
        TORCH.conv2d(q, st, ms, KERNEL, shift=32)
    with pytest.raises(ValueError, match="weight"):
        TORCH.conv2d(q, st, ms, ((256,),))
    # The cuda backend refuses the adder's lut strategy, as Pallas does.
    with pytest.raises(NotImplementedError, match="lut"):
        be_t.get_backend("cuda").conv2d(q, st, ms, KERNEL, strategy="lut")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        be_t.get_backend("cuda").conv2d(q, st, ms, KERNEL)


# --------------------------------------------------------------- matmul --

@pytest.mark.parametrize("width", ["n32", "n16"])
def test_mac_matmul_ragged_matches_reference(width):
    """The MAC GEMM on test_mul's ragged operands: every strategy on the
    torch backend equals the reference's numpy, jax and pallas."""
    a, b = _ragged()
    st, sj = _specs("haloc_axa", width)
    ms, msj = MulSpec("truncated", 8, 3), MulSpec_j("truncated", 8, 3)
    want = np.asarray(get_backend_j("numpy").matmul(
        a, b, sj, strategy="reference", mul_spec=msj))
    for got_j in _pallas_and_jax("matmul", a, b, sj, strategy="fused",
                                 mul_spec=msj):
        np.testing.assert_array_equal(got_j, want)
    for strategy in ("reference", "fused", "lut"):
        got = TORCH.matmul(torch.as_tensor(a), torch.as_tensor(b), st,
                           strategy=strategy, mul_spec=ms)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=strategy)
    np.testing.assert_array_equal(
        mac_k.mac_matmul(torch.as_tensor(a).to(torch.int32),
                         torch.as_tensor(b).to(torch.int32), st, ms).numpy(),
        want)
    exact = np.asarray(get_backend_j("numpy").matmul(a, b, sj))
    assert not np.array_equal(exact, want)


@pytest.mark.parametrize("width", ["n32", "n16"])
def test_mac_matmul_kinds_single_tile_and_bk(width):
    """Every adder and multiplier kind against the reference's host MAC
    oracle (which test_mul holds equal to jax and pallas); a single K
    tile (K <= bk) returns the raw int32 partial; bk sets where the folds
    fall."""
    rng = np.random.default_rng(31)
    a = rng.integers(-128, 128, size=(9, 70), dtype=np.int8)
    b = rng.integers(-128, 128, size=(70, 11), dtype=np.int8)
    for kind in specs_j.ALL_KINDS:
        st, sj = _specs(kind, width)
        for mk in ("truncated", "broken_array", "mitchell"):
            ms = MulSpec(mk, 8, 2, 1 if mk == "broken_array" else 0)
            msj = MulSpec_j(mk, 8, 2, 1 if mk == "broken_array" else 0)
            eng = make_engine(st, mul=ms, **CPU)
            for block in ((128, 128, 128), (8, 8, 16), (4, 4, 70), (2, 2, 1)):
                want = np.asarray(get_backend_j("numpy").matmul(
                    a, b, sj, block=block, mul_spec=msj))
                got = eng.matmul(a, b, block=block)
                np.testing.assert_array_equal(
                    got.numpy(), want, err_msg=f"{kind} {mk} {block}")
    # One tile: the raw sum of the signed-table products, no fold at all.
    st, _ = _specs("loawa", width)
    ms = MulSpec("truncated", 8, 3)
    table = torch.as_tensor(signed_mul_table(ms).astype(np.int64))
    idx = ((torch.as_tensor(a).to(torch.int64) & 255) << 8)[:, :, None] \
        | (torch.as_tensor(b).to(torch.int64) & 255)[None, :, :]
    raw = table[idx].sum(1)
    got = make_engine(st, mul=ms, **CPU).matmul(a, b)
    np.testing.assert_array_equal(got.numpy(), raw.numpy())


@pytest.mark.parametrize("width", ["n32", "n16"])
def test_exact_product_matmul_matches_pallas_and_jax(width):
    """The exact-product path (no multiplier, or an exact one) on the
    ragged operands and on a single tile, every kind, against jax and
    pallas; the engine's lut strategy against jax's lut."""
    a, b = _ragged()
    for kind in specs_j.ALL_KINDS:
        st, sj = _specs(kind, width)
        j, p = _pallas_and_jax("matmul", a, b, sj, strategy="fused")
        np.testing.assert_array_equal(j, p)
        for strategy in ("reference", "fused", "lut"):
            eng = make_engine(st, strategy=strategy, **CPU)
            np.testing.assert_array_equal(eng.matmul(a, b).numpy(), j,
                                          err_msg=f"{kind} {strategy}")
        exact_mul = make_engine(st, mul=MulSpec("accurate", 8), **CPU)
        np.testing.assert_array_equal(exact_mul.matmul(a, b).numpy(), j)
        one = np.asarray(get_backend_j("pallas").matmul(
            jnp.asarray(a[:, :100]), jnp.asarray(b[:100]), sj))
        np.testing.assert_array_equal(
            mm_k.approx_matmul(torch.as_tensor(a[:, :100]),
                               torch.as_tensor(b[:100]), st).numpy(), one)
        np.testing.assert_array_equal(
            one, a[:, :100].astype(np.int64) @ b[:100].astype(np.int64))
    lut_j = np.asarray(get_backend_j("jax").matmul(
        jnp.asarray(a), jnp.asarray(b), _specs("haloc_axa", width)[1],
        strategy="lut"))
    got = make_engine(_specs("haloc_axa", width)[0], strategy="lut",
                      **CPU).matmul(a, b)
    np.testing.assert_array_equal(got.numpy(), lut_j)


def test_exact_product_matmul_n16_follows_jax_not_numpy():
    """The reference disagrees with itself below N = 32: the numpy oracle
    (ref_approx_matmul) folds with approx_add and keeps the carry-out;
    jax and pallas fold with approx_add_mod and keep the N-bit residue.
    The port follows jax/pallas.  At N = 32 all three agree."""
    a, b = _ragged()
    st, sj = _specs("haloc_axa", "n16")
    j, p = _pallas_and_jax("matmul", a, b, sj)
    got = make_engine(st, **CPU).matmul(a, b).numpy()
    np.testing.assert_array_equal(got, j)
    np.testing.assert_array_equal(got, p)
    assert got.min() >= 0 and got.max() < 1 << 16
    numpy_ref = ref_approx_matmul(a, b, sj)
    assert np.array_equal(np.asarray(get_backend_j("numpy").matmul(
        a, b, sj)), numpy_ref)
    differ = numpy_ref != got
    assert differ.sum() == 280 and numpy_ref.min() < 0
    assert numpy_ref.max() >= 1 << 16
    st32, sj32 = _specs("haloc_axa", "n32")
    np.testing.assert_array_equal(
        make_engine(st32, **CPU).matmul(a, b).numpy(),
        ref_approx_matmul(a, b, sj32))


def test_matmul_operand_rules():
    st, _ = _specs("haloc_axa", "n32")
    a = torch.zeros((4, 8), dtype=torch.int32)
    b = torch.zeros((8, 3), dtype=torch.int32)
    # The torch backend takes any integer dtype, as jax does ...
    assert TORCH.matmul(a, b, st).shape == (4, 3)
    # ... the int8 GEMM's wrapper only int8, as approx_matmul_pallas.
    with pytest.raises(TypeError, match="int8"):
        mm_k.approx_matmul(a, b, st)
    with pytest.raises(TypeError, match="int32"):
        mm_k.approx_matmul(a.to(torch.int8), b, st)
    with pytest.raises(ValueError, match=r"\(M, K\) @ \(K, N\)"):
        TORCH.matmul(a, a, st)
    with pytest.raises(ValueError, match="K must be"):
        TORCH.matmul(a[:, :0], b[:0], st)
    with pytest.raises(ValueError, match="bk"):
        TORCH.matmul(a, b, st, block=(128, 128, 0))
    with pytest.raises(NotImplementedError, match="lut"):
        be_t.get_backend("cuda").matmul(a, b, st, strategy="lut")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        be_t.get_backend("cuda").matmul(a, b, st)


# ------------------------------------------------------------- workload --

@pytest.mark.parametrize("kind", specs_j.TABLE1_KINDS)
def test_conv3x3_workload_matches_reference(kind):
    batch = synthetic_batch(2, 32)
    want = get_workload_j("conv3x3").run(batch, kind=kind, backend="jax")
    got = get_workload("conv3x3").run(batch, kind=kind, **CPU)
    assert got.dtype == np.uint8 and got.shape == batch.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        get_workload("conv3x3").reference(batch),
        get_workload_j("conv3x3").reference(batch))


def test_conv3x3_normalize_equals_numpy_division():
    """The workload's /21 on the engine's device equals the reference's
    numpy ``clip((v + 10) // 21, 0, 255)`` (floor division), sums below 0
    and above 255 * 21 included (approximate adders reach them)."""
    from repro_torch.imgproc.workloads import conv3x3_normalize
    rng = np.random.default_rng(70)
    edges = np.array([-(1 << 20), -32768, -22, -21, -12, -11, -10, -1, 0, 1,
                      10, 11, 31, 32, 5344, 5345, 5354, 5355, 5365, 5366,
                      5376, 32767, 1 << 20], dtype=np.int64)
    v = np.concatenate([edges, rng.integers(-70000, 70000, 4096)])
    want = np.clip((v + 10) // 21, 0, 255).astype(np.uint8)
    got = conv3x3_normalize(torch.as_tensor(v.astype(np.int32)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_conv3x3_exact_mac_and_mul_knob():
    batch = synthetic_batch(2, 32)
    wl = get_workload("conv3x3")
    exact = wl.run(batch, kind="accurate", mul=MulSpec("accurate", 8),
                   **CPU)
    np.testing.assert_array_equal(exact, wl.reference(batch))
    for mul in ("mitchell", MulSpec("broken_array", 8, 4, 2)):
        mul_j = mul if isinstance(mul, str) else MulSpec_j(
            mul.kind, mul.n_bits, mul.trunc_bits, mul.row_bits)
        np.testing.assert_array_equal(
            wl.run(batch, kind="haloc_axa", mul=mul, strategy="lut", **CPU),
            get_workload_j("conv3x3").run(batch, kind="haloc_axa",
                                          backend="jax", mul=mul_j))
    assert wl.batched


# ------------------------------------------- approx_matmul's K schedule --

def _schedule_model(a, b, spec, bk):
    """The CUDA kernel's walk over K in Python, on int64 lanes: K tile t
    (of bk) in ceil(bk / KC) chunks of KC, each cut at the tile's end and
    at K, the tile's partial (mod 2^32) folded after its last chunk; the
    first tile's partial is taken raw."""
    kc = mm_k.KC
    k = a.shape[1]
    bk = min(bk, k)
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    acc = None
    for t in range(-(-k // bk)):
        part = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64)
        tile_end = min(t * bk + bk, k)
        for k0 in range(t * bk, tile_end, kc):
            klim = min(k0 + kc, tile_end)
            part = (part + a64[:, k0:klim] @ b64[k0:klim]) & 0xFFFFFFFF
        part = add_k.to_int32(part)
        acc = part if acc is None else add_k.approx_add_plain(acc, part,
                                                              spec)
    return acc


#: (M, K, N, bk, A's byte offset from 16-byte alignment, route).
ROUTE_CASES = [
    (64, 1024, 64, 128, 0, "fast"), (16, 300, 24, 128, 0, "general"),
    (70, 96, 130, 200, 0, "fast"), (33, 257, 65, 100, 0, "general"),
    (70, 257, 130, 100, 0, "general"), (33, 300, 65, 200, 0, "general"),
    (65, 80, 63, 32, 0, "general"), (64, 48, 72, 128, 0, "fast"),
    (96, 256, 40, 512, 0, "fast"), (128, 208, 128, 96, 0, "general"),
    (40, 256, 24, 64, 1, "general"), (40, 256, 24, 64, 8, "general"),
    (40, 320, 24, 192, 0, "fast"), (40, 160, 24, 16, 0, "general"),
    (8, 1, 8, 1, 0, "general"), (8, 16, 8, 128, 0, "fast"),
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_approx_matmul_staging_route_and_schedule(case):
    """staging_route picks the 16-byte staging only for a 16-byte aligned
    A, K % 16 == 0 and K tiles of whole 64-byte chunks; the kernel's walk
    over K (its chunks and folds) equals the plain version at n32 and
    n16."""
    m, k, n, bk, offset, route = case
    assert mm_k.staging_route(k, bk, 4096 + offset) == route
    rng = np.random.default_rng(m * 7 + k)
    a = torch.as_tensor(rng.integers(-128, 128, (m, k), dtype=np.int8))
    b = torch.as_tensor(rng.integers(-128, 128, (k, n), dtype=np.int8))
    for width in WIDTHS:
        st, _ = _specs("haloc_axa", width)
        assert torch.equal(_schedule_model(a, b, st, bk),
                           mm_k.approx_matmul_plain(a, b, st, bk)), width


# ------------------------------- mac_matmul's int16 table and its tile loop --

def _mul_specs_upto(w_max):
    """Every registered multiplier at w = 2 ... w_max, each with a few
    truncation / row settings the spec accepts."""
    from repro_torch.ax.mul import get_multiplier, registered_multipliers
    out = []
    for kind in registered_multipliers():
        entry = get_multiplier(kind)
        for w in range(2, w_max + 1):
            for t in sorted({0, w // 2, w - 1 - entry.trunc_margin}):
                for r in sorted({0, w // 4} if entry.uses_rows else {0}):
                    try:
                        out.append(MulSpec(kind, w, t if entry.uses_trunc
                                           else 0, r))
                    except ValueError:
                        continue
    return sorted(set(out), key=str)


def test_int16_table_holds_every_entry_up_to_8_bits():
    """For every registered multiplier at w <= 8 the signed product table
    fits int16 (computed from the table), and the int16 device copy the
    shared route stages holds every entry of the port's and the
    reference's ``signed_mul_table``."""
    from repro.ax.mul import lut as lut_j
    from repro_torch.ax.mul import lut as lut_t
    specs_seen = _mul_specs_upto(8)
    assert {s.kind for s in specs_seen} >= {"accurate", "truncated",
                                            "broken_array", "mitchell"}
    for ms in specs_seen:
        want = signed_mul_table(ms)
        np.testing.assert_array_equal(want, lut_j.signed_mul_table(MulSpec_j(
            ms.kind, ms.n_bits, ms.trunc_bits, ms.row_bits)))
        assert lut_t.signed_table_fits_int16(ms), ms
        got = lut_t.device_signed_table16(ms, "cpu")
        assert got.dtype == torch.int16 and got.numel() == 4 ** ms.n_bits
        np.testing.assert_array_equal(got.numpy().astype(np.int32), want,
                                      err_msg=str(ms))
        assert mac_k.mac_route(ms.n_bits, True) == "shared"


def test_mac_route_and_the_int16_check():
    """mac_route: shared at w <= 8, global at w = 9 and 10 and wherever a
    table does not fit int16; device_signed_table16 refuses such a table
    rather than narrowing it."""
    from repro_torch.ax.mul import lut as lut_t
    assert [mac_k.mac_route(w) for w in range(1, 11)] == \
        ["shared"] * 8 + ["global"] * 2
    assert mac_k.mac_route(8, fits_int16=False) == "global"
    wide = MulSpec("accurate", 9)
    assert not lut_t.signed_table_fits_int16(wide)
    with pytest.raises(ValueError, match="outside int16"):
        lut_t.device_signed_table16(wide, "cpu")
    assert mac_k.mac_route(wide.n_bits,
                           lut_t.signed_table_fits_int16(wide)) == "global"


def _mac_kernel_model(a, b, spec, ms, bk, blocks, fast=False):
    """``mac_matmul_launch`` in Python: ``blocks`` persistent blocks walk
    the 64 x 64 output tiles (tile = block, block + blocks, ...); each
    tile's K loop runs K tiles of bk in chunks of 32 that stop at the
    tile's end, the chunk staged with zeros past it and past K (A as the
    byte offset (a & mask) << (w + EB) in slot (r % 8) * 8 + r // 8 of its
    row, B as (b & mask) << EB; EB = 1 for the int16 table, 2 for int32);
    thread (warp, lane) reads A slots warp * 8 ... + 7 and B columns 2 *
    lane, 2 * lane + 1, gathers at the OR of the two and sums mod 2^32;
    the K tiles fold through the adder, the first taken as it is."""
    from repro_torch.ax.mul import lut as lut_t
    w = ms.n_bits
    route = mac_k.mac_route(w, lut_t.signed_table_fits_int16(ms))
    eb = 1 if route == "shared" else 2
    table = (lut_t.device_signed_table16 if route == "shared"
             else lut_t.device_signed_table)(ms, "cpu").to(torch.int64)
    mask, tile, kc = (1 << w) - 1, 64, 32
    (m, k), n = a.shape, b.shape[1]
    tiles_n = -(-n // tile)
    n_tiles = -(-m // tile) * tiles_n
    out = torch.full((m, n), -7, dtype=torch.int32)
    warp, lane, i, j = torch.meshgrid(torch.arange(8), torch.arange(32),
                                      torch.arange(8), torch.arange(2),
                                      indexing="ij")
    a_slot = warp * 8 + i                      # the thread's A slot
    rows, cols = warp + 8 * i, 2 * lane + j    # its output
    r = torch.arange(tile)
    a_of_slot = torch.empty(tile, dtype=torch.int64)
    a_of_slot[(r % 8) * 8 + r // 8] = r        # the staging's row order
    seen = torch.zeros(n_tiles, dtype=torch.int64)
    for blk in range(blocks):
        for t_ix in range(blk, n_tiles, blocks):
            seen[t_ix] += 1
            row0, col0 = (t_ix // tiles_n) * tile, (t_ix % tiles_n) * tile
            acc = None
            for k_lo in range(0, k, bk):
                k_hi = min(k_lo + bk, k)
                part = torch.zeros(rows.shape, dtype=torch.int64)
                for k0 in range(k_lo, k_hi, kc):
                    a_st = torch.zeros((kc, tile), dtype=torch.int64)
                    b_st = torch.zeros((kc, tile), dtype=torch.int64)
                    for c in range(kc):
                        if k0 + c >= k_hi:
                            break
                        av = torch.zeros(tile, dtype=torch.int64)
                        bv = torch.zeros(tile, dtype=torch.int64)
                        nr, nc = min(tile, m - row0), min(tile, n - col0)
                        av[:nr] = a[row0:row0 + nr, k0 + c].to(torch.int64)
                        bv[:nc] = b[k0 + c, col0:col0 + nc].to(torch.int64)
                        a_st[c][(r % 8) * 8 + r // 8] = (av & mask) << (w + eb)
                        b_st[c] = (bv & mask) << eb
                    for kk in range(kc):
                        off = a_st[kk][a_slot] | b_st[kk][cols]
                        part = (part + table[off >> eb]) & 0xFFFFFFFF
                part32 = add_k.to_int32(part)
                acc = part32 if acc is None else add_k.approx_add_plain(
                    acc, part32, spec, fast)
            assert torch.equal(a_of_slot[a_slot], rows)
            gr, gc = rows + row0, cols + col0
            ok = (gr < m) & (gc < n)
            out[gr[ok], gc[ok]] = acc[ok]
    assert bool((seen == 1).all())
    return out


@pytest.mark.parametrize("case", [
    ("haloc_axa", "n32", ("truncated", 8, 3, 0), (70, 100, 65), 33, 3),
    ("loa", "n16", ("mitchell", 8, 0, 0), (65, 75, 130), 40, 2),
    ("eta", "n32", ("broken_array", 8, 3, 2), (64, 70, 64), 1, 1),
    ("haloc_axa", "n16", ("truncated", 10, 4, 0), (33, 97, 70), 50, 4),
    ("accurate", "n32", ("mitchell", 10, 0, 0), (20, 64, 20), 128, 2)],
    ids=lambda c: "-".join(map(str, c[:2])) + f"-{c[2][0]}{c[2][1]}-bk{c[4]}")
def test_mac_kernel_model_equals_plain_and_reference(case):
    """The model of the kernel's persistent tile loop, K chunks at bk not
    a multiple of 32 (33, 40, 50; 1; and bk > K), ragged M, N and K, both
    table routes (w = 8 shared, w = 10 global), against mac_matmul_plain
    and the reference's numpy backend."""
    kind, width, mul, (m, k, n), bk, blocks = case
    st, sj = _specs(kind, width)
    ms, msj = MulSpec(*mul), MulSpec_j(*mul)
    rng = np.random.default_rng(61)
    lim = 1 << (ms.n_bits - 1)
    a = rng.integers(-lim, lim, (m, k)).astype(np.int32)
    b = rng.integers(-lim, lim, (k, n)).astype(np.int32)
    got = _mac_kernel_model(torch.as_tensor(a), torch.as_tensor(b), st, ms,
                            bk, blocks, fast=kind == "loa")
    want = mac_k.mac_matmul_plain(torch.as_tensor(a), torch.as_tensor(b), st,
                                  ms, bk)
    assert torch.equal(got, want)
    ref = np.asarray(get_backend_j("numpy").matmul(
        a, b, sj, block=(128, 128, bk), mul_spec=msj))
    np.testing.assert_array_equal(got.numpy(), ref)
