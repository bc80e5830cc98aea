"""The CUDA kernels against their plain versions, on the card (exact).

Marked ``cuda``: each test asks the ``cuda_device`` fixture, which skips
when no CUDA device or no ``nvcc`` is present (as on a CPU-only host).
Run on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.ax import FilterStage
from repro_torch.core import specs
from repro_torch.imgproc import (PIPELINES, compile_pipeline, run_tiled,
                                 synthetic_batch)
from repro_torch.kernels import accumulate as acc_k
from repro_torch.kernels import approx_add as add_k
from repro_torch.kernels import butterfly as bf_k
from repro_torch.kernels import conv_chain as chain_k
from repro_torch.kernels import lut_add as lut_k

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if shutil.which("nvcc") is None and \
            not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _valid_mk(kind, n_bits):
    out = []
    for m in range(1, n_bits + 1):
        for k in range(0, m + 1):
            try:
                specs.AdderSpec(kind, n_bits, m, k)
            except ValueError:
                continue
            out.append((m, k))
    return out


@pytest.mark.parametrize("kind", specs.ALL_KINDS)
def test_approx_add_exhaustive_n8(cuda_device, kind):
    a, b = torch.meshgrid(torch.arange(256, dtype=torch.int32),
                          torch.arange(256, dtype=torch.int32),
                          indexing="ij")
    a, b = a.contiguous(), b.contiguous()
    ad, bd = a.to(cuda_device), b.to(cuda_device)
    for m, k in _valid_mk(kind, 8):
        spec = specs.AdderSpec(kind, 8, m, k)
        for fast in (False, True):
            got = add_k.approx_add(ad, bd, spec, fast=fast).cpu()
            assert torch.equal(got, add_k.approx_add_plain(a, b, spec, fast))


@pytest.mark.parametrize("kind", specs.ALL_KINDS)
def test_accumulate_and_chain_on_card(cuda_device, kind):
    rng = np.random.default_rng(1)
    spec = specs.AdderSpec(kind, 16, 8, 4)
    terms = torch.as_tensor(rng.integers(0, 1 << 16, (9, 3, 37, 41))
                            .astype(np.int32))
    ws = (1, 2, 1, -2, 4, -2, 1, 2, -1)
    for fast in (False, True):
        got = acc_k.accumulate(terms.to(cuda_device), spec, weights=ws,
                               fast=fast).cpu()
        assert torch.equal(got, acc_k.accumulate_plain(terms, spec, ws,
                                                       fast))
    stages = (FilterStage(-2, (-1, 0, 1), (1, 2, 1)),
              FilterStage(-1, (1, -1), (1, -1)),
              FilterStage(-1, (-2, 0, 3), (1, -3, 2), 1))
    for shape in [(1, 1), (1, 9), (9, 1), (2, 2), (3, 5), (2, 33, 70),
                  (1, 130, 67)]:
        q = torch.as_tensor(rng.integers(-1500, 1500, shape)
                            .astype(np.int32))
        got = chain_k.filter_chain(q.to(cuda_device), spec, stages).cpu()
        assert torch.equal(got, chain_k.filter_chain_plain(q, spec,
                                                           stages)), shape


def test_pipelines_and_tiles_on_card(cuda_device):
    batch = synthetic_batch(2, 96)
    for stages in PIPELINES.values():
        for requant in ("stage", "fused"):
            gpu = compile_pipeline(stages, requant=requant)
            cpu = compile_pipeline(stages, requant=requant, backend="torch",
                                   device="cpu")
            want = cpu(batch).numpy()
            np.testing.assert_array_equal(gpu(batch).cpu().numpy(), want)
            np.testing.assert_array_equal(
                run_tiled(gpu, batch, tile=(32, 48)), want)


@pytest.mark.parametrize("kind", [k for k in specs.ALL_KINDS
                                  if k != "accurate"])
def test_lut_add_on_card(cuda_device, kind):
    """Exact kinds have no table (they take the plain add)."""
    rng = np.random.default_rng(2)
    a8, b8 = torch.meshgrid(torch.arange(256, dtype=torch.int32),
                            torch.arange(256, dtype=torch.int32),
                            indexing="ij")
    cases = [(specs.AdderSpec(kind, 8, m, k), a8.contiguous(), b8.contiguous())
             for m, k in _valid_mk(kind, 8)]
    for n_bits, m, k in ((16, 8, 4), (32, 10, 5)):
        a, b = (torch.as_tensor(rng.integers(0, 1 << n_bits, (37, 1001),
                                             dtype=np.uint64)
                                .astype(np.uint32).view(np.int32))
                for _ in range(2))
        cases.append((specs.AdderSpec(kind, n_bits, m, k), a, b))
    for spec, a, b in cases:
        got = lut_k.lut_add(a.to(cuda_device), b.to(cuda_device), spec).cpu()
        assert torch.equal(got, lut_k.lut_add_plain(a, b, spec))
        assert torch.equal(got, add_k.approx_add_plain(a, b, spec))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", specs.ALL_KINDS)
def test_butterfly_on_card(cuda_device, kind, inverse):
    rng = np.random.default_rng(3)
    for n_bits, m, k in ((32, 10, 5), (16, 8, 4)):
        spec = specs.AdderSpec(kind, n_bits, m, k)
        for rows, half in ((131072, 1), (512, 256), (1001, 7)):
            x_re, x_im = (torch.as_tensor(
                rng.integers(-(1 << 31), 1 << 31, (rows, 2 * half))
                .astype(np.int32)) for _ in range(2))
            w_re, w_im = (torch.as_tensor(
                rng.integers(-(1 << 14), (1 << 14) + 1, half)
                .astype(np.int32)) for _ in range(2))
            planes = (x_re[:, :half], x_im[:, :half], x_re[:, half:],
                      x_im[:, half:])
            for fast in (False, True):
                got = bf_k.butterfly(*(p.to(cuda_device) for p in planes),
                                     w_re.to(cuda_device),
                                     w_im.to(cuda_device), spec,
                                     inverse=inverse, fast=fast)
                want = bf_k.butterfly_plain(*planes, w_re, w_im, spec,
                                            inverse=inverse, fast=fast)
                for g, w in zip(got, want):
                    assert torch.equal(g.cpu(), w), (spec.short_name, half)


def test_reconstruct_and_lut_engine_on_card(cuda_device):
    from repro_torch.ax import make_engine
    from repro_torch.image.pipeline import reconstruct, synthetic_image
    img = synthetic_image(64)
    for spec in (specs.paper_spec("haloc_axa"), specs.paper_spec("loawa"),
                 specs.AdderSpec("haloc_axa", 16, 8, 4)):
        for block in (16, 0):
            got = reconstruct(img, spec, block=block)
            assert got.device.type == "cuda"
            want = reconstruct(img, spec, block=block, backend="torch",
                               device="cpu")
            assert torch.equal(got.cpu(), want)
    eng = make_engine("haloc_axa", strategy="lut")
    a = torch.arange(1 << 20, dtype=torch.int32) * 4093
    b = torch.flip(a, (0,))
    cpu = make_engine("haloc_axa", strategy="lut", backend="torch",
                      device="cpu")
    assert torch.equal(eng.add(a, b).cpu(), cpu.add(a, b))
    with pytest.raises(NotImplementedError, match="elementwise add"):
        eng.accumulate(torch.stack([a, b]).to(cuda_device))


# ------------------------------------------------------- the MAC kernels --

MUL_SPECS = [("accurate", 8, 0, 0), ("truncated", 8, 3, 0),
             ("broken_array", 8, 4, 2), ("mitchell", 8, 0, 0),
             ("mitchell", 8, 3, 0), ("truncated", 10, 5, 0)]


@pytest.mark.parametrize("cfg", MUL_SPECS, ids=lambda c: "-".join(map(str, c)))
def test_mul_on_card(cuda_device, cfg):
    from repro_torch.ax.mul import MulSpec
    from repro_torch.kernels import mul as mul_k
    spec = MulSpec(*cfg)
    n = 1 << spec.n_bits
    a, b = torch.meshgrid(torch.arange(n, dtype=torch.int32),
                          torch.arange(n, dtype=torch.int32), indexing="ij")
    for a_, b_ in ((a.contiguous(), b.contiguous()),
                   (a.reshape(-1)[:n * n - 3], b.reshape(-1)[:n * n - 3])):
        want = mul_k.mul_plain(a_, b_, spec)
        for strategy in ("reference", "fused", "lut"):
            got = mul_k.mul(a_.to(cuda_device), b_.to(cuda_device), spec,
                            strategy=strategy).cpu()
            assert torch.equal(got, want), strategy


@pytest.mark.parametrize("n_bits,m,k", [(32, 10, 5), (16, 8, 4)])
def test_matmuls_on_card(cuda_device, n_bits, m, k):
    from repro_torch.ax.mul import MulSpec
    from repro_torch.kernels import approx_matmul as mm_k
    from repro_torch.kernels import mac_matmul as mac_k
    rng = np.random.default_rng(21)
    cases = [((16, 300), (300, 24), 128), ((130, 64), (64, 70), 128),
             ((5, 7), (7, 3), 2), ((64, 257), (257, 65), 100)]
    for kind in specs.ALL_KINDS:
        spec = specs.AdderSpec(kind, n_bits, m, k)
        for (sa, sb, bk) in cases:
            a = torch.as_tensor(rng.integers(-128, 128, sa, dtype=np.int8))
            b = torch.as_tensor(rng.integers(-128, 128, sb, dtype=np.int8))
            for fast in (False, True):
                got = mm_k.approx_matmul(a.to(cuda_device),
                                         b.to(cuda_device), spec, bk=bk,
                                         fast=fast).cpu()
                assert torch.equal(got, mm_k.approx_matmul_plain(
                    a, b, spec, bk, fast)), (kind, sa, bk)
                ms = MulSpec("truncated", 8, 3)
                a32, b32 = a.to(torch.int32), b.to(torch.int32)
                got = mac_k.mac_matmul(a32.to(cuda_device),
                                       b32.to(cuda_device), spec, ms, bk=bk,
                                       fast=fast).cpu()
                assert torch.equal(got, mac_k.mac_matmul_plain(
                    a32, b32, spec, ms, bk, fast)), (kind, sa, bk)


@pytest.mark.parametrize("kind", specs.ALL_KINDS)
def test_conv2d_mac_on_card(cuda_device, kind):
    from repro_torch.ax.mul import MulSpec
    from repro_torch.kernels import conv2d_mac as conv_k
    rng = np.random.default_rng(5)
    k5 = tuple(tuple(int(x) for x in row)
               for row in rng.integers(-9, 10, (5, 5)))
    spec = specs.AdderSpec(kind, 16, 8, 4)
    for ms in (MulSpec("truncated", 8, 3), MulSpec("mitchell", 10)):
        for shape in [(1, 1), (3, 17, 29), (2, 40, 33), (70, 5)]:
            q = torch.as_tensor(rng.integers(-255, 256, shape)
                                .astype(np.int32))
            for kernel in (((1, 3, 1), (3, -5, 3), (1, 3, 1)), k5):
                for shift in (0, 2):
                    got = conv_k.conv2d_mac(q.to(cuda_device), spec, ms,
                                            kernel, shift=shift,
                                            fast=True).cpu()
                    want = conv_k.conv2d_mac_plain(q, spec, ms, kernel, shift)
                    assert torch.equal(got, want), (ms, shape, shift)
    with pytest.raises(ValueError, match="2\\^8"):
        conv_k.conv2d_mac(torch.full((2, 2), 256, dtype=torch.int32,
                                     device=cuda_device), spec,
                          MulSpec("truncated", 8, 3), ((1,),))


def test_mac_engine_and_conv3x3_on_card(cuda_device):
    from repro_torch.ax import make_engine
    from repro_torch.ax.mul import MulSpec
    from repro_torch.imgproc import get_workload
    batch = synthetic_batch(2, 64)
    wl = get_workload("conv3x3")
    for kind in specs.TABLE1_KINDS:
        assert np.array_equal(wl.run(batch, kind=kind),
                              wl.run(batch, kind=kind, backend="torch",
                                     device="cpu"))
    spec = specs.AdderSpec("haloc_axa", 16, 8, 4)
    rng = np.random.default_rng(9)
    a = rng.integers(-128, 128, (96, 200), dtype=np.int8)
    b = rng.integers(-128, 128, (200, 40), dtype=np.int8)
    for mul in (None, MulSpec("truncated", 8, 3)):
        gpu = make_engine(spec, mul=mul)
        cpu = make_engine(spec, mul=mul, backend="torch", device="cpu")
        assert torch.equal(gpu.matmul(a, b).cpu(), cpu.matmul(a, b))
    qa = rng.integers(-128, 129, (3, 50)).astype(np.int32)
    for strategy in ("reference", "fused", "lut"):
        gpu = make_engine(spec, mul="mitchell", strategy=strategy)
        cpu = make_engine(spec, mul="mitchell", strategy=strategy,
                          backend="torch", device="cpu")
        assert torch.equal(gpu.mul_signed(qa, qa).cpu(),
                           cpu.mul_signed(qa, qa))
    with pytest.raises(TypeError, match="int8"):
        make_engine(spec).matmul(a.astype(np.int32), b)


# ---------------------------------- the redesigned GEMM and chain kernels --

def _int8(rng, shape):
    return torch.as_tensor(rng.integers(-128, 128, shape, dtype=np.int8))


@pytest.mark.parametrize("n_bits,m,k", [(32, 10, 5), (16, 8, 4)])
def test_approx_matmul_routes_on_card(cuda_device, n_bits, m, k):
    """Both staging routes: the general one (bk 100, 200, 32 and 96, K =
    257 and 300, M and N off the 64 grid, a 1-byte-offset A), the 16-byte
    one (K % 32 == 16 with bk == K, bk > K, bk 192), every kind, both
    forms."""
    from repro_torch.kernels import approx_matmul as mm_k
    rng = np.random.default_rng(22)
    cases = [((70, 257), (257, 130), 100, "general"),
             ((33, 300), (300, 65), 200, "general"),
             ((16, 300), (300, 24), 128, "general"),
             ((65, 80), (80, 63), 32, "general"),
             ((128, 208), (208, 128), 96, "general"),
             ((64, 48), (48, 72), 128, "fast"),
             ((96, 256), (256, 40), 512, "fast"),
             ((70, 320), (320, 136), 192, "fast")]
    for kind in specs.ALL_KINDS:
        spec = specs.AdderSpec(kind, n_bits, m, k)
        for sa, sb, bk, route in cases:
            a, b = _int8(rng, sa), _int8(rng, sb)
            ad = a.to(cuda_device)
            assert mm_k.staging_route(sa[1], bk, ad.data_ptr()) == route
            for fast in (False, True):
                got = mm_k.approx_matmul(ad, b.to(cuda_device), spec, bk=bk,
                                         fast=fast).cpu()
                want = mm_k.approx_matmul_plain(a, b, spec, bk, fast)
                assert torch.equal(got, want), (kind, sa, bk, fast)
    # The 16-byte route's shape through the general route: A one byte off.
    spec = specs.AdderSpec("haloc_axa", n_bits, m, k)
    a, b = _int8(rng, (192, 256)), _int8(rng, (256, 96))
    buf = torch.empty(a.numel() + 1, dtype=torch.int8, device=cuda_device)
    ad = buf[1:].view(192, 256)
    ad.copy_(a)
    assert mm_k.staging_route(256, 64, ad.data_ptr()) == "general"
    got = mm_k.approx_matmul(ad, b.to(cuda_device), spec, bk=64).cpu()
    assert torch.equal(got, mm_k.approx_matmul_plain(a, b, spec, 64))


def test_approx_matmul_entry_refuses_a_bad_fast_route(cuda_device):
    """The C entry checks the 16-byte route's conditions itself: bk 96
    (chunks would cross a tile's end), K % 16 != 0 and an A off 16 bytes
    are refused with cudaErrorInvalidValue; bk > K is one tile."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import approx_matmul as mm_k
    from repro_torch.kernels.approx_add import adder_args, stream_ptr
    spec = specs.AdderSpec("haloc_axa", 32, 10, 5)
    fn = _build.bind("approx_matmul", "approx_matmul_launch",
                     mm_k._ARGTYPES)
    buf = torch.zeros(64 * 264 + 1, dtype=torch.int8, device=cuda_device)
    b = torch.zeros(264 * 64, dtype=torch.int8, device=cuda_device)
    bt = torch.empty_like(b)
    out = torch.empty(64 * 64, dtype=torch.int32, device=cuda_device)

    def launch(a_ptr, k_len, bk):
        err = fn(a_ptr, b.data_ptr(), bt.data_ptr(), out.data_ptr(), 64, 64,
                 k_len, bk, 1, *adder_args(spec, False),
                 stream_ptr(cuda_device))
        torch.cuda.synchronize(cuda_device)
        return err

    invalid = 1  # cudaErrorInvalidValue
    assert launch(buf.data_ptr(), 256, 96) == invalid
    assert launch(buf.data_ptr(), 264, 128) == invalid
    assert launch(buf.data_ptr() + 1, 256, 128) == invalid
    assert launch(buf.data_ptr(), 256, 128) == 0
    assert launch(buf.data_ptr(), 256, 300) == 0


@pytest.mark.parametrize("k_len", [131073, 131104])
def test_approx_matmul_dot_wraps_on_card(cuda_device, k_len):
    """All -128 operands, one K tile of 2^17 + 1 (general route) or
    2^17 + 32 (16-byte route, K % 64 == 32): every dot passes 2^31 and
    must wrap mod 2^32 (mma without .satfinite), as the reference's int32
    dot does."""
    from repro_torch.kernels import approx_matmul as mm_k
    spec = specs.paper_spec("haloc_axa")
    a = torch.full((16, k_len), -128, dtype=torch.int8)
    b = torch.full((k_len, 16), -128, dtype=torch.int8)
    got = mm_k.approx_matmul(a.to(cuda_device), b.to(cuda_device), spec,
                             bk=k_len).cpu()
    wrapped = (k_len * 16384 + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert wrapped < 0
    assert torch.equal(got, torch.full((16, 16), wrapped, dtype=torch.int32))
    assert torch.equal(got, mm_k.approx_matmul_plain(a, b, spec, k_len))


CHAIN_CASES = {
    "gauss": (FilterStage(-1, (-1, 0, 1), (1, 2, 1), 2),
              FilterStage(-2, (-1, 0, 1), (1, 2, 1), 2)),
    "sobel_gx": (FilterStage(-2, (-1, 0, 1), (1, 2, 1)),
                 FilterStage(-1, (1, -1), (1, -1))),
    "sobel_gy": (FilterStage(-1, (-1, 0, 1), (1, 2, 1)),
                 FilterStage(-2, (1, -1), (1, -1))),
    "same_axis": (FilterStage(-1, (-2, 0, 3), (1, -3, 2), 1),
                  FilterStage(-1, (-1, 1), (2, 1)),
                  FilterStage(-2, (0, 2), (1, 1), 1)),
    "wide": (FilterStage(-2, tuple(range(-4, 5)),
                         (1, 2, 3, 4, 5, 4, 3, 2, 1), 3),),
}


@pytest.mark.parametrize("kind", specs.ALL_KINDS)
def test_filter_chain_routes_on_card(cuda_device, kind):
    """Both routes, both forms: 1 x 1 and 1 x 7 planes, W not a multiple
    of 4, tiles wholly inside the image and on its border."""
    rng = np.random.default_rng(23)
    spec = specs.AdderSpec(kind, 16, 8, 4)
    shapes = [(1, 1), (1, 7), (7, 1), (2, 35, 131), (2, 66, 258),
              (1, 97, 390), (1, 100, 384)]
    for name, stages in CHAIN_CASES.items():
        route = chain_k.chain_route(chain_k.norm_stages(stages, 2))
        assert route == ("general" if name in ("same_axis", "wide")
                         else "sep2")
        for shape in shapes:
            q = torch.as_tensor(rng.integers(-2040, 2040, shape)
                                .astype(np.int32))
            for fast in (False, True):
                got = chain_k.filter_chain(q.to(cuda_device), spec, stages,
                                           fast=fast).cpu()
                want = chain_k.filter_chain_plain(q, spec, stages, fast)
                assert torch.equal(got, want), (name, shape, fast)


# ------------------------ the redesigned accumulate and conv2d_mac kernels --

def _offset_copy(x, device, offset=1):
    """``x`` on ``device`` at an address ``offset`` elements past a
    16-byte boundary (so 16-byte loads do not fit)."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("kind", specs.ALL_KINDS)
def test_accumulate_routes_on_card(cuda_device, kind):
    """The stacked entry on every route: K = 2 and 4 (their instances), K =
    1, 3 and 9 (the general one), 16-byte loads (M % 4 == 0, aligned) and
    one element a thread (ragged M, an unaligned stack), both forms."""
    rng = np.random.default_rng(31)
    spec = specs.AdderSpec(kind, 16, 8, 4)
    cases = [((2, 3, 64, 40), (2, -1), (2, 4)), ((2, 5, 7), (2, -1), (2, 1)),
             ((4, 2, 33, 64), (1, 1, 1, 1), (4, 4)),
             ((4, 1, 3), (1, 2, 3, 4), (4, 1)),
             ((9, 3, 37, 41), (1, 2, 1, -2, 4, -2, 1, 2, -1), (0, 1)),
             ((9, 2, 16), (1, 2, 1, -2, 4, -2, 1, 2, -1), (0, 4)),
             ((1, 4, 8), (3,), (0, 4)), ((3, 5), (1, 1, 1), (0, 1))]
    for shape, ws, route in cases:
        terms = torch.as_tensor(rng.integers(0, 1 << 16, shape)
                                .astype(np.int32))
        td = terms.to(cuda_device)
        m = terms[0].numel()
        assert acc_k.accumulate_route(len(ws), m, True) == route, shape
        for fast in (False, True):
            want = acc_k.accumulate_plain(terms, spec, ws, fast)
            got = acc_k.accumulate(td, spec, weights=ws, fast=fast).cpu()
            assert torch.equal(got, want), (shape, ws, fast)
            off = _offset_copy(terms, cuda_device)
            got = acc_k.accumulate(off, spec, weights=ws, fast=fast).cpu()
            assert torch.equal(got, want), (shape, ws, fast, "unaligned")


def _signed_cases(rng, device):
    """(terms on the card, weights, shift) of the signed entry: scaled_add
    shapes (aligned, W % 4 != 0), downsample2x's strided phases on odd
    H and W, blend with shift 6, K = 9, leading dims, a broadcast term
    and a transposed one."""
    def q(shape, lim=2040):
        return torch.as_tensor(rng.integers(-lim, lim, shape)
                               .astype(np.int32)).to(device)

    cases = [((q((3, 64, 40)), q((3, 64, 40))), (2, -1), 0),
             ((q((2, 9, 7)), q((2, 9, 7))), (1, 1), 0),
             ((q((2, 9, 7)), q((2, 9, 7))), (40, 24), 6)]
    for shape in ((2, 37, 71), (1, 64, 130), (3, 5, 1), (1, 1), (2, 2)):
        x = q(shape)
        h, w = shape[-2] & ~1, shape[-1] & ~1
        x = x[..., :h, :w]
        cases.append(((x[..., 0::2, 0::2], x[..., 0::2, 1::2],
                       x[..., 1::2, 0::2], x[..., 1::2, 1::2]), None, 2))
    cases.append((tuple(q((2, 3, 16, 24)) for _ in range(9)),
                  (1, 2, 1, -2, 4, -2, 1, 2, -1), 3))
    base = q((4, 32))
    cases.append(((base, q((1, 32)).expand(4, 32)), (1, 1), 1))
    cases.append(((base, q((32, 4)).t()), (3, -1), 0))
    return cases


@pytest.mark.parametrize("kind", specs.ALL_KINDS)
def test_accumulate_signed_on_card(cuda_device, kind):
    """The signed entry reads every term where it lies (views, strided
    phases, broadcast and transposed terms) and equals the plain
    composition, both forms, containers of 16 and 12 bits."""
    rng = np.random.default_rng(32)
    for n_bits, m, k in ((16, 8, 4), (12, 6, 3)):
        spec = specs.AdderSpec(kind, n_bits, m, k)
        for terms, ws, shift in _signed_cases(rng, cuda_device):
            for fast in (False, True):
                got = acc_k.accumulate_signed(terms, spec, n_bits,
                                              weights=ws, shift=shift,
                                              fast=fast).cpu()
                want = acc_k.accumulate_signed_plain(
                    tuple(t.cpu() for t in terms), spec, n_bits, ws, shift,
                    fast)
                assert torch.equal(got, want), (tuple(terms[0].shape), ws,
                                                shift, fast)


def test_accumulate_entry_refuses_a_bad_route(cuda_device):
    """The C entry checks the route it is given: a K instance that is not
    K, 16-byte loads on a ragged row, an unaligned term or a strided
    one, and a rounding shift on the unsigned entry are refused with
    cudaErrorInvalidValue."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.approx_add import adder_args, stream_ptr
    spec = specs.AdderSpec("haloc_axa", 16, 8, 4)
    fn = _build.bind("accumulate", "accumulate_launch", acc_k._ARGTYPES)
    buf = torch.zeros(4 * 64 + 4, dtype=torch.int32, device=cuda_device)
    out = torch.empty(64, dtype=torch.int32, device=cuda_device)

    def launch(ptrs, strides, width, kt, vec, bits=0, shift=0):
        k = len(ptrs)
        bases = (ctypes.c_void_p * k)(*ptrs)
        flat = (ctypes.c_longlong * (3 * k))(*(s for st in strides
                                                for s in st))
        wts = (ctypes.c_uint * k)(*([1] * k))
        err = fn(ctypes.cast(bases, ctypes.c_void_p),
                 ctypes.cast(flat, ctypes.c_void_p), out.data_ptr(), 1, 1,
                 width, k, ctypes.cast(wts, ctypes.c_void_p), bits, shift,
                 kt, vec, *adder_args(spec, False), stream_ptr(cuda_device))
        torch.cuda.synchronize(cuda_device)
        return err

    p = buf.data_ptr()
    flat2 = [(0, 0, 1)] * 2
    invalid = 1  # cudaErrorInvalidValue
    assert launch([p, p + 256], flat2, 64, 4, 4) == invalid
    assert launch([p, p + 256, p + 512], [(0, 0, 1)] * 3, 64, 2, 4) == invalid
    assert launch([p, p + 256], flat2, 62, 2, 4) == invalid
    assert launch([p + 4, p + 256], flat2, 60, 2, 4) == invalid
    assert launch([p, p + 256], [(0, 0, 2), (0, 0, 1)], 32, 2, 4) == invalid
    assert launch([p, p + 256], flat2, 64, 2, 1, 0, 2) == invalid
    assert launch([p, p + 256], flat2, 64, 2, 4) == 0
    assert launch([p + 4, p + 256], flat2, 60, 0, 1, 16, 2) == 0


def _kernel_launches(fn):
    """CUDA kernels ``fn()`` launches, counted by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA)


def test_scaled_add_and_accumulate_signed_are_one_launch(cuda_device):
    """On the cuda backend the signed fold is one kernel: no stack, mask,
    sign-extension or rounding kernel around it (sharpen's scaled_add and
    downsample2x's strided phases)."""
    from repro_torch.ax import make_engine
    from repro_torch.numerics.fixed_point import FixedPointFormat
    rng = np.random.default_rng(33)
    eng = make_engine("haloc_axa", fmt=FixedPointFormat(16, 3))
    x, y = (torch.as_tensor(rng.integers(-2040, 2040, (2, 64, 96))
                            .astype(np.int32)).to(cuda_device)
            for _ in range(2))
    phases = (x[..., 0::2, 0::2], x[..., 0::2, 1::2], x[..., 1::2, 0::2],
              x[..., 1::2, 1::2])
    assert _kernel_launches(lambda: eng.scaled_add(x, y, 2, -1)) == 1
    assert _kernel_launches(
        lambda: eng.accumulate_signed(phases, shift=2)) == 1
    cpu = make_engine("haloc_axa", fmt=FixedPointFormat(16, 3),
                      backend="torch", device="cpu")
    assert torch.equal(eng.scaled_add(x, y, 2, -1).cpu(),
                       cpu.scaled_add(x.cpu(), y.cpu(), 2, -1))
    assert torch.equal(eng.accumulate_signed(phases, shift=2).cpu(),
                       cpu.accumulate_signed(tuple(p.cpu() for p in phases),
                                             shift=2))


@pytest.mark.parametrize("kind", specs.ALL_KINDS)
def test_conv2d_mac_routes_on_card(cuda_device, kind):
    """Every route: 3 x 3 and 5 x 5 instances with tables in shared
    memory (5 x 5 at w = 8 is past 48 KB; at w = 10 200 KiB), the general
    instance with tables in shared memory (1 x 1, 3 x 5) and in global
    memory (5 x 5 at w = 11, 7 x 7 at w = 10); interior and border tiles,
    W % 4 != 0, an unaligned input, shift 0 and 3, n16 and n32."""
    from repro_torch.ax.mul import MulSpec
    from repro_torch.kernels import conv2d_mac as conv_k
    rng = np.random.default_rng(34)

    def kern(kh, kw, lim):
        return tuple(tuple(int(x) for x in row)
                     for row in rng.integers(-lim, lim + 1, (kh, kw)))

    cases = [(MulSpec("truncated", 8, 3), kern(3, 3, 9), (3, "shared")),
             (MulSpec("truncated", 8, 3), kern(5, 5, 9), (5, "shared")),
             (MulSpec("mitchell", 10), kern(5, 5, 20), (5, "shared")),
             (MulSpec("mitchell", 11), kern(5, 5, 20), (0, "global")),
             (MulSpec("truncated", 8, 3), kern(1, 1, 9), (0, "shared")),
             (MulSpec("broken_array", 8, 3, 1), kern(3, 5, 9), (0, "shared")),
             (MulSpec("mitchell", 10), kern(7, 7, 9), (0, "global"))]
    shapes = [(1, 1), (70, 5), (2, 150, 100), (1, 200, 131)]
    for n_bits, m, k in ((16, 8, 4), (32, 10, 5)):
        spec = specs.AdderSpec(kind, n_bits, m, k)
        for ms, kernel, route in cases:
            assert conv_k.conv_route(len(kernel), len(kernel[0]),
                                     1 << ms.n_bits) == route
            lim = (1 << ms.n_bits) - 1
            for shape in shapes:
                qc = torch.as_tensor(rng.integers(-lim, lim + 1, shape)
                                     .astype(np.int32))
                for shift in (0, 3):
                    want = conv_k.conv2d_mac_plain(qc, spec, ms, kernel,
                                                   shift)
                    got = conv_k.conv2d_mac(qc.to(cuda_device), spec, ms,
                                            kernel, shift=shift,
                                            fast=True).cpu()
                    assert torch.equal(got, want), (ms, route, shape, shift)
            qc = torch.as_tensor(rng.integers(-lim, lim + 1, (2, 150, 100))
                                 .astype(np.int32))
            got = conv_k.conv2d_mac(_offset_copy(qc, cuda_device), spec, ms,
                                    kernel).cpu()
            assert torch.equal(got, conv_k.conv2d_mac_plain(qc, spec, ms,
                                                            kernel))


def test_conv2d_mac_entry_refuses_a_bad_route(cuda_device):
    """The C entry checks the route it is given: an instance of another
    size, tables in shared memory past what a block may have, and a
    sized instance without staged tables are refused with
    cudaErrorInvalidValue."""
    from repro_torch.ax.mul import MulSpec
    from repro_torch.kernels import _build
    from repro_torch.kernels import conv2d_mac as conv_k
    from repro_torch.kernels.approx_add import adder_args, stream_ptr
    spec = specs.AdderSpec("haloc_axa", 16, 8, 4)
    fn = _build.bind("conv2d_mac", "conv2d_mac_launch", conv_k._ARGTYPES)
    q = torch.zeros((64, 64), dtype=torch.int32, device=cuda_device)
    out = torch.empty_like(q)
    k3 = ((1, 3, 1), (3, 5, 3), (1, 3, 1))
    tabs = conv_k.signed_tap_tables(MulSpec("truncated", 8, 3),
                                    sum(k3, ()), 16, cuda_device)

    def launch(kh, kw, entries, shape, smem):
        err = fn(q.data_ptr(), tabs.data_ptr(), out.data_ptr(), 1, 64, 64,
                 kh, kw, entries, 0, shape, smem, *adder_args(spec, False),
                 stream_ptr(cuda_device))
        torch.cuda.synchronize(cuda_device)
        return err

    invalid = 1  # cudaErrorInvalidValue
    assert launch(3, 3, 256, 5, 1) == invalid
    assert launch(3, 5, 256, 3, 1) == invalid
    assert launch(5, 5, 2048, 5, 1) == invalid
    assert launch(3, 3, 256, 3, 0) == invalid
    assert launch(3, 3, 256, 3, 1) == 0
    assert launch(3, 3, 256, 0, 0) == 0


# ------------------------ the one-launch FFT axis and the shared-table GEMM --

def _fft_layouts():
    """(name, shape, layout): the last axis at n = 2 ... 4096, and the row
    and column axes of (2, 48, 64) planes in 16 x 16 tiles read in place
    (48 = three tiles: an inner count that is not a power of two) and of
    whole (2, 32, 64) planes."""
    from repro_torch.image.fft import image_layouts
    from repro_torch.kernels.butterfly import last_axis_layout
    out = [(f"last n={n}", (max(8192 // n, 3), n),
            last_axis_layout((max(8192 // n, 3), n)))
           for n in (2, 4, 8, 16, 64, 512, 4096)]
    for block, shape in ((16, (2, 48, 64)), (None, (2, 32, 64))):
        rows, cols = image_layouts(shape, block)
        out += [(f"rows block={block}", shape, rows),
                (f"cols block={block}", shape, cols)]
    return out


@pytest.mark.parametrize("kind", specs.ALL_KINDS)
def test_fft_axis_on_card(cuda_device, kind):
    """The one-launch axis kernel against its plain version (on the CPU)
    and against the per-stage kernel chained on the card, every layout,
    forward and inverse, both forms, full-range int32 values, out of
    place and in place."""
    from repro_torch.kernels.butterfly import fft_stages
    spec = specs.AdderSpec(kind, 32, 10, 5)
    rng = np.random.default_rng(41)
    for name, shape, layout in _fft_layouts():
        re, im = (torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, shape)
                                  .astype(np.int32)) for _ in range(2))
        for inverse in (False, True):
            for fast in (False, True):
                want = bf_k.fft_axis_plain(re, im, layout, spec,
                                           inverse=inverse, fast=fast)
                dre, dim = re.to(cuda_device), im.to(cuda_device)
                got = bf_k.fft_axis(dre, dim, layout, spec, inverse=inverse,
                                    fast=fast)
                for g, w in zip(got, want):
                    assert torch.equal(g.cpu(), w), (name, inverse, fast)
                rows = [layout.view(x).reshape(-1, layout.n)
                        for x in (dre, dim)]
                staged = fft_stages(*rows, inverse, lambda *p: bf_k.butterfly(
                    *p, spec, inverse=inverse, fast=fast))
                for g, w in zip(got, staged):
                    assert torch.equal(layout.view(g).reshape(-1, layout.n),
                                       w), (name, "per-stage route")
                bf_k.fft_axis(dre, dim, layout, spec, inverse=inverse,
                              fast=fast, out=(dre, dim))
                assert torch.equal(dre.cpu(), want[0]), (name, "in place")
                assert torch.equal(dim.cpu(), want[1]), (name, "in place")


def test_fft_routes_on_card(cuda_device):
    """reconstruct at N = 32 is four axis launches and no per-stage one;
    a transform past the axis kernel's length takes the per-stage kernel
    (13 stages at n = 8192); both equal the CPU path."""
    from repro_torch.image.fft import FixedFFTConfig, fft_fixed, to_fixed
    from repro_torch.image.pipeline import reconstruct, synthetic_image
    img = synthetic_image(64)
    spec = specs.paper_spec("haloc_axa")
    bf_k.fft_axis.launches = bf_k.butterfly.launches = 0
    got = reconstruct(img, spec)
    assert (bf_k.fft_axis.launches, bf_k.butterfly.launches) == (4, 0)
    assert torch.equal(got.cpu(), reconstruct(img, spec, backend="torch",
                                              device="cpu"))
    rng = np.random.default_rng(42)
    x = rng.uniform(-200, 200, (2, 8192))
    cfg = FixedFFTConfig(spec=spec)
    cpu = FixedFFTConfig(spec=spec, backend="torch", device="cpu")
    for inverse in (False, True):
        bf_k.fft_axis.launches = bf_k.butterfly.launches = 0
        got = fft_fixed(to_fixed(x, cfg), to_fixed(-x, cfg), cfg, inverse)
        assert (bf_k.fft_axis.launches, bf_k.butterfly.launches) == (0, 13)
        want = fft_fixed(to_fixed(x, cpu), to_fixed(-x, cpu), cpu, inverse)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_fft_axis_entry_refuses_a_bad_layout(cuda_device):
    """The C entry refuses what one block cannot hold (n x T past 4096
    elements) and a bad divider shift; the wrapper refuses a layout that
    reaches past the tensor and a transform longer than 4096."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.approx_add import adder_args, stream_ptr
    spec = specs.paper_spec("haloc_axa")
    fn = _build.bind("butterfly", "butterfly_axis_launch",
                     bf_k._AXIS_ARGTYPES)
    x = torch.zeros(8192, dtype=torch.int32, device=cuda_device)
    w_re, w_im = bf_k.axis_twiddles(4096, False, cuda_device)

    def launch(log_n, log_per_block, shift=0):
        err = fn(x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(), 1,
                 0, 0, 1, 1, 1, shift, log_n, log_per_block, 0,
                 w_re.data_ptr(), w_im.data_ptr(), *adder_args(spec, True),
                 0, stream_ptr(cuda_device))
        torch.cuda.synchronize(cuda_device)
        return err

    invalid = 1  # cudaErrorInvalidValue
    assert launch(13, 0) == invalid
    assert launch(11, 2) == invalid
    assert launch(12, 0, shift=32) == invalid
    assert launch(0, 0) == invalid
    assert launch(12, 0) == 0
    with pytest.raises(ValueError, match="reaches element"):
        bf_k.fft_axis(x, x, bf_k.AxisLayout(4096, 3, 1, 4096, 0, 1), spec)
    with pytest.raises(ValueError, match="power of two"):
        bf_k.fft_axis(x, x, bf_k.AxisLayout(8192, 1, 1, 8192, 0, 1), spec)


@pytest.mark.parametrize("n_bits,m,k", [(32, 10, 5), (16, 8, 4)])
def test_mac_matmul_routes_on_card(cuda_device, n_bits, m, k):
    """Both table routes against the plain version: the shared int16 table
    for every 8-bit multiplier kind, the global int32 one at w = 10;
    ragged K, bk 1, 33 and 128, M and N off the 64 grid, every adder
    kind, both forms."""
    from repro_torch.ax.mul import MulSpec, lut, registered_multipliers
    from repro_torch.kernels import mac_matmul as mac_k
    rng = np.random.default_rng(43)
    muls = [MulSpec(kind, 8, 3, 2 if kind == "broken_array" else 0)
            for kind in registered_multipliers()]
    muls += [MulSpec("truncated", 10, 4), MulSpec("mitchell", 10)]
    cases = [((70, 300), (300, 130), 128), ((33, 257), (257, 65), 33),
             ((65, 40), (40, 63), 1), ((128, 96), (96, 128), 128)]
    for ms in muls:
        w = ms.n_bits
        route = mac_k.mac_route(w, lut.signed_table_fits_int16(ms))
        assert route == ("shared" if w <= 8 else "global")
        lim = 1 << (w - 1)
        for kind in specs.ALL_KINDS:
            spec = specs.AdderSpec(kind, n_bits, m, k)
            for sa, sb, bk in cases:
                a = torch.as_tensor(rng.integers(-lim, lim, sa)
                                    .astype(np.int32))
                b = torch.as_tensor(rng.integers(-lim, lim, sb)
                                    .astype(np.int32))
                for fast in (False, True):
                    got = mac_k.mac_matmul(a.to(cuda_device),
                                           b.to(cuda_device), spec, ms,
                                           bk=bk, fast=fast).cpu()
                    assert torch.equal(got, mac_k.mac_matmul_plain(
                        a, b, spec, ms, bk, fast)), (ms, kind, sa, bk)


@pytest.mark.parametrize("strategy", ["reference", "fused", "lut"])
def test_cuda_backend_broadcasts_like_torch(cuda_device, strategy):
    """add, add_signed, mul and mul_signed broadcast their operands on the
    card as the torch backend does (a (3, 4) tensor with a (4,) one)."""
    from repro_torch.ax import make_engine
    from repro_torch.numerics.fixed_point import FixedPointFormat
    a = (torch.arange(12, dtype=torch.int32).reshape(3, 4) * 1000)
    b = torch.arange(4, dtype=torch.int32) * 777
    for spec, fmt in ((specs.AdderSpec("haloc_axa", 16, 8, 4),
                       FixedPointFormat(16, 6)),
                      (specs.paper_spec("haloc_axa"), None)):
        gpu = make_engine(spec, fmt=fmt, mul="truncated", strategy=strategy)
        cpu = make_engine(spec, fmt=fmt, mul="truncated", strategy=strategy,
                          backend="torch", device="cpu")
        assert torch.equal(gpu.add(a, b).cpu(), cpu.add(a, b))
        assert torch.equal(gpu.add(b, a).cpu(), cpu.add(b, a))
        assert torch.equal(gpu.mul(a % 256, b % 256).cpu(),
                           cpu.mul(a % 256, b % 256))
        assert torch.equal(gpu.mul_signed(a % 128 - 64, 64 - b % 128).cpu(),
                           cpu.mul_signed(a % 128 - 64, 64 - b % 128))
        if fmt is not None:
            assert torch.equal(gpu.add_signed(a - 6000, b).cpu(),
                               cpu.add_signed(a - 6000, b))
    eng = make_engine(specs.AdderSpec("haloc_axa", 16, 8, 4),
                      strategy=strategy)
    assert int(eng.add(a, b)[0, 0]) == 15
    with pytest.raises(RuntimeError):
        eng.add(a, torch.arange(3, dtype=torch.int32))


def test_cuda_conv2d_refuses_int64_past_2_31(cuda_device):
    """An int64 input at 2^32 + 1 would wrap to 1 in int32: the
    cuda backend checks |q| < 2^w before the cast and raises the numpy
    backend's message, as the torch backend does."""
    from repro_torch.ax import make_engine
    from repro_torch.numerics.fixed_point import FixedPointFormat
    q = torch.tensor([[1, (1 << 32) + 1], [2, 3]], dtype=torch.int64)
    kernel = ((1, 3, 1), (3, -5, 3), (1, 3, 1))
    for where in (dict(), dict(backend="torch", device="cpu")):
        eng = make_engine("haloc_axa", fmt=FixedPointFormat(16, 0),
                          mul="truncated", **where)
        with pytest.raises(ValueError, match="2\\^8"):
            eng.conv2d(q, kernel)


# -------------------------------- Table 1 and the Fig-6 design space --

def test_exact_sweep_on_the_card_equals_the_cpu(cuda_device):
    from repro_torch.ax import analytics as an
    from repro_torch.core import hwcost
    specs = an.design_space((8, 16, 32), max_lsm=12)[::5]
    for cache in (False, True):
        assert an.exact_error_metrics_sweep(specs, cache_tables=cache,
                                            device=cuda_device) == \
            an.exact_error_metrics_sweep(specs, cache_tables=cache,
                                         device="cpu")
    for spec in specs[::7]:
        assert hwcost.report(spec, device=cuda_device) == \
            hwcost.report(spec, device="cpu")
    muls = an.mul_design_space((8,))
    assert an.exact_mul_error_metrics_sweep(muls, device=cuda_device) == \
        an.exact_mul_error_metrics_sweep(muls, device="cpu")


@pytest.mark.parametrize("strategy", ["reference", "lut"])
def test_monte_carlo_sweep_on_the_card_equals_the_cpu(cuda_device,
                                                      strategy):
    from repro_torch.core import metrics
    sweep = list(specs.table1_specs())
    card = metrics.simulate_error_metrics_sweep(
        sweep, n_samples=300_000, chunk=110_000, strategy=strategy,
        device=cuda_device)
    cpu = metrics.simulate_error_metrics_sweep(
        sweep, n_samples=300_000, chunk=110_000, strategy=strategy,
        device="cpu")
    for g, w in zip(card, cpu):
        assert (g.med, g.nmed, g.error_rate, g.wce) == \
            (w.med, w.nmed, w.error_rate, w.wce)
        assert g.mred == w.mred


@pytest.mark.parametrize("strategy", ["reference", "lut"])
def test_sum_on_the_card_is_one_launch_a_level(cuda_device, strategy):
    from repro_torch.ax import make_engine
    from repro_torch.numerics.fixed_point import FixedPointFormat
    fmt = FixedPointFormat(16, 8)
    spec = specs.AdderSpec("haloc_axa", 16, 8, 4)
    q = torch.as_tensor(np.random.default_rng(3).integers(
        fmt.min_int, fmt.max_int + 1, (4, 33, 100)).astype(np.int32))
    counted = lut_k.lut_add if strategy == "lut" else add_k.approx_add
    counted.launches = 0
    got = make_engine(spec, fmt=fmt, strategy=strategy,
                      device=cuda_device).sum(q, axis=-1)
    assert counted.launches == 7
    want = make_engine(spec, fmt=fmt, strategy=strategy, backend="torch",
                       device="cpu").sum(q, axis=-1)
    assert torch.equal(got.cpu(), want)


_FAULTS = (("stuck_at_0", (11,), 1.0), ("stuck_at_1", (3, 11), 1.0),
           ("bit_flip", (3, 11), 2 ** -5), ("bit_flip", (0, 15), 1.0))


@pytest.mark.parametrize("kind,bits,rate", _FAULTS)
def test_faulted_cuda_engine_equals_torch_on_the_card(cuda_device, kind,
                                                      bits, rate):
    """Each fault kind on the cuda engine's add, accumulate, scaled_add
    (the unfused signed fold: the stacked accumulate launch) and
    filter_chain equals the torch backend on the card; a healthy engine
    keeps the one-launch signed fold."""
    from repro_torch.ax import make_engine
    from repro_torch.numerics.fixed_point import FixedPointFormat
    from repro_torch.resilience.faults import FaultSpec
    fault = FaultSpec(kind, bits, rate=rate, seed=5)
    fmt = FixedPointFormat(16, 3)
    spec = specs.AdderSpec("haloc_axa", 16, 8, 4)
    card = make_engine(spec, fmt=fmt, device=cuda_device, fault=fault)
    ref = make_engine(spec, fmt=fmt, backend="torch", device=cuda_device,
                      fault=fault)
    rng = np.random.default_rng(8)
    u = torch.as_tensor(rng.integers(0, 1 << 16, (3, 2, 37, 41)).astype(
        np.int32), device=cuda_device)
    q = torch.as_tensor(rng.integers(-2000, 2000, (2, 37, 41)).astype(
        np.int32), device=cuda_device)
    stages = (FilterStage(-1, (-1, 0, 1), (1, 2, 1), 2),
              FilterStage(-2, (-1, 0, 1), (1, 2, 1), 2))
    acc_k.accumulate.launches = 0
    pairs = ((card.add(u[0], u[1]), ref.add(u[0], u[1])),
             (card.accumulate(u, (3, -1, 2)), ref.accumulate(u, (3, -1, 2))),
             (card.scaled_add(q, q.flip(-1), 2, -1, shift=1),
              ref.scaled_add(q, q.flip(-1), 2, -1, shift=1)),
             (card.filter_chain(q, stages), ref.filter_chain(q, stages)))
    assert acc_k.accumulate.launches == 2
    for got, want in pairs:
        assert got.device.type == "cuda" and torch.equal(got, want)
    healthy = make_engine(spec, fmt=fmt, device=cuda_device)
    acc_k.accumulate.launches = 0
    healthy.scaled_add(q, q.flip(-1), 2, -1, shift=1)
    assert acc_k.accumulate.launches == 1


@pytest.mark.parametrize("requant", ["stage", "fused"])
def test_streaming_depth2_equals_sequential_on_the_card(cuda_device,
                                                        requant):
    from repro_torch.imgproc import run_streaming
    pipe = compile_pipeline(PIPELINES["pipe_blur_sharpen_down"],
                            requant=requant, device=cuda_device)
    batches = [synthetic_batch(2, 96, seed=s) for s in range(5)]
    seq = [pipe(b).cpu().numpy() for b in batches]
    for depth in (1, 2):
        r = run_streaming(pipe, batches, depth=depth)
        assert r.failed == r.retried == r.degraded == ()
        for got, want in zip(r.outputs, seq):
            np.testing.assert_array_equal(got, want)


# ------------------------------------------- integrity and serving --

def test_device_copies_hash_as_their_host_tables_on_card(cuda_device):
    """Every device copy a kernel gathers from is a golden entry whose
    digest, read back from the card, equals its host table's."""
    from repro_torch.ax import lut as lut_lib
    from repro_torch.ax.mul import lut as mul_lut
    from repro_torch.ax.mul.specs import MulSpec
    from repro_torch.integrity import (golden_digest, golden_entries,
                                       table_digest, verify_entry)
    from repro_torch.kernels.conv2d_mac import signed_tap_tables
    dev = torch.device("cuda", torch.cuda.current_device())
    spec = specs.AdderSpec("haloc_axa", 32, 10, 5)
    ms = MulSpec("truncated", 8, 3)
    w = (1, 2, 1, 2, -4, 2, 1, 2, 1)
    lut_lib.device_table(spec, dev)
    lut_lib.device_abs_error_table(spec, dev)
    mul_lut.device_mul_table(ms, dev)
    mul_lut.device_signed_table(ms, dev)
    mul_lut.device_signed_table16(ms, dev)
    mul_lut.device_tap_tables(ms, w, dev)
    signed_tap_tables(ms, w, 16, dev)
    canon, mc = lut_lib._canonical(spec), mul_lut._canonical(ms)
    host = {"ax.lut.device": ("ax.lut.packed", (canon,)),
            "ax.lut.device_abs_error": ("ax.lut.abs_error", (canon,)),
            "ax.mul.lut.device": ("ax.mul.lut.product", (mc,)),
            "ax.mul.lut.device_signed": ("ax.mul.lut.signed", (mc,)),
            "ax.mul.lut.device_signed16": ("ax.mul.lut.signed", (mc,)),
            "ax.mul.lut.device_taps": ("ax.mul.lut.taps", (mc, w))}
    seen = set()
    for e in golden_entries():
        if not isinstance(e.table, torch.Tensor) or e.table.device != dev:
            continue
        assert verify_entry(e), e.cache
        if e.cache in host and e.key[0] in (canon, mc):
            assert e.digest == golden_digest(*host[e.cache]), e.cache
            assert table_digest(e.table, e.pattern) == e.digest
            seen.add(e.cache)
    assert seen == set(host)


def test_corrupted_device_table_repaired_in_place_on_card(cuda_device):
    """A flip burned into the device table ``lut_add`` gathers from
    changes the kernel's output; the scrubber finds it there, repairs it
    in place (``copy_``), and the next launch gathers the repaired
    data."""
    from repro_torch.ax import lut as lut_lib
    from repro_torch.integrity import LutScrubber
    dev = torch.device("cuda", torch.cuda.current_device())
    spec = specs.AdderSpec("haloc_axa", 16, 8, 4)
    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.integers(0, 1 << 16, 1 << 16).astype(np.int32))
    b = torch.as_tensor(rng.integers(0, 1 << 16, 1 << 16).astype(np.int32))
    want = lut_k.lut_add_plain(a, b, spec)
    live = lut_lib.device_table(spec, dev)
    ptr = live.data_ptr()
    ad, bd = a.to(dev), b.to(dev)
    assert torch.equal(lut_k.lut_add(ad, bd, spec).cpu(), want)
    live.view(-1)[:256] ^= 1 << 3                 # a_low = 0, every b_low
    bad = lut_k.lut_add(ad, bd, spec).cpu()
    assert not torch.equal(bad, want)
    report = LutScrubber(cache="ax.lut.device").scrub_once(0.0)
    key = repr((lut_lib._canonical(spec), dev))
    assert ("ax.lut.device", key) in report.corrupted
    assert ("ax.lut.device", key) in report.repaired
    assert live.data_ptr() == ptr                 # in place
    launches = lut_k.lut_add.launches
    assert torch.equal(lut_k.lut_add(ad, bd, spec).cpu(), want)
    assert lut_k.lut_add.launches == launches + 1


def test_device_abs_error_high_bit_flip_repaired_on_card(cuda_device):
    """A flip in bit 20 of the int32 ``device_abs_error`` copy on the
    card (no value of its uint16 pattern) fails the digest; the scrubber
    reports it and repairs it in place."""
    from repro_torch.ax import lut as lut_lib
    from repro_torch.integrity import LutScrubber
    dev = torch.device("cuda", torch.cuda.current_device())
    spec = specs.AdderSpec("haloc_axa", 16, 8, 4)
    live = lut_lib.device_abs_error_table(spec, dev)
    healthy, ptr = live.clone(), live.data_ptr()
    live.view(-1)[1234] ^= 1 << 20
    report = LutScrubber(cache="ax.lut.device_abs_error").scrub_once(0.0)
    label = ("ax.lut.device_abs_error", repr((lut_lib._canonical(spec), dev)))
    assert label in report.corrupted and label in report.repaired
    assert live.data_ptr() == ptr and torch.equal(live, healthy)


def test_abft_checksums_on_card_equal_the_cpu(cuda_device):
    """ABFT's int64 checksums, flags, budgets and exact repairs on the
    card equal the CPU path's, for both GEMM paths and conv2d."""
    from repro_torch.ax import make_engine
    from repro_torch.integrity import AbftChecker
    from repro_torch.numerics.fixed_point import FixedPointFormat
    rng = np.random.default_rng(7)
    a = rng.integers(-128, 128, (96, 160)).astype(np.int8)
    b = rng.integers(-128, 128, (160, 72)).astype(np.int8)
    q = rng.integers(-255, 256, (3, 40, 52)).astype(np.int32)
    kernel = ((1, 3, 1), (3, -5, 3), (1, 3, 1))

    def verdicts(device, backend):
        kw = dict(backend=backend, device=device)
        out = []
        for mul in (None, "truncated"):
            eng = make_engine("haloc_axa", mul=mul, **kw)
            ck = AbftChecker(eng)
            out.append(ck.matmul(a, b, block=(64, 64, 64)))
            o = eng.matmul(a, b, block=(64, 64, 64)).clone()
            o[:, 7] ^= 1 << 19
            o[11, :] |= 1 << 21
            out.append(ck.verify_matmul(o, a, b, block=(64, 64, 64)))
        eng = make_engine(specs.AdderSpec("haloc_axa", 16, 8, 4),
                          fmt=FixedPointFormat(16, 0), mul="truncated", **kw)
        ck = AbftChecker(eng)
        out.append(ck.conv2d(q, kernel, shift=2))
        o = eng.conv2d(q, kernel, shift=2).clone()
        o[1] |= 1 << 12
        out.append(ck.verify_conv2d(o, q, kernel, shift=2))
        return out

    got = verdicts(cuda_device, "cuda")
    want = verdicts("cpu", "torch")
    for g, w in zip(got, want):
        assert g.out.device.type == "cuda"
        assert torch.equal(g.out.cpu(), w.out)
        assert (g.ok, g.flagged_rows, g.flagged_cols, g.max_deviation,
                g.budget) == (w.ok, w.flagged_rows, w.flagged_cols,
                              w.max_deviation, w.budget)
    assert [v.ok for v in got] == [True, False, True, False, True, False]


def test_canary_and_plan_executor_on_card_equal_the_cpu(cuda_device):
    """Canary reports of healthy and faulted engines on the card equal
    the CPU path's, and a PlanExecutor on the card serves the torch CPU
    executor's outputs."""
    from repro_torch import serving as sv
    from repro_torch.ax import make_engine
    from repro_torch.integrity import CanarySuite
    from repro_torch.resilience.faults import FaultSpec
    for kw in (dict(strategy="lut"), dict(strategy="reference"),
               dict(mul="truncated"),
               dict(strategy="lut", fault=FaultSpec("stuck_at_1", (13,)))):
        card = CanarySuite(make_engine("haloc_axa", **kw), n=512)
        cpu = CanarySuite(make_engine("haloc_axa", backend="torch",
                                      device="cpu", **kw), n=512)
        g, w = card.run_once(0.0), cpu.run_once(0.0)
        assert (g.checked, g.add_mismatches, g.mul_mismatches) == \
            (w.checked, w.add_mismatches, w.mul_mismatches), kw
        assert g.ok == ("fault" not in kw)
    imgs = synthetic_batch(3, 48, 2)
    card = sv.PlanExecutor.compile(("pipe_blur_sharpen_down",
                                    "pipe_blur_sobel"))
    cpu = sv.PlanExecutor.compile(("pipe_blur_sharpen_down",
                                   "pipe_blur_sobel"),
                                  backend="torch", device="cpu")
    for name in ("pipe_blur_sharpen_down", "pipe_blur_sobel"):
        got = card(imgs, name)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, cpu(imgs, name))


def test_detection_campaign_quick_on_card_equals_the_cpu(cuda_device):
    from repro_torch.resilience.harness import detection_campaign
    got = detection_campaign(quick=True, backend="cuda")
    want = detection_campaign(quick=True, backend="torch")
    assert [dict(r, backend="") for r in got] == \
        [dict(r, backend="") for r in want]
    assert all(r["backend"] == "cuda" for r in got)
