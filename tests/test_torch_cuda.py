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
