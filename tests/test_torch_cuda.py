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
