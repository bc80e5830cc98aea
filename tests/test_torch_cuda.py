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
from repro_torch.kernels import conv_chain as chain_k

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
