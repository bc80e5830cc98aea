"""The port's deprecated kernel shims (``repro_torch.kernels.ops``)
against ``repro.kernels.ops``'s, on the CPU (``backend="torch",
device="cpu"``): each call warns ``DeprecationWarning`` exactly once,
naming ``repro_torch.ax.make_engine`` and MIGRATION.md (caught here
explicitly), and returns what the reference's shim returns, bit for bit;
without a card the default raises."""

import warnings

import numpy as np
import pytest
import torch

from repro.core.specs import paper_spec as ref_paper_spec
from repro.kernels import ops as ref_ops
from repro_torch.core.specs import paper_spec
from repro_torch.kernels import ops

CPU = {"backend": "torch", "device": "cpu"}


def _one_deprecation_per_call(fn):
    """Run ``fn`` twice; each call must warn exactly once."""
    for _ in range(2):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = fn()
        dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
        assert len(dep) == 1, [str(w.message) for w in rec]
        msg = str(dep[0].message)
        assert "deprecated" in msg and "MIGRATION.md" in msg
        assert "repro_torch.ax.make_engine" in msg
    return out


def _reference(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn()


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n_bits,m,k", [(16, 8, 4), (32, 10, 5)])
def test_approx_add_shim_warns_once_and_equals_reference(n_bits, m, k):
    rng = np.random.default_rng(n_bits)
    a, b = (rng.integers(0, 1 << min(n_bits, 31), (8, 8)).astype(np.int32)
            for _ in range(2))
    spec = paper_spec("haloc_axa", n_bits, m, k)
    got = _one_deprecation_per_call(lambda: ops.approx_add(a, b, spec, **CPU))
    want = _reference(lambda: ref_ops.approx_add(
        a, b, ref_paper_spec("haloc_axa", n_bits, m, k)))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_approx_matmul_shim_warns_once_and_equals_reference():
    rng = np.random.default_rng(3)
    a8 = rng.integers(-128, 128, (16, 24)).astype(np.int8)
    b8 = rng.integers(-128, 128, (24, 8)).astype(np.int8)
    got = _one_deprecation_per_call(lambda: ops.approx_matmul(
        a8, b8, paper_spec("haloc_axa"), block=(8, 8, 8), **CPU))
    want = _reference(lambda: ref_ops.approx_matmul(
        a8, b8, ref_paper_spec("haloc_axa"), block=(8, 8, 8)))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("inverse", [False, True])
def test_butterfly_shim_warns_once_and_equals_reference(inverse):
    rng = np.random.default_rng(int(inverse))
    rows, half = 4, 8
    planes = [rng.integers(-(1 << 20), 1 << 20, (rows, half)).astype(np.int32)
              for _ in range(4)]
    w = [rng.integers(-(1 << 14), 1 << 14, half).astype(np.int32)
         for _ in range(2)]
    got = _one_deprecation_per_call(lambda: ops.butterfly(
        *planes, *w, paper_spec("haloc_axa"), inverse, **CPU))
    want = _reference(lambda: ref_ops.butterfly(
        *planes, *w, ref_paper_spec("haloc_axa"), inverse))
    for g, r in zip(got, want, strict=True):
        np.testing.assert_array_equal(_np(g), np.asarray(r))


def test_shims_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.zeros((2, 2), np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ops.approx_add(a, a, paper_spec("haloc_axa"))
