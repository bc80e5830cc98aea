"""The port's adder models against the reference's, bit for bit.

``repro_torch.core.adders`` is a copy of the operators-only models; on
torch int64 lanes it must equal ``repro``'s numpy uint64 evaluation for
every registered kind, every valid (m, k) and both forms — exhaustive at
N=8, random at N=16 and N=32.  The lane helpers and the exact weight
scaling of the plain kernels are held against the reference's uint32
forms.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import adders as adders_j
from repro.core import specs as specs_j
from repro.kernels.accumulate import scale_mod_u32
from repro_torch.core import adders as adders_t
from repro_torch.core import specs as specs_t
from repro_torch.kernels.accumulate import scale_mod
from repro_torch.kernels.approx_add import (approx_add_plain, to_int32,
                                            u32_lanes)


def _valid_mk(kind, n_bits):
    """Every (m, k) the spec validation admits at width ``n_bits``."""
    out = []
    for m in range(1, n_bits + 1):
        for k in range(0, m + 1):
            try:
                specs_t.AdderSpec(kind, n_bits, m, k)
            except ValueError:
                continue
            out.append((m, k))
    return out


def test_kind_registries_agree():
    assert specs_t.ALL_KINDS == specs_j.ALL_KINDS
    assert specs_t.TABLE1_KINDS == specs_j.TABLE1_KINDS
    assert specs_t.CONST_KINDS == specs_j.CONST_KINDS
    for kind in specs_t.ALL_KINDS:
        assert _valid_mk(kind, 8) == [
            (s.lsm_bits, s.const_bits) for s in
            (specs_j.AdderSpec(kind, 8, m, k) for m, k in _valid_mk(kind, 8))]


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("kind", specs_j.ALL_KINDS)
def test_approx_add_mod_exhaustive_n8(kind, fast):
    a_np, b_np = np.meshgrid(np.arange(256, dtype=np.uint64),
                             np.arange(256, dtype=np.uint64), indexing="ij")
    a_t = torch.as_tensor(a_np.astype(np.int64))
    b_t = torch.as_tensor(b_np.astype(np.int64))
    cells = _valid_mk(kind, 8)
    assert cells
    for m, k in cells:
        sj = specs_j.AdderSpec(kind, 8, m, k)
        st = specs_t.AdderSpec(kind, 8, m, k)
        want = adders_j.approx_add_mod(a_np, b_np, sj, fast=fast)
        got = adders_t.approx_add_mod(a_t, b_t, st, fast=fast)
        np.testing.assert_array_equal(got.numpy().astype(np.uint64), want,
                                      err_msg=f"{kind} m={m} k={k}")


@pytest.mark.parametrize("n_bits,m,k", [(16, 8, 4), (32, 10, 5), (32, 32, 5),
                                        (16, 16, 14), (32, 3, 1)])
@pytest.mark.parametrize("kind", specs_j.ALL_KINDS)
def test_approx_add_plain_random_wide(kind, n_bits, m, k):
    try:
        sj = specs_j.AdderSpec(kind, n_bits, m, k)
    except ValueError:
        pytest.skip(f"{kind} admits no m={m} k={k}")
    st = specs_t.AdderSpec(kind, n_bits, m, k)
    rng = np.random.default_rng(n_bits + m)
    a = rng.integers(0, 1 << n_bits, 4000, dtype=np.uint64)
    b = rng.integers(0, 1 << n_bits, 4000, dtype=np.uint64)
    a[:4], b[:4] = [0, (1 << n_bits) - 1, 0, (1 << n_bits) - 1], \
        [0, 0, (1 << n_bits) - 1, (1 << n_bits) - 1]
    for fast in (False, True):
        want = adders_j.approx_add_mod(a, b, sj, fast=fast) \
            & np.uint64((1 << n_bits) - 1)
        want32 = want.astype(np.uint32).view(np.int32)
        a32 = torch.as_tensor(a.astype(np.uint32).view(np.int32))
        b32 = torch.as_tensor(b.astype(np.uint32).view(np.int32))
        got = approx_add_plain(a32, b32, st, fast)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want32)


def test_lane_helpers_round_trip():
    x = np.array([0, 1, -1, 2**31 - 1, -2**31, 12345, -54321], np.int32)
    lanes = u32_lanes(torch.as_tensor(x))
    assert lanes.dtype == torch.int64
    np.testing.assert_array_equal(lanes.numpy(),
                                  x.view(np.uint32).astype(np.int64))
    np.testing.assert_array_equal(to_int32(lanes).numpy(), x)
    np.testing.assert_array_equal(
        to_int32(lanes + (5 << 32)).numpy(), x)


@pytest.mark.parametrize("n_bits", [8, 16, 31, 32])
def test_scale_mod_matches_uint32_multiply(n_bits):
    rng = np.random.default_rng(n_bits)
    t = rng.integers(0, 1 << 32, 2000, dtype=np.uint64).astype(np.uint32)
    weights = [1, 2, -1, -2, 3, 32, -15, 2**31 - 1, -2**31, 2**32 + 7,
               -(2**33) - 3, 65537, 0]
    for w in weights:
        want = np.asarray(scale_mod_u32(jnp.asarray(t), w, n_bits))
        got = scale_mod(torch.as_tensor(t.astype(np.int64)), w, n_bits)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want,
                                      err_msg=f"w={w}")
