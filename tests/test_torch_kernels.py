"""The port's three kernel modules (plain versions, on the CPU) and engine
primitives against the reference's ``"jax"`` and ``"pallas"`` (interpret)
backends, bit for bit.

Inputs are made with numpy from a seed and given to both packages.  The
CUDA kernels themselves run only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``); here the wrappers take their plain versions
because the tensors lie on the CPU.  A Python model of the CUDA chain
kernel's tiling (regions walked backwards from the output tile, clipped
to the image, taps clamped per stage) is held against the plain chain on
the edge shapes, so the tiling itself is checked here too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.ax import backends as be_j
from repro.ax import make_engine as make_engine_j
from repro.core import specs as specs_j
from repro.numerics.fixed_point import FixedPointFormat as Fmt_j
from repro_torch.ax import backends as be_t
from repro_torch.ax import make_engine as make_engine_t
from repro_torch.core import specs as specs_t
from repro_torch.kernels import accumulate as acc_k
from repro_torch.kernels import approx_add as add_k
from repro_torch.kernels import conv_chain as chain_k
from repro_torch.numerics.fixed_point import FixedPointFormat as Fmt_t

FS_J, FS_T = be_j.FilterStage, be_t.FilterStage
KINDS = specs_j.ALL_KINDS
GAUSS = (FS_T(-1, (-1, 0, 1), (1, 2, 1), 2), FS_T(-2, (-1, 0, 1), (1, 2, 1), 2))
SOBEL_GY = (FS_T(-1, (-1, 0, 1), (1, 2, 1)), FS_T(-2, (1, -1), (1, -1)))


def _specs(kind, n_bits, m, k):
    return (specs_j.AdderSpec(kind, n_bits, m, k),
            specs_t.AdderSpec(kind, n_bits, m, k))


def _containers(rng, shape, n_bits):
    """Random N-bit patterns in int32 containers (the full int32 range at
    N=32)."""
    u = rng.integers(0, 1 << n_bits, shape, dtype=np.uint64)
    return u.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("strategy", ["reference", "fused"])
@pytest.mark.parametrize("kind", KINDS)
def test_add_matches_jax_and_pallas(kind, strategy):
    rng = np.random.default_rng(len(kind))
    for n_bits, m, k, shape in ((16, 8, 4, (3, 37, 5)), (32, 10, 5, (257,)),
                                (12, 5, 2, (1,))):
        sj, st = _specs(kind, n_bits, m, k)
        a, b = (_containers(rng, shape, n_bits) for _ in range(2))
        want = np.asarray(be_j.get_backend("jax").add(
            jnp.asarray(a), jnp.asarray(b), sj, strategy=strategy))
        got = be_t.get_backend("torch").add(
            torch.as_tensor(a), torch.as_tensor(b), st, strategy=strategy)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        if n_bits == 16:
            pal = np.asarray(be_j.get_backend("pallas").add(
                jnp.asarray(a), jnp.asarray(b), sj, strategy=strategy))
            np.testing.assert_array_equal(got.numpy(), pal)


@pytest.mark.parametrize("strategy", ["reference", "fused"])
@pytest.mark.parametrize("kind", KINDS)
def test_accumulate_matches_jax(kind, strategy):
    rng = np.random.default_rng(7 + len(kind))
    cases = (
        (16, 8, 4, (2, 1, 1), (2, -1)),
        (16, 8, 4, (4, 3, 17), (1, 1, 1, 1)),
        (16, 8, 4, (9, 2, 3, 5), (1, 2, 1, -2, 4, -2, 1, 2, 1)),
        (16, 8, 4, (3, 131), (32, 32, -7)),
        (32, 10, 5, (5, 4, 33), (1, -1, 2**31, -2**31 + 3, 7)),
        (20, 9, 3, (1, 6), (-3,)),
    )
    for n_bits, m, k, shape, weights in cases:
        sj, st = _specs(kind, n_bits, m, k)
        terms = _containers(rng, shape, n_bits)
        want = np.asarray(be_j.get_backend("jax").accumulate(
            jnp.asarray(terms), sj, weights=weights, strategy=strategy))
        got = be_t.get_backend("torch").accumulate(
            torch.as_tensor(terms), st, weights=weights, strategy=strategy)
        assert got.dtype == torch.int32 and got.shape == shape[1:]
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{shape} {weights}")


@pytest.mark.parametrize("kind", ["haloc_axa", "loa", "eta", "m_herloa"])
def test_accumulate_matches_pallas(kind):
    rng = np.random.default_rng(11)
    sj, st = _specs(kind, 16, 8, 4)
    terms = _containers(rng, (9, 3, 70), 16)
    weights = (1, 2, 1, 2, 4, -2, 1, -2, 3)
    for strategy in ("reference", "fused"):
        want = np.asarray(be_j.get_backend("pallas").accumulate(
            jnp.asarray(terms), sj, weights=weights, strategy=strategy))
        got = acc_k.accumulate(torch.as_tensor(terms), st, weights=weights,
                               fast=strategy == "fused")
        np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_route_cpu_tensors_to_plain_versions():
    st = specs_t.AdderSpec("haloc_axa", 16, 8, 4)
    a = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    before = (add_k.approx_add.launches, acc_k.accumulate.launches,
              chain_k.filter_chain.launches)
    assert torch.equal(add_k.approx_add(a, a, st),
                       add_k.approx_add_plain(a, a, st))
    assert torch.equal(acc_k.accumulate(torch.stack([a, a]), st),
                       acc_k.accumulate_plain(torch.stack([a, a]), st))
    assert torch.equal(chain_k.filter_chain(a, st, GAUSS),
                       chain_k.filter_chain_plain(a, st, GAUSS))
    assert (add_k.approx_add.launches, acc_k.accumulate.launches,
            chain_k.filter_chain.launches) == before
    with pytest.raises(ValueError, match="shapes differ"):
        add_k.approx_add(a, a[:2], st)
    with pytest.raises(ValueError, match="weights for"):
        acc_k.accumulate(torch.stack([a, a]), st, weights=(1,))
    with pytest.raises(ValueError, match="axis"):
        chain_k.filter_chain(a, st, (FS_T(-3, (0,), (1,)),))


@pytest.mark.parametrize("kind", ["haloc_axa", "herloa", "accurate"])
def test_engine_primitives_match_reference_engine(kind):
    rng = np.random.default_rng(21)
    fmt_j, fmt_t = Fmt_j(16, 3), Fmt_t(16, 3)
    ej = make_engine_j(kind, fmt=fmt_j, backend="jax")
    et = make_engine_t(kind, fmt=fmt_t, backend="torch", device="cpu")
    qs = rng.integers(-2000, 2000, (4, 9, 33)).astype(np.int32)
    np.testing.assert_array_equal(
        et.accumulate_signed(qs, (1, 2, 2, 1), shift=2).numpy(),
        np.asarray(ej.accumulate_signed(qs, (1, 2, 2, 1), shift=2)))
    np.testing.assert_array_equal(
        et.scaled_add(qs[0], qs[1], 2, -1, shift=1).numpy(),
        np.asarray(ej.scaled_add(qs[0], qs[1], 2, -1, shift=1)))
    np.testing.assert_array_equal(
        et.add_signed(qs[0], qs[1]).numpy(),
        np.asarray(ej.add_signed(qs[0], qs[1])))
    stages = SOBEL_GY
    np.testing.assert_array_equal(
        et.filter_chain(qs[0], stages).numpy(),
        np.asarray(ej.filter_chain(
            qs[0], tuple(FS_J(*st) for st in stages))))
