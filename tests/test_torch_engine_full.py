"""The engine's ``add_full``, ``sum`` and ``residual_add`` (the port's
``AxEngine``) against ``repro``'s, on the CPU (``backend="torch",
device="cpu"``).

- ``add_full`` — the full (N+1)-bit sum of the error analysis — equals
  the reference's ``numpy`` backend exhaustively at N=8 for every kind,
  every valid (m, k) and every strategy, on seeded operands at N=16,
  32 and 62, and at N=63, where the sum reaches bit 63 and the int64
  lanes hold the reference's uint64 bit pattern; the ``cuda`` backend
  refuses it, naming the spelling that runs it on the card;
- ``sum`` (the log-depth tree of ``add_signed``) equals the reference's
  ``jax`` ``sum`` on odd lengths (zero padding) and along other axes;
- ``residual_add``'s forward equals the reference's, and its backward is
  the exact add's (all ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ax import make_engine as ref_make_engine
from repro.core.specs import AdderSpec as RefSpec
from repro.numerics.fixed_point import FixedPointFormat as RefFormat
from repro_torch.ax import analytics as an
from repro_torch.ax import get_backend, make_engine, registered_kinds
from repro_torch.core.specs import AdderSpec
from repro_torch.numerics.fixed_point import FixedPointFormat

CPU = "cpu"
STRATEGIES = ("reference", "fused", "lut")


def ref_spec(s):
    return RefSpec(s.kind, s.n_bits, s.lsm_bits, s.const_bits)


def _engines(spec, strategy, fmt=None):
    port = make_engine(spec, fmt=fmt, backend="torch", device=CPU,
                       strategy=strategy)
    ref = ref_make_engine(ref_spec(spec),
                          fmt=None if fmt is None else
                          RefFormat(fmt.n_bits, fmt.frac_bits),
                          backend="numpy" if fmt is None else "jax",
                          strategy=strategy)
    return port, ref


@pytest.mark.parametrize("kind", registered_kinds())
def test_add_full_exhaustive_n8(kind):
    vals = np.arange(256, dtype=np.uint64)
    a, b = np.repeat(vals, 256), np.tile(vals, 256)
    for spec in an.design_space((8,), kinds=(kind,)):
        for strategy in STRATEGIES:
            port, ref = _engines(spec, strategy)
            got = port.add_full(a, b)
            assert got.dtype == torch.int64 and got.device.type == "cpu"
            np.testing.assert_array_equal(
                got.numpy(), ref.add_full(a, b).astype(np.int64),
                err_msg=f"{spec} {strategy}")


@pytest.mark.parametrize("n_bits,m,k", [(16, 8, 4), (16, 12, 3),
                                        (32, 10, 5), (32, 3, 1),
                                        (62, 12, 6)])
def test_add_full_sampled_wide(n_bits, m, k):
    rng = np.random.default_rng(n_bits + m)
    top = (1 << n_bits) - 1
    a = np.concatenate([rng.integers(0, top, 4000, endpoint=True,
                                     dtype=np.uint64),
                        np.array([0, top, top, 0], np.uint64)])
    b = np.concatenate([rng.integers(0, top, 4000, endpoint=True,
                                     dtype=np.uint64),
                        np.array([0, top, 0, top], np.uint64)])
    for kind in registered_kinds():
        try:
            spec = AdderSpec(kind, n_bits, m, k)
        except ValueError:
            spec = AdderSpec(kind, n_bits, m, 0)
        for strategy in STRATEGIES:
            port, ref = _engines(spec, strategy)
            # tensors (int64 lanes) and numpy uint64 containers alike
            got = port.add_full(torch.from_numpy(a.astype(np.int64)), b)
            np.testing.assert_array_equal(
                got.numpy(), ref.add_full(a, b).astype(np.int64),
                err_msg=f"{spec} {strategy}")


@pytest.mark.parametrize("kind", registered_kinds())
def test_add_full_n63_equals_reference_and_cuda_refuses(kind):
    """At N = 63 the sum reaches bit 63: the int64 lanes hold the bit
    pattern of the reference's uint64 sum, for operands with the top bit
    set, every strategy."""
    rng = np.random.default_rng(63)
    top = np.uint64((1 << 63) - 1)
    bit62 = np.uint64(1 << 62)
    a = np.concatenate([rng.integers(0, 1 << 63, 3000, dtype=np.uint64)
                        | bit62, np.array([top, top, 0, bit62], np.uint64)])
    b = np.concatenate([rng.integers(0, 1 << 63, 3000, dtype=np.uint64)
                        | bit62, np.array([top, 0, top, bit62], np.uint64)])
    try:
        spec = AdderSpec(kind, 63, 10, 5)
    except ValueError:
        spec = AdderSpec(kind, 63, 10, 0)
    for strategy in STRATEGIES:
        port, ref = _engines(spec, strategy)
        want = ref.add_full(a, b)
        assert want[:3000].min() >= np.uint64(1 << 63)  # past int64
        got = port.add_full(a, b)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy().view(np.uint64), want,
                                      err_msg=f"{spec} {strategy}")
    zeros = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(NotImplementedError,
                       match="backend='torch', device='cuda'"):
        get_backend("cuda").add_full(zeros, zeros, spec)


@pytest.mark.parametrize("kind", ["haloc_axa", "loa", "eta", "accurate"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sum_equals_reference_with_padding(kind, strategy):
    fmt = FixedPointFormat(16, 8)
    port, ref = _engines(AdderSpec(kind, 16, 8, 4), strategy, fmt)
    rng = np.random.default_rng(21)
    for shape, axis in (((37,), -1), ((3, 21), -1), ((5, 6, 7), 1),
                        ((9, 4), 0), ((1,), -1), ((2, 64), -1)):
        q = rng.integers(-2000, 2000, shape).astype(np.int32)
        got = port.sum(q, axis=axis)
        want = np.asarray(ref.sum(jnp.asarray(q), axis=axis))
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{shape} axis {axis}")


def test_sum_accurate_is_exact_and_needs_a_format():
    fmt = FixedPointFormat(16, 8)
    eng = make_engine(AdderSpec("accurate", 16), fmt=fmt, backend="torch",
                      device=CPU)
    assert int(eng.sum(np.arange(-10, 11, dtype=np.int32))) == 0
    with pytest.raises(ValueError, match="fixed-point format"):
        make_engine(AdderSpec("haloc_axa", 16, 8, 4), backend="torch",
                    device=CPU).sum(np.zeros(4, np.int32))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_residual_add_forward_and_straight_through_gradient(strategy):
    fmt = FixedPointFormat(16, 8)
    port, ref = _engines(AdderSpec("haloc_axa", 16, 8, 4), strategy, fmt)
    xs = np.linspace(-1.0, 1.0, 16, dtype=np.float32)
    ys = np.linspace(0.5, -0.5, 16, dtype=np.float32)
    x = torch.tensor(xs, requires_grad=True)
    y = torch.tensor(ys, requires_grad=True)
    out = port.residual_add(x, y)
    want = np.asarray(ref.residual_add(jnp.asarray(xs), jnp.asarray(ys)))
    np.testing.assert_array_equal(out.detach().numpy(), want)
    assert not np.allclose(out.detach().numpy(), xs + ys)
    out.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(16, np.float32))
    np.testing.assert_array_equal(y.grad.numpy(), np.ones(16, np.float32))
    gx, gy = jax.grad(lambda a, b: ref.residual_add(a, b).sum(),
                      argnums=(0, 1))(jnp.asarray(xs), jnp.asarray(ys))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(gx))
    np.testing.assert_array_equal(y.grad.numpy(), np.asarray(gy))


def test_residual_add_exact_kind_and_format():
    exact = make_engine(AdderSpec("accurate", 16), backend="torch",
                        device=CPU)
    x = torch.linspace(-1, 1, 8)
    torch.testing.assert_close(exact.residual_add(x, x), x + x, rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="fixed-point format"):
        make_engine(AdderSpec("haloc_axa", 16, 8, 4), backend="torch",
                    device=CPU).residual_add(x, x)


@pytest.mark.parametrize("n_bits,m,k", [(8, 4, 2), (16, 8, 4), (32, 10, 5),
                                        (32, 12, 6)])
def test_lut_adds_and_index_equal_reference(n_bits, m, k):
    """``ax.lut``'s ``lut_index``, ``lut_add_full`` and ``lut_add_mod`` on
    int64 lanes equal the reference's numpy functions."""
    from repro.ax import lut as ref_lut
    from repro_torch.ax import lut as port_lut
    rng = np.random.default_rng(m)
    a = rng.integers(0, 1 << n_bits, 3000, dtype=np.uint64)
    b = rng.integers(0, 1 << n_bits, 3000, dtype=np.uint64)
    ta, tb = (torch.from_numpy(x.astype(np.int64)) for x in (a, b))
    for kind in ("haloc_axa", "oloca", "eta"):
        spec = AdderSpec(kind, n_bits, m, k)
        rs = ref_spec(spec)
        np.testing.assert_array_equal(
            port_lut.lut_index(ta, tb, spec).numpy(),
            ref_lut.lut_index(a, b, rs).astype(np.int64))
        np.testing.assert_array_equal(
            port_lut.lut_add_full(ta, tb, spec).numpy(),
            ref_lut.lut_add_full(a, b, rs).astype(np.int64))
        np.testing.assert_array_equal(
            port_lut.lut_add_mod(ta, tb, spec).numpy(),
            ref_lut.lut_add_mod(a, b, rs).astype(np.int64))
