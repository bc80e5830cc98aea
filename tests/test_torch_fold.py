"""The port's weighted fold, ``kernels/accumulate`` (stacked and signed
entries), against the reference's ``AxEngine.accumulate_signed`` and
``accumulate`` on the ``"jax"`` backend, bit for bit.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).  Here a Python model of it reads every term where the
wrapper tells the kernel it lies: the (planes, H, W) layout and the
(plane, row, column) strides of :func:`term_layout`, element (p, y, x) at
``storage_offset + p * plane + y * row + x * column`` of the term's
storage, masked to the container, scaled, masked again (all ones for a
weight of 1), folded left to right, sign-extended and rounded as the
kernel does.  The model is held against the reference on scaled_add's
planes (sharpen's weights (2, -1), blend's with shift 6), downsample2x's
strided phases on odd H and W, and K = 9; the stacked entry's layout
(K flat rows, no finish) against the reference's ``accumulate``.  The
route the kernel takes (:func:`accumulate_route`) is checked at its
edges.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.ax import make_engine as make_engine_j
from repro.ax.backends import get_backend as get_backend_j
from repro.core import specs as specs_j
from repro.numerics.fixed_point import FixedPointFormat as Fmt_j
from repro_torch.ax import make_engine as make_engine_t
from repro_torch.core import specs as specs_t
from repro_torch.core.adders import approx_add_mod
from repro_torch.kernels import accumulate as acc_k
from repro_torch.kernels.approx_add import signed32, u32_lanes
from repro_torch.numerics.fixed_point import FixedPointFormat as Fmt_t

KINDS = specs_j.ALL_KINDS


def _storage(v):
    """The whole storage under ``v`` as a flat int32 tensor."""
    return torch.as_strided(v, (v.untyped_storage().nbytes() // 4,), (1,), 0)


def _kernel_model(terms, spec, container_bits, weights, shift, fast):
    """``accumulate_launch`` in Python on the layout the wrapper passes.
    ``container_bits`` 0 is the stacked entry (no mask on load, no
    finish)."""
    planes, h, w, views, strides = acc_k.term_layout(terms)
    ws = acc_k.norm_weights(weights, len(terms))
    pre = (1 << container_bits) - 1 if container_bits else 0xFFFFFFFF
    n_mask = (1 << spec.n_bits) - 1
    p, y, x = torch.meshgrid(torch.arange(planes), torch.arange(h),
                             torch.arange(w), indexing="ij")
    acc = None
    for v, (ps, rs, cs), wt in zip(views, strides, ws):
        at = v.storage_offset() + p * ps + y * rs + x * cs
        u = u32_lanes(_storage(v)[at]) & pre
        post = 0xFFFFFFFF if wt == 1 else n_mask
        wm = wt & 0xFFFFFFFF  # u * wm mod 2^32 in 16-bit limbs of wm
        u = (u * (wm & 0xFFFF) + (((u * (wm >> 16)) & 0xFFFF) << 16)) \
            & 0xFFFFFFFF & post
        acc = u if acc is None else approx_add_mod(acc, u, spec, fast=fast)
    if container_bits:
        sign = 1 << (container_bits - 1)
        acc = signed32(((acc ^ sign) - sign) + (1 << shift >> 1)) >> shift
    return signed32(acc).to(torch.int32).reshape(terms[0].shape)


def _phases(q):
    q = q[..., :q.shape[-2] & ~1, :q.shape[-1] & ~1]
    return (q[..., 0::2, 0::2], q[..., 0::2, 1::2], q[..., 1::2, 0::2],
            q[..., 1::2, 1::2])


def _signed_cases(rng):
    """(name, terms as torch views of one array, the same terms stacked as
    a numpy array, weights, shift)."""
    def q(shape):
        return torch.as_tensor(rng.integers(-2040, 2040, shape)
                               .astype(np.int32))

    cases = []
    a, b = q((2, 9, 12)), q((2, 9, 12))
    cases.append(("sharpen", (a, b), (2, -1), 0))
    cases.append(("blend", (a, b), (40, 24), 6))
    for shape in ((3, 7, 9), (1, 5, 5), (2, 1, 7), (13, 11)):
        cases.append((f"downsample {shape}", _phases(q(shape)), None, 2))
    cases.append(("K=9", tuple(q((2, 5, 6)) for _ in range(9)),
                  (1, 2, 1, -2, 4, -2, 1, 2, -1), 3))
    base = q((4, 8))
    cases.append(("broadcast", (base, q((1, 8)).expand(4, 8)), (1, 1), 1))
    cases.append(("transposed", (base, q((8, 4)).t()), (3, -1), 0))
    return cases


@pytest.mark.parametrize("strategy", ["reference", "fused"])
@pytest.mark.parametrize("kind", KINDS)
def test_signed_entry_model_equals_reference_engine(kind, strategy):
    """The kernel's addressing and finish, in Python, equal the
    reference's accumulate_signed (jax backend) on stacked copies of the
    same terms; the port's engine equals it given the views or the
    stack."""
    rng = np.random.default_rng(len(kind) + len(strategy))
    fast = strategy == "fused"
    spec_t = specs_t.AdderSpec(kind, 16, 8, 4)
    ej = make_engine_j(specs_j.AdderSpec(kind, 16, 8, 4), fmt=Fmt_j(16, 3),
                       backend="jax", strategy=strategy)
    et = make_engine_t(spec_t, fmt=Fmt_t(16, 3), backend="torch",
                       device="cpu", strategy=strategy)
    for name, terms, ws, shift in _signed_cases(rng):
        stacked = np.stack([t.numpy() for t in terms])
        want = np.asarray(ej.accumulate_signed(jnp.asarray(stacked), ws,
                                               shift=shift))
        got = _kernel_model(terms, spec_t, 16, ws, shift, fast)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        np.testing.assert_array_equal(
            et.accumulate_signed(terms, ws, shift=shift).numpy(), want,
            err_msg=name)
        np.testing.assert_array_equal(
            et.accumulate_signed(stacked, ws, shift=shift).numpy(), want,
            err_msg=name)
        if len(terms) == 2:
            np.testing.assert_array_equal(
                et.scaled_add(terms[0], terms[1], *(ws or (1, 1)),
                              shift=shift).numpy(),
                np.asarray(ej.scaled_add(stacked[0], stacked[1],
                                         *(ws or (1, 1)), shift=shift)),
                err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_stacked_entry_model_equals_reference_accumulate(kind):
    """accumulate()'s launch (K flat rows of M at j * M, one row each, no
    mask on load and no finish) in the model equals the reference's
    accumulate, weights of 1 passing their term through unmasked."""
    rng = np.random.default_rng(40 + len(kind))
    for n_bits, m, k, shape, ws in ((16, 8, 4, (2, 3, 5), (2, -1)),
                                    (16, 8, 4, (4, 17), (1, 1, 1, 1)),
                                    (32, 10, 5, (3, 2, 4), (1, -1, 2**31)),
                                    (16, 8, 4, (1, 6), (1,))):
        spec_t = specs_t.AdderSpec(kind, n_bits, m, k)
        u = rng.integers(0, 1 << 32, shape, dtype=np.uint64)
        terms = u.astype(np.uint32).view(np.int32)
        for strategy in ("reference", "fused"):
            want = np.asarray(get_backend_j("jax").accumulate(
                jnp.asarray(terms), specs_j.AdderSpec(kind, n_bits, m, k),
                weights=ws, strategy=strategy))
            stack = torch.as_tensor(terms)
            flat = tuple(stack.reshape(len(ws), -1).unbind(0))
            got = _kernel_model(flat, spec_t, 0, ws, 0,
                                strategy == "fused").reshape(shape[1:])
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(
                acc_k.accumulate(stack, spec_t, weights=ws,
                                 fast=strategy == "fused").numpy(), want)


@pytest.mark.parametrize("k,numel,aligned,route", [
    (2, 4, True, (2, 4)), (2, 6, True, (2, 1)), (2, 8, False, (2, 1)),
    (4, 1 << 20, True, (4, 4)), (4, 3, True, (4, 1)), (1, 4, True, (0, 4)),
    (3, 16, True, (0, 4)), (9, 41, True, (0, 1)), (16, 4, True, (0, 4)),
    (16, 5, False, (0, 1))])
def test_accumulate_route(k, numel, aligned, route):
    assert acc_k.accumulate_route(k, numel, aligned) == route


def test_accumulate_route_refuses_k_outside_the_kernel():
    for k in (0, acc_k.MAX_TERMS + 1):
        with pytest.raises(ValueError, match="folds 1 to"):
            acc_k.accumulate_route(k, 4, True)


def test_term_layout_reads_views_in_place():
    """downsample2x's phases and scaled_add's planes are views with the
    strides the kernel reads (no copy); leading dims collapse into
    planes; a dim of size 1 has stride 0; 16-byte loads fit only unit
    column strides on aligned rows."""
    x = torch.zeros((3, 10, 12), dtype=torch.int32)
    ph = _phases(x)
    planes, h, w, views, strides = acc_k.term_layout(ph)
    assert (planes, h, w) == (3, 5, 6)
    assert strides == [(120, 24, 2)] * 4
    assert [v.storage_offset() for v in views] == [0, 1, 12, 13]
    assert all(v.data_ptr() - x.data_ptr() == 4 * o
               for v, o in zip(views, (0, 1, 12, 13)))
    assert not acc_k.vec_aligned([v.data_ptr() for v in views], strides)
    y = torch.zeros((2, 3, 4, 8), dtype=torch.int32)
    planes, h, w, views, strides = acc_k.term_layout((y, y))
    assert (planes, h, w, strides[0]) == (6, 4, 8, (32, 8, 1))
    assert views[0].data_ptr() == y.data_ptr()
    assert acc_k.term_layout((y[0, 0, 0],))[:3] == (1, 1, 8)
    assert acc_k.term_layout((y[0, :1],))[4] == [(0, 8, 1)]
    assert acc_k.term_layout((y[0, 0, :1],))[4] == [(0, 0, 1)]
    assert acc_k.vec_aligned([4096], [(32, 8, 1)])
    assert not acc_k.vec_aligned([4096 + 4], [(32, 8, 1)])
    assert not acc_k.vec_aligned([4096], [(32, 6, 1)])
    with pytest.raises(ValueError, match="shapes differ"):
        acc_k.term_layout((y, y[:1]))


def test_signed_entry_checks_its_arguments():
    spec = specs_t.AdderSpec("haloc_axa", 16, 8, 4)
    a = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="shift"):
        acc_k.accumulate_signed((a, a), spec, 16, shift=32)
    with pytest.raises(ValueError, match="weights for"):
        acc_k.accumulate_signed((a, a), spec, 16, weights=(1,))
    with pytest.raises(ValueError, match="at least one"):
        acc_k.accumulate_signed((), spec, 16)
    before = acc_k.accumulate.launches
    assert torch.equal(acc_k.accumulate_signed((a, a), spec, 16),
                       acc_k.accumulate_signed_plain((a, a), spec, 16))
    assert acc_k.accumulate.launches == before
