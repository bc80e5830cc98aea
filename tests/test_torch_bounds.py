"""The instruction counts behind ``chip_smoke.py``'s operations bounds.

A kernel's bound is the larger of its bytes over the memory rate and the
fewest int32 instructions known for its function over the int32 rate.
``chip_smoke.HALOC_AXA_ADD`` spells one haloc_axa add mod 2^N as Hopper
instructions (three-input LOP3 and IADD3, shift-and-add LEA); these tests
run those steps on 32-bit registers and hold them, bit for bit, against
the port's adder and the reference package's, so the count is one the
card can reach.  Exhaustive at N=8, seeded random pairs and the corners
at N=16 and N=32, every valid (m, k).  ``chip_smoke.CONV_INDEX`` spells
conv2d_mac's per-value step (its row of the signed tap tables); the conv
computed from it, one gather a tap and the reference adder equals the
plain conv and the reference's.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

from repro.core import adders as ref_adders
from repro.core.specs import AdderSpec as RefSpec
from repro_torch.core import adders as port_adders
from repro_torch.core.specs import AdderSpec

ROOT = pathlib.Path(__file__).resolve().parents[1]
REGISTER = 0xFFFFFFFF


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _run_steps(a, b, n_bits, m, k):
    regs = {"a": a, "b": b, **{name: np.uint64(v) for name, v in
                               CS.haloc_axa_masks(n_bits, m, k).items()}}
    for dest, _, srcs, fn in CS.HALOC_AXA_ADD:
        regs[dest] = fn(*(regs[s] for s in srcs)) & np.uint64(REGISTER)
    return regs["out"]


def _operands(n_bits, rng):
    if n_bits <= 8:
        grid = np.arange(1 << n_bits, dtype=np.uint64)
        return np.repeat(grid, grid.size), np.tile(grid, grid.size)
    top = (1 << n_bits) - 1
    a = rng.integers(0, top, 4096, endpoint=True, dtype=np.uint64)
    b = rng.integers(0, top, 4096, endpoint=True, dtype=np.uint64)
    corners = np.array([0, top, 1, top - 1], dtype=np.uint64)
    return (np.concatenate([a, np.repeat(corners, 4)]),
            np.concatenate([b, np.tile(corners, 4)]))


def test_haloc_axa_steps_are_single_instructions():
    defined = {"a", "b", *CS.haloc_axa_masks(16, 8, 4)}
    for dest, op, srcs, fn in CS.HALOC_AXA_ADD:
        assert op in ("LOP3", "IADD3", "LEA")
        assert 1 <= len(srcs) <= 3 and set(srcs) <= defined, dest
        assert fn.__code__.co_argcount == len(srcs), dest
        if op == "LEA":
            assert len(srcs) == 2
        defined.add(dest)
    assert CS.OPS_PER_ADD == len(CS.HALOC_AXA_ADD) == 8


@pytest.mark.parametrize("n_bits", [8, 16, 32])
def test_haloc_axa_steps_equal_the_adder(n_bits):
    rng = np.random.default_rng(n_bits)
    a, b = _operands(n_bits, rng)
    cases = 0
    for m in range(2, n_bits + 1):
        for k in range(0, m - 1):
            want = port_adders.approx_add_mod(
                a.astype(np.int64), b.astype(np.int64),
                AdderSpec("haloc_axa", n_bits, m, k))
            ref = ref_adders.approx_add_mod(
                a.astype(np.int64), b.astype(np.int64),
                RefSpec("haloc_axa", n_bits, m, k))
            got = _run_steps(a, b, n_bits, m, k)
            np.testing.assert_array_equal(np.asarray(ref), want)
            np.testing.assert_array_equal(got.astype(np.int64), want,
                                          err_msg=f"n{n_bits}m{m}k{k}")
            cases += 1
    assert cases == (n_bits - 1) * n_bits // 2



def test_conv_index_steps_are_single_instructions():
    defined = {"v", "taps", "zero"}
    for dest, op, srcs, fn in CS.CONV_INDEX:
        assert op in ("IMAD", "LOP3", "IADD3", "LEA")
        assert 1 <= len(srcs) <= 3 and set(srcs) <= defined, dest
        assert fn.__code__.co_argcount == len(srcs), dest
        defined.add(dest)
    assert CS.OPS_PER_CONV_VALUE == len(CS.CONV_INDEX) == 1
    assert CS.conv_ops(((1, 3, 1), (3, 5, 3), (1, 3, 1)), 0) == \
        1 + 8 * CS.OPS_PER_ADD + 1
    assert CS.conv_ops(((1,),), 2) == 1 + 0 + 1 + 2


@pytest.mark.parametrize("kind", ["haloc_axa", "loa", "eta", "accurate"])
def test_conv_index_steps_and_gathers_equal_the_conv(kind):
    """conv2d_mac as the bound counts it: each input value's table row from
    the ``CONV_INDEX`` steps on 32-bit registers, each tap one gather at
    row + t of the signed tap tables, then the adds (the reference's
    adder), the sign extension and the rounding; equal to the port's
    plain conv and the reference's numpy backend, at n16 and n32."""
    import torch

    from repro.ax.backends import get_backend as get_backend_j
    from repro.ax.mul import MulSpec as RefMulSpec
    from repro_torch.ax.backends import conv_taps
    from repro_torch.ax.mul import MulSpec
    from repro_torch.kernels import conv2d_mac as conv_k
    rng = np.random.default_rng(60)
    kernel = ((1, 3, 1), (3, -5, 3), (1, 3, 1))
    weights = sum(kernel, ())
    ms = MulSpec("truncated", 8, 3)
    q = rng.integers(-255, 256, (2, 9, 13)).astype(np.int32)
    for n_bits, m, k in ((16, 8, 4), (32, 10, 5)):
        spec = AdderSpec(kind, n_bits, m, k)
        tabs = conv_k.signed_tap_tables(ms, weights, n_bits, "cpu") \
            .reshape(-1).numpy().view(np.uint32).astype(np.uint64)
        regs = {"taps": np.uint64(len(weights)), "zero": np.uint64(
            len(weights) << ms.n_bits)}
        acc = None
        for t, view in enumerate(conv_taps(torch.as_tensor(q), 3, 3)):
            regs["v"] = view.numpy().astype(np.int64).astype(np.uint64)
            for dest, _, srcs, fn in CS.CONV_INDEX:
                regs[dest] = fn(*(regs[s] for s in srcs)) \
                    & np.uint64(REGISTER)
            u = tabs[(regs["idx"] + np.uint64(t)).astype(np.int64)]
            acc = u if acc is None else ref_adders.approx_add_mod(
                acc, u, RefSpec(kind, n_bits, m, k))
        sign = 1 << (n_bits - 1)
        got = ((acc.astype(np.int64) ^ sign) - sign).astype(np.int32)
        np.testing.assert_array_equal(
            got, conv_k.conv2d_mac_plain(torch.as_tensor(q), spec, ms,
                                         kernel).numpy())
        np.testing.assert_array_equal(got, np.asarray(
            get_backend_j("numpy").conv2d(q, RefSpec(kind, n_bits, m, k),
                                          RefMulSpec("truncated", 8, 3),
                                          kernel)))
