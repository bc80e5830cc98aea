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


def _run_wide_steps(steps, regs):
    """Run spelt steps on int64 lanes: a 32-bit register keeps its low 32
    bits after each step; an IMAD.WIDE result is a 64-bit register pair."""
    for dest, op, srcs, fn in steps:
        v = fn(*(regs[s] for s in srcs))
        regs[dest] = v if op.endswith(".WIDE") else v & REGISTER
    return regs


def _steps_are_instructions(steps, inputs, ops):
    defined = set(inputs)
    for dest, op, srcs, fn in steps:
        assert op in ops, (dest, op)
        assert 1 <= len(srcs) <= 3 and set(srcs) <= defined, dest
        assert fn.__code__.co_argcount == len(srcs), dest
        defined.add(dest)


def test_butterfly_steps_are_single_instructions():
    inputs = {"ar", "ai", "br", "bi", "wr", "wi",
              *CS.butterfly_masks(32, 10, 5)}
    ops = ("LOP3", "IADD3", "LEA", "IMAD.WIDE", "SHF")
    _steps_are_instructions(CS.BUTTERFLY_PAIR, inputs, ops)
    _steps_are_instructions(CS.BUTTERFLY_INVERSE, inputs, ops)
    assert len(CS.BUTTERFLY_PAIR) == CS.butterfly_ops(False) == 59
    assert len(CS.BUTTERFLY_INVERSE) == CS.butterfly_ops(True) == 67
    assert sum(op == "IMAD.WIDE" for _, op, _, _ in CS.BUTTERFLY_PAIR) == 4


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n_bits,m,k", [(32, 10, 5), (32, 8, 2), (16, 8, 4)])
def test_butterfly_steps_equal_butterfly_plain(n_bits, m, k, inverse):
    """The spelt butterfly pair (and the inverse halvings) on 32-bit
    registers equals the plain butterfly, haloc_axa, full-range int32
    planes and the FFT's own twiddles (stage halves 1 ... 256)."""
    import torch

    from repro_torch.kernels import butterfly as bf_k
    rng = np.random.default_rng(62 + inverse)
    spec = AdderSpec("haloc_axa", n_bits, m, k)
    for half in (1, 4, 256):
        planes = [rng.integers(-(1 << 31), 1 << 31, (9, half))
                  .astype(np.int32) for _ in range(4)]
        w_re, w_im = bf_k.stage_twiddles(half, inverse, torch.device("cpu"))
        want = bf_k.butterfly_plain(*(torch.as_tensor(p) for p in planes),
                                    w_re, w_im, spec, inverse=inverse)
        regs = {name: np.int64(v) for name, v in
                CS.butterfly_masks(n_bits, m, k).items()}
        for name, p in zip(("ar", "ai", "br", "bi"), planes):
            regs[name] = p.astype(np.int64) & REGISTER
        regs["wr"] = w_re.numpy().astype(np.int64)[None] & REGISTER
        regs["wi"] = w_im.numpy().astype(np.int64)[None] & REGISTER
        steps = CS.BUTTERFLY_INVERSE if inverse else CS.BUTTERFLY_PAIR
        regs = _run_wide_steps(steps, regs)
        outs = ("top_re", "top_im", "bot_re", "bot_im")
        for name, w in zip(outs, want):
            got = regs[name + ".h" if inverse else name]
            np.testing.assert_array_equal(
                got.astype(np.uint32).view(np.int32), w.numpy(),
                err_msg=f"{name} half={half}")


def test_mac_product_steps_are_one_gather_and_1_5_instructions():
    _steps_are_instructions(CS.MAC_PRODUCT_PAIR,
                            {"a", "b0", "b1", "table", "part"},
                            ("LOP3", "IADD3", "LDS"))
    assert CS.OPS_PER_MAC_PRODUCT == 1.5
    assert CS.GATHERS_PER_MAC_PRODUCT == 1


def test_mac_product_steps_equal_the_gemm_partial():
    """mac_matmul's inner loop as the bound counts it: the staged byte
    offsets, two LOP3s, two gathers from the int16 table and one IADD3 a
    pair of columns, over a whole K tile.  The pair's partial is the sum of
    the plain GEMM's two columns (a single tile: the raw partial), and with
    the second operand zero (entry 0) the one column's, for each 8-bit
    multiplier kind."""
    import torch

    from repro_torch.ax.mul import MulSpec, lut, registered_multipliers
    from repro_torch.core.specs import AdderSpec as PortSpec
    from repro_torch.kernels import mac_matmul as mac_k
    rng = np.random.default_rng(63)
    mask, w = 255, 8
    for kind in registered_multipliers():
        ms = MulSpec(kind, 8, 3 if kind != "accurate" else 0,
                     2 if kind == "broken_array" else 0)
        table = lut.device_signed_table16(ms, "cpu").numpy().astype(np.int64)
        a = rng.integers(-128, 128, (5, 40)).astype(np.int64)
        b = rng.integers(-128, 128, (40, 6)).astype(np.int64)
        want = mac_k.mac_matmul_plain(
            torch.as_tensor(a).to(torch.int32),
            torch.as_tensor(b).to(torch.int32), PortSpec("accurate", 32), ms,
            bk=64).numpy().astype(np.int64) & REGISTER

        def run(b0, b1):
            regs = {"table": table, "part": np.zeros((5, b0.shape[1]),
                                                     dtype=np.int64)}
            for kk in range(40):
                regs["a"] = (a[:, kk:kk + 1] & mask) << (w + 1)
                regs["b0"] = (b0[kk][None] & mask) << 1
                regs["b1"] = (b1[kk][None] & mask) << 1
                regs = _run_wide_steps(CS.MAC_PRODUCT_PAIR, regs)
            return regs["part"]

        np.testing.assert_array_equal(
            run(b[:, 0::2], b[:, 1::2]),
            (want[:, 0::2] + want[:, 1::2]) & REGISTER, err_msg=kind)
        np.testing.assert_array_equal(run(b, np.zeros_like(b)), want,
                                      err_msg=kind)
