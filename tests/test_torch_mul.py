"""The port's multiplier family (``repro_torch.ax.mul`` and the
``kernels/mul`` plain version) against the reference's, bit for bit.

- ``MulSpec``/``MacSpec`` validation and the registry round trip raise as
  the reference's do;
- ``approx_mul`` on torch int64 lanes equals the reference's on numpy
  uint64, exhaustively at N=8, for every spec of ``tests/test_mul.py``'s
  ``CONFIGS``, both forms;
- ``compile_mul_lut``, ``signed_mul_table`` and ``tap_tables`` are
  byte-identical to ``repro.ax.mul.lut``'s, and their device copies hold
  the same values;
- ``engine.mul``/``mul_signed`` on ``torch``/CPU equal the reference's
  ``numpy``, ``jax`` and ``pallas`` backends on all three strategies;
- ``make_engine(mul=...)`` and ``replace(mul=...)`` behave, and fail, as
  the reference's.

Inputs are made with numpy from a seed and given to both packages.  The
CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.ax import make_engine as make_engine_j
from repro.ax.backends import get_backend as get_backend_j
from repro.ax import mul as mul_j
from repro.core import specs as specs_j
from repro.numerics.fixed_point import FixedPointFormat as FMT_j
from repro_torch.ax import backends as be_t
from repro_torch.ax import make_engine
from repro_torch.ax import mul as mul_t
from repro_torch.core import specs as specs_t
from repro_torch.kernels import mul as mul_k
from repro_torch.numerics.fixed_point import FixedPointFormat

#: tests/test_mul.py's representative knob settings: every kind,
#: pruning off/mid/extreme.
CONFIGS = [
    ("accurate", 8, 0, 0),
    ("truncated", 8, 4, 0),
    ("truncated", 8, 8, 0),
    ("broken_array", 8, 4, 2),
    ("broken_array", 8, 0, 4),
    ("mitchell", 8, 0, 0),
    ("mitchell", 8, 3, 0),
]
#: Beyond the 8-bit table: the 16-bit product bus's uint32 tables.
WIDE = [("truncated", 10, 5, 0), ("broken_array", 9, 4, 2),
        ("mitchell", 10, 2, 0)]
#: tests/test_mul.py's negative-weight kernel and the conv3x3 workload's.
KERNELS = [((1, 3, 1), (3, -5, 3), (1, 3, 1)),
           ((1, 3, 1), (3, 5, 3), (1, 3, 1))]
STRATEGIES = ("reference", "fused", "lut")
CPU = dict(backend="torch", device="cpu")
ADDER16_T = specs_t.AdderSpec("haloc_axa", 16, 8, 4)
ADDER16_J = specs_j.AdderSpec("haloc_axa", 16, 8, 4)


def _name(c):
    return "-".join(str(x) for x in c)


def _pairs(n_bits):
    vals = np.arange(1 << n_bits, dtype=np.uint64)
    return np.repeat(vals, 1 << n_bits), np.tile(vals, 1 << n_bits)


# ------------------------------------------------------------ registry --

def test_builtin_kinds_and_specs_match_reference():
    assert mul_t.registered_multipliers() == mul_j.registered_multipliers()
    assert mul_t.MAX_MUL_BITS == mul_j.MAX_MUL_BITS == 15
    assert mul_t.MAX_MUL_LUT_BITS == mul_j.MAX_MUL_LUT_BITS
    for kind in mul_j.registered_multipliers():
        for n in (4, 8, 10):
            t = mul_t.default_mul_spec(kind, n)
            j = mul_j.default_mul_spec(kind, n)
            assert (t.kind, t.n_bits, t.trunc_bits, t.row_bits) == \
                (j.kind, j.n_bits, j.trunc_bits, j.row_bits)
            assert t.short_name == j.short_name
            assert t.is_exact == j.is_exact
            assert t.effective_trunc_bits == j.effective_trunc_bits
            assert t.effective_row_bits == j.effective_row_bits


@pytest.mark.parametrize("args,match", [
    (("nope", 8), "unknown multiplier"),
    (("truncated", 16), "n_bits"),
    (("truncated", 8, 9), "trunc_bits"),
    (("mitchell", 8, 8), "trunc_bits"),
    (("truncated", 8, 0, 2), "row_bits"),
    (("broken_array", 8, 0, 9), "row_bits"),
    (("truncated", 1), "n_bits"),
])
def test_spec_validation_matches_reference(args, match):
    with pytest.raises(ValueError, match=match):
        mul_j.MulSpec(*args)
    with pytest.raises(ValueError, match=match):
        mul_t.MulSpec(*args)


def test_mac_spec():
    mac = mul_t.MacSpec(ADDER16_T, mul_t.MulSpec("truncated", 8, 4))
    ref = mul_j.MacSpec(ADDER16_J, mul_j.MulSpec("truncated", 8, 4))
    assert mac.short_name == ref.short_name == \
        f"{ADDER16_T.short_name}+truncated-n8t4"
    with pytest.raises(TypeError, match="AdderSpec"):
        mul_t.MacSpec(mul_t.MulSpec("accurate", 8),
                      mul_t.MulSpec("accurate", 8))
    with pytest.raises(TypeError, match="MulSpec"):
        mul_t.MacSpec(ADDER16_T, ADDER16_T)


def test_register_unregister_roundtrip():
    @mul_t.register_multiplier("test_floor_half", order=99)
    def floor_half_mul(a, b, spec):
        return (a * b) - ((a * b) & ((a ^ a) + 1))

    try:
        assert "test_floor_half" in mul_t.registered_multipliers()
        spec = mul_t.MulSpec("test_floor_half", 4)
        a, b = _pairs(4)
        got = mul_t.approx_mul(torch.as_tensor(a.astype(np.int64)),
                               torch.as_tensor(b.astype(np.int64)), spec)
        np.testing.assert_array_equal(got.numpy(),
                                      ((a * b) & ~np.uint64(1)))
        mul_t.register_multiplier("test_floor_half", order=99)(floor_half_mul)
        with pytest.raises(ValueError, match="already registered"):
            mul_t.register_multiplier("test_floor_half")(lambda a, b, s: a)
        # The plain version runs it; the kernel has no device function.
        eng = make_engine(ADDER16_T, mul=spec, **CPU)
        assert eng.mul(np.array([3, 5], np.int32),
                       np.array([3, 3], np.int32)).tolist() == [8, 14]
        with pytest.raises(NotImplementedError, match="test_floor_half"):
            mul_k.mul_args(spec)
    finally:
        mul_t.unregister_multiplier("test_floor_half")
    assert "test_floor_half" not in mul_t.registered_multipliers()
    with pytest.raises(ValueError, match="unknown multiplier"):
        mul_t.MulSpec("test_floor_half", 4)


# ------------------------------------------------- multiplier formulas --

@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("cfg", CONFIGS, ids=_name)
def test_approx_mul_exhaustive_n8(cfg, fast):
    """The int64-lane formulas equal the reference's on numpy uint64 for
    all 4^8 operand pairs."""
    a, b = _pairs(8)
    want = mul_j.approx_mul(a, b, mul_j.MulSpec(*cfg), fast=fast)
    got = mul_t.approx_mul(torch.as_tensor(a.astype(np.int64)),
                           torch.as_tensor(b.astype(np.int64)),
                           mul_t.MulSpec(*cfg), fast=fast)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("cfg", WIDE, ids=_name)
def test_approx_mul_wide_sampled(cfg):
    rng = np.random.default_rng(sum(cfg[1:]))
    a, b = (rng.integers(0, 1 << cfg[1], 30000, dtype=np.uint64)
            for _ in range(2))
    for fast in (False, True):
        want = mul_j.approx_mul(a, b, mul_j.MulSpec(*cfg), fast=fast)
        got = mul_t.approx_mul(torch.as_tensor(a.astype(np.int64)),
                               torch.as_tensor(b.astype(np.int64)),
                               mul_t.MulSpec(*cfg), fast=fast)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# ---------------------------------------------------------- the tables --

@pytest.mark.parametrize("cfg", CONFIGS + WIDE, ids=_name)
def test_tables_byte_identical(cfg):
    st, sj = mul_t.MulSpec(*cfg), mul_j.MulSpec(*cfg)
    for fn in ("compile_mul_lut", "signed_mul_table"):
        got, want = getattr(mul_t, fn)(st), getattr(mul_j, fn)(sj)
        assert got.dtype == want.dtype and got.shape == want.shape, fn
        assert got.tobytes() == want.tobytes(), fn
        assert not got.flags.writeable
    for kernel in KERNELS:
        w = tuple(x for row in kernel for x in row)
        got, want = mul_t.tap_tables(st, w), mul_j.tap_tables(sj, w)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # The device copies hold the same values (uint16 read back by mask).
    dev = mul_t.device_mul_table(st, "cpu").to(torch.int64)
    if mul_t.compile_mul_lut(st).dtype == np.uint16:
        dev = dev & 0xFFFF
    np.testing.assert_array_equal(dev.numpy(),
                                  mul_j.compile_mul_lut(sj).astype(np.int64))
    np.testing.assert_array_equal(
        mul_t.device_signed_table(st, "cpu").numpy(),
        mul_j.signed_mul_table(sj))


def test_tables_cached_and_refused_like_reference():
    spec = mul_t.MulSpec("truncated", 8, 4)
    assert mul_t.compile_mul_lut(spec) is \
        mul_t.compile_mul_lut(mul_t.MulSpec("truncated", 8, 4))
    # Knobs the kind ignores do not split the cache.
    assert mul_t.compile_mul_lut(mul_t.MulSpec("accurate", 8, 3)) is \
        mul_t.compile_mul_lut(mul_t.MulSpec("accurate", 8))
    assert mul_t.device_signed_table(spec, "cpu") is \
        mul_t.device_signed_table(spec, torch.device("cpu"))
    wide = mul_t.MulSpec("truncated", 12, 4)
    assert not mul_t.mul_lut_supported(wide)
    assert mul_t.mul_lut_supported(mul_t.MulSpec("accurate", 12))
    for fn in (mul_t.compile_mul_lut, mul_t.signed_mul_table):
        with pytest.raises(ValueError, match="LUT"):
            fn(wide)
    with pytest.raises(ValueError, match="weight"):
        mul_t.tap_tables(spec, (1, 256))
    with pytest.raises(ValueError, match="weight"):
        mul_j.tap_tables(mul_j.MulSpec("truncated", 8, 4), (1, 256))
    idx = mul_t.mul_lut_index(torch.tensor([3, 0x1FF]),
                              torch.tensor([5, 0x101]), 8)
    assert idx.tolist() == [(3 << 8) | 5, (0xFF << 8) | 1]


# -------------------------------------------------------------- engine --

@pytest.mark.parametrize("cfg", CONFIGS, ids=_name)
def test_engine_mul_exhaustive_matches_reference(cfg):
    """``engine.mul`` on ``torch``/CPU, each strategy, equals the
    reference's ``numpy`` backend on all 4^8 pairs, and its ``jax`` and
    ``pallas`` backends on int32 containers."""
    a, b = _pairs(8)
    want = np.asarray(get_backend_j("numpy").mul(
        a, b, mul_j.MulSpec(*cfg), strategy="reference")).astype(np.int64)
    a32, b32 = a.astype(np.int32), b.astype(np.int32)
    for strategy in STRATEGIES:
        eng = make_engine(ADDER16_T, mul=mul_t.MulSpec(*cfg),
                          strategy=strategy, **CPU)
        got = eng.mul(a32, b32)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=strategy)
        np.testing.assert_array_equal(
            mul_k.mul(torch.as_tensor(a32), torch.as_tensor(b32),
                      mul_t.MulSpec(*cfg), strategy=strategy).numpy(),
            want, err_msg=strategy)
    for backend in ("jax", "pallas"):
        got = get_backend_j(backend).mul(jnp.asarray(a32), jnp.asarray(b32),
                                         mul_j.MulSpec(*cfg),
                                         strategy="fused")
        np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_engine_mul_signed_matches_reference(strategy):
    """Sign-magnitude products on signed int32 inputs, |q| <= 2^(N-1),
    every kind, against the reference's jax engine."""
    rng = np.random.default_rng(7)
    qa = rng.integers(-128, 129, (4, 37, 29)).astype(np.int32)
    qb = rng.integers(-128, 129, (4, 37, 29)).astype(np.int32)
    for kind in mul_j.registered_multipliers():
        ms_t, ms_j = mul_t.default_mul_spec(kind), mul_j.default_mul_spec(kind)
        eng = make_engine(ADDER16_T, mul=ms_t, strategy=strategy, **CPU)
        ref = make_engine_j(ADDER16_J, backend="jax", mul=ms_j,
                            strategy=strategy)
        got = eng.mul_signed(qa, qb)
        want = np.asarray(ref.mul_signed(jnp.asarray(qa), jnp.asarray(qb)))
        assert got.dtype == torch.int32 and got.shape == qa.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=kind)
        np.testing.assert_array_equal(
            eng.mul(np.abs(qa), np.abs(qb)).numpy(),
            np.asarray(ref.mul(jnp.asarray(np.abs(qa)),
                               jnp.asarray(np.abs(qb)))), err_msg=kind)


def test_mul_keeps_unsigned_dtypes():
    """An unsigned operand dtype comes back as it went in (the reference's
    ``_like``); a signed one as int32."""
    eng = make_engine(ADDER16_T, mul=mul_t.MulSpec("accurate", 8), **CPU)
    a = np.array([7, 200], np.uint8)
    assert eng.mul(a, a).dtype == torch.uint8
    assert eng.mul(a.astype(np.int64), a.astype(np.int64)).dtype == \
        torch.int32
    assert eng.mul(a.astype(np.int64), a.astype(np.int64)).tolist() == \
        [49, 40000]


def test_make_engine_mul_paths_and_errors():
    fmt = FixedPointFormat(16, 0)
    mul = mul_t.MulSpec("truncated", 8, 3)
    e1 = make_engine(ADDER16_T, fmt=fmt, mul=mul, **CPU)
    e2 = make_engine(mul_t.MacSpec(ADDER16_T, mul), fmt=fmt, **CPU)
    assert e1 is e2 and e1.mul_spec == mul
    e3 = make_engine(ADDER16_T, fmt=fmt, mul="truncated", **CPU)
    assert e3.mul_spec == mul_t.default_mul_spec("truncated")
    assert make_engine(ADDER16_T, fmt=fmt, **CPU).mul_spec is None
    with pytest.raises(ValueError, match="not both"):
        make_engine(mul_t.MacSpec(ADDER16_T, mul), fmt=fmt, mul=mul, **CPU)
    with pytest.raises(ValueError, match="unknown multiplier"):
        make_engine(ADDER16_T, fmt=fmt, mul="nope", **CPU)
    with pytest.raises(TypeError, match="MulSpec, kind name or None"):
        make_engine(ADDER16_T, fmt=fmt, mul=8, **CPU)
    with pytest.raises(ValueError, match="LUT"):
        make_engine(ADDER16_T, fmt=fmt, strategy="lut",
                    mul=mul_t.MulSpec("truncated", 12, 4), **CPU)
    # The reference raises the same three.
    fmt_j = FMT_j(16, 0)
    mj = mul_j.MulSpec("truncated", 8, 3)
    with pytest.raises(ValueError, match="not both"):
        make_engine_j(mul_j.MacSpec(ADDER16_J, mj), fmt=fmt_j, mul=mj)
    with pytest.raises(ValueError, match="unknown multiplier"):
        make_engine_j(ADDER16_J, fmt=fmt_j, mul="nope")
    with pytest.raises(ValueError, match="LUT"):
        make_engine_j(ADDER16_J, fmt=fmt_j, strategy="lut",
                      mul=mul_j.MulSpec("truncated", 12, 4))


def test_engine_requires_mul_spec_for_mac_ops():
    eng = make_engine(ADDER16_T, fmt=FixedPointFormat(16, 0), **CPU)
    with pytest.raises(ValueError, match="multiplier"):
        eng.mul(np.int32([1]), np.int32([2]))
    with pytest.raises(ValueError, match="multiplier"):
        eng.mul_signed(np.int32([1]), np.int32([2]))
    with pytest.raises(ValueError, match="multiplier"):
        eng.conv2d(np.zeros((4, 4), np.int32), KERNELS[0])
    no_fmt = make_engine(ADDER16_T, mul="truncated", **CPU)
    with pytest.raises(ValueError, match="fixed-point format"):
        no_fmt.conv2d(np.zeros((4, 4), np.int32), KERNELS[0])


def test_replace_mul_backend_device_and_strategy():
    fmt = FixedPointFormat(16, 0)
    eng = make_engine(ADDER16_T, fmt=fmt, **CPU)
    mac = eng.replace(mul="mitchell")
    assert mac.mul_spec == mul_t.default_mul_spec("mitchell")
    assert mac.spec == eng.spec and mac.device == eng.device
    assert mac.replace(mul=None).mul_spec is None
    spec = mul_t.MulSpec("broken_array", 8, 4, 2)
    assert eng.replace(mul=spec).mul_spec is spec
    with pytest.raises(ValueError, match="unknown multiplier"):
        eng.replace(mul="nope")
    assert eng.replace(fast=True).strategy == "fused"
    assert eng.replace(strategy="auto").strategy == "fused"
    with pytest.raises(ValueError, match="unknown strategy"):
        eng.replace(strategy="nope")
    assert eng.replace(backend="torch").backend is eng.backend
    with pytest.raises(ValueError, match="needs a CUDA device"):
        eng.replace(backend="cuda")
    # The reference's replace takes the same mul= spellings.
    ref = make_engine_j(ADDER16_J, fmt=FMT_j(16, 0), backend="numpy")
    assert ref.replace(mul="mitchell").mul_spec.short_name == \
        mac.mul_spec.short_name


def test_cuda_backend_refusals_on_mul():
    """The cuda backend takes CUDA tensors only, and refuses the lut form
    for a multiplier with no compilable table (as the Pallas backend)."""
    be = be_t.get_backend("cuda")
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        be.mul(t, t, mul_t.MulSpec("truncated", 8, 3))
    with pytest.raises(NotImplementedError, match="product table"):
        get_backend_j("pallas").mul(jnp.int32([1]), jnp.int32([2]),
                                    mul_j.MulSpec("truncated", 12, 4),
                                    strategy="lut")
    with pytest.raises(ValueError, match="unknown strategy"):
        mul_k.mul(t, t, mul_t.MulSpec("truncated", 8, 3), strategy="nope")
    with pytest.raises(ValueError, match="shapes differ"):
        mul_k.mul(t, t[:2], mul_t.MulSpec("truncated", 8, 3))


# ------------------------------------------- the cuda backend's operand rules --

def _cuda_backend_on_cpu(monkeypatch):
    """The cuda backend with its CUDA-only guard lifted: its kernel
    wrappers then take CPU tensors to their plain versions, so what the
    backend does around them runs here."""
    cuda = be_t.get_backend("cuda")
    monkeypatch.setattr(be_t.CudaBackend, "_require_cuda",
                        staticmethod(lambda what, *ts: None))
    return cuda


def test_broadcast_operands():
    a = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    b = torch.arange(4, dtype=torch.int32)
    x, y = be_t.broadcast_operands(a, b)
    assert x.shape == y.shape == (3, 4)
    assert x.is_contiguous() and y.is_contiguous()
    assert torch.equal(y, b.expand(3, 4))
    x, y = be_t.broadcast_operands(a[:, :1], b)
    assert torch.equal(x, a[:, :1].expand(3, 4))
    with pytest.raises(RuntimeError):
        be_t.broadcast_operands(a, torch.arange(3))


@pytest.mark.parametrize("strategy", ["reference", "fused", "lut"])
def test_cuda_backend_add_and_mul_broadcast(monkeypatch, strategy):
    """A (3, 4) * 1000 operand with b = arange(4) * 777.  The
    cuda backend's add (add_signed on top of it) and mul (mul_signed)
    broadcast as the torch backend and the reference's jax backend do,
    and out[0, 0] = 15 at haloc_axa n16m8k4."""
    cuda = _cuda_backend_on_cpu(monkeypatch)
    torch_be = be_t.get_backend("torch")
    a = torch.arange(12, dtype=torch.int32).reshape(3, 4) * 1000
    b = torch.arange(4, dtype=torch.int32) * 777
    st = specs_t.AdderSpec("haloc_axa", 16, 8, 4)
    sj = specs_j.AdderSpec("haloc_axa", 16, 8, 4)
    want = np.asarray(get_backend_j("jax").add(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), sj))
    for x, y in ((a, b), (b, a)):
        got = cuda.add(x, y, st, strategy=strategy)
        assert torch.equal(got, torch_be.add(x, y, st, strategy=strategy))
    np.testing.assert_array_equal(cuda.add(a, b, st, strategy=strategy),
                                  want)
    assert int(cuda.add(a, b, st, strategy=strategy)[0, 0]) == 15
    ms = mul_t.MulSpec("truncated", 8, 3)
    for x, y in ((a % 256, b % 256), (b % 256, (a % 256).to(torch.uint8))):
        got = cuda.mul(x, y, ms, strategy=strategy)
        assert torch.equal(got, torch_be.mul(x, y, ms, strategy=strategy))
    from repro_torch.ax.engine import AxEngine
    eng = AxEngine(st, FixedPointFormat(16, 6), cuda, strategy,
                   torch.device("cpu"), ms)
    cpu = make_engine(st, fmt=FixedPointFormat(16, 6), mul=ms,
                      strategy=strategy, **CPU)
    assert torch.equal(eng.add_signed(a - 6000, b), cpu.add_signed(a - 6000,
                                                                   b))
    assert torch.equal(eng.mul_signed(a % 128 - 64, 64 - b % 128),
                       cpu.mul_signed(a % 128 - 64, 64 - b % 128))


def test_cuda_backend_conv2d_checks_before_narrowing(monkeypatch):
    """An int64 input of 2^32 + 1 wraps to 1 in int32, inside the range:
    the cuda backend's conv2d checks |q| < 2^w on the caller's dtype
    first and raises the numpy backend's message, as the torch backend
    does; the kernel is never reached."""
    from repro_torch.kernels import conv2d_mac as conv_k
    cuda = _cuda_backend_on_cpu(monkeypatch)
    launched = []
    monkeypatch.setattr(conv_k, "launch_conv2d_mac",
                        lambda *a, **kw: launched.append(a))
    q = torch.tensor([[1, (1 << 32) + 1], [2, 3]], dtype=torch.int64)
    assert int(q.to(torch.int32).abs().max()) < 256
    st = specs_t.AdderSpec("haloc_axa", 16, 8, 4)
    ms = mul_t.MulSpec("truncated", 8, 3)
    kernel = ((1, 3, 1), (3, -5, 3), (1, 3, 1))
    for be in (cuda, be_t.get_backend("torch")):
        with pytest.raises(ValueError, match=r"\|q\| < 2\^8"):
            be.conv2d(q, st, ms, kernel)
    assert launched == []
    cuda.conv2d(q % (1 << 32), st, ms, kernel)
    assert len(launched) == 1 and launched[0][0].dtype == torch.int32
