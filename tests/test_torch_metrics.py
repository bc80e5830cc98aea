"""The port's error metrics (``repro_torch.core.metrics``) against
``repro.core.metrics``, on the CPU (``device="cpu"``).

- ``simulate_error_metrics`` and its sweep draw the reference's operand
  stream: at 2 x 10^5 samples, both strategies and a chunk that splits
  the stream, every metric equals the reference's, MRED (a float sum,
  summed in numpy's order) included;
- ``numpy_order_sum`` equals ``numpy.sum`` bit for bit at lengths that
  cross its leaves and blocks, over 16 decades of magnitude;
- ``_auto_chunk`` is the reference's rule;
- ``exhaustive_error_metrics`` at N=8 and ``exhaustive_mul_error_metrics``
  at N=6 equal the reference's with ``==``.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from repro.ax.mul import MulSpec as RefMulSpec
from repro.core import metrics as ref_m
from repro.core.specs import AdderSpec as RefSpec
from repro_torch.ax import analytics as an
from repro_torch.ax import registered_kinds, registered_multipliers
from repro_torch.ax.mul import MulSpec
from repro_torch.core import metrics as m
from repro_torch.core.specs import AdderSpec, paper_spec, table1_specs

CPU = "cpu"
FIELDS = ("n_samples", "med", "mred", "nmed", "error_rate", "wce", "exact")


def ref_spec(s):
    return RefSpec(s.kind, s.n_bits, s.lsm_bits, s.const_bits)


def fields(report):
    return tuple(getattr(report, f) for f in FIELDS)


def assert_mc_equal(got, want):
    assert fields(got) == fields(want), got.spec


@pytest.mark.parametrize("n", [1, 7, 8, 127, 128, 129, 8191, 8192, 8193,
                               3 * 8192 + 5, 2_000_000])
def test_numpy_order_sum_equals_numpy_sum(n):
    rng = np.random.default_rng(n)
    x = rng.random(n) * 10.0 ** rng.integers(-8, 8, n)
    assert m.numpy_order_sum(torch.from_numpy(x)) == float(np.sum(x))
    assert m.numpy_order_sum(torch.from_numpy(x)) == \
        float(x.sum(dtype=np.float64))


@pytest.mark.parametrize("strategy", ["reference", "lut"])
def test_sweep_equals_reference_on_a_split_stream(strategy):
    specs = list(table1_specs())
    got = m.simulate_error_metrics_sweep(specs, n_samples=200_000,
                                         chunk=70_000, strategy=strategy,
                                         seed=11, device=CPU)
    want = ref_m.simulate_error_metrics_sweep(
        [ref_spec(s) for s in specs], n_samples=200_000, chunk=70_000,
        strategy=strategy, seed=11)
    for g, w in zip(got, want):
        assert_mc_equal(g, w)


@pytest.mark.parametrize("strategy", ["reference", "fused", "lut"])
def test_single_spec_equals_reference(strategy):
    spec = AdderSpec("haloc_axa", 16, 8, 4)
    got = m.simulate_error_metrics(spec, n_samples=200_000, chunk=65_536,
                                   strategy=strategy, device=CPU)
    want = ref_m.simulate_error_metrics(ref_spec(spec), n_samples=200_000,
                                        chunk=65_536, strategy=strategy)
    assert_mc_equal(got, want)
    rng_got = m.simulate_error_metrics(
        spec, n_samples=50_000, rng=np.random.default_rng(5),
        strategy=strategy, device=CPU)
    rng_want = ref_m.simulate_error_metrics(
        ref_spec(spec), n_samples=50_000, rng=np.random.default_rng(5),
        strategy=strategy)
    assert_mc_equal(rng_got, rng_want)


@pytest.mark.parametrize("strategy", ["reference", "lut"])
def test_wide_operands_take_the_two_word_stream(strategy):
    """N > 32 draws each operand from two words, as the reference does."""
    specs = [AdderSpec("haloc_axa", 40, 10, 5), AdderSpec("loa", 40, 12, 0),
             AdderSpec("accurate", 40)]
    got = m.simulate_error_metrics_sweep(specs, n_samples=60_000,
                                         strategy=strategy, device=CPU)
    want = ref_m.simulate_error_metrics_sweep(
        [ref_spec(s) for s in specs], n_samples=60_000, strategy=strategy)
    for g, w in zip(got, want):
        assert_mc_equal(g, w)


def test_sweep_auto_chunk_matches_fixed_chunk_and_mixed_widths_raise():
    specs = [paper_spec(k) for k in ("loa", "haloc_axa")]
    auto = m.simulate_error_metrics_sweep(specs, n_samples=50_000,
                                          device=CPU)
    fixed = m.simulate_error_metrics_sweep(specs, n_samples=50_000,
                                           chunk=2_000_000, device=CPU)
    assert [fields(r) for r in auto] == [fields(r) for r in fixed]
    assert m.simulate_error_metrics_sweep([], device=CPU) == []
    with pytest.raises(ValueError, match="n_bits"):
        m.simulate_error_metrics_sweep(
            [paper_spec("loa"), AdderSpec("loa", 16, 8, 0)], device=CPU)


def test_auto_chunk_is_the_reference_rule():
    grid = itertools.product((0, 1, 7, 100, 10_000), (0, 1, 3, 30, 3000),
                             (False, True), (8, 16, 32, 48, 62))
    for args in grid:
        assert m._auto_chunk(*args) == ref_m._auto_chunk(*args), args
    assert m.SWEEP_MEMORY_BUDGET == ref_m.SWEEP_MEMORY_BUDGET


def test_operand_stream_is_the_reference_stream():
    rng_t, rng_r = np.random.default_rng(3), np.random.default_rng(3)
    chunks = list(m.operand_stream(rng_t, 10_000, 3_000, 32,
                                   torch.device(CPU)))
    assert [a.numel() for a, _ in chunks] == [3_000, 3_000, 3_000, 1_000]
    for a, b in chunks:
        ra, rb = ref_m._random_operands(rng_r, a.numel(), 32)
        np.testing.assert_array_equal(a.numpy(), ra.astype(np.int64))
        np.testing.assert_array_equal(b.numpy(), rb.astype(np.int64))


@pytest.mark.parametrize("strategy", ["reference", "fused", "lut"])
def test_error_distances_equal_reference(strategy):
    rng = np.random.default_rng(9)
    a = rng.integers(0, 1 << 32, 5000, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, 5000, dtype=np.uint64)
    for spec in table1_specs():
        got = m.error_distances(a, b, spec, strategy=strategy, device=CPU)
        np.testing.assert_array_equal(
            got.numpy(), ref_m.error_distances(a, b, ref_spec(spec),
                                               strategy=strategy))


@pytest.mark.parametrize("kind", registered_kinds())
def test_exhaustive_n8_equals_reference(kind):
    specs = an.design_space((8,), kinds=(kind,))[::3]
    for spec in specs:
        for strategy in ("reference", "lut"):
            got = m.exhaustive_error_metrics(spec, strategy, device=CPU)
            assert fields(got) == fields(ref_m.exhaustive_error_metrics(
                ref_spec(spec), strategy)), (spec, strategy)
        if kind != "accurate":
            assert fields(an.exact_error_metrics(spec, device=CPU)) == \
                fields(got)


@pytest.mark.parametrize("kind", registered_multipliers())
def test_exhaustive_mul_n6_equals_reference(kind):
    specs = an.mul_design_space((6,), kinds=(kind,))
    for spec in specs:
        for strategy in ("reference", "fused", "lut"):
            got = m.exhaustive_mul_error_metrics(spec, strategy, device=CPU)
            want = ref_m.exhaustive_mul_error_metrics(
                RefMulSpec(spec.kind, 6, spec.trunc_bits, spec.row_bits),
                strategy)
            assert fields(got) == fields(want), (spec, strategy)
        assert fields(an.exact_mul_error_metrics(spec, device=CPU)) == \
            fields(got)


def test_exhaustive_limits_raise():
    with pytest.raises(ValueError, match="N <= 12"):
        m.exhaustive_error_metrics(AdderSpec("loa", 13, 4, 0), device=CPU)
    with pytest.raises(ValueError, match="N <= 12"):
        m.exhaustive_mul_error_metrics(MulSpec("truncated", 13, 2),
                                       device=CPU)


def test_exact_inside_the_mc_band():
    """The port's Monte-Carlo estimate lies within 4 exact standard errors
    of the port's exact values (the reference's acceptance test)."""
    specs = [AdderSpec(k, 16, 8, 4 if k in ("oloca", "m_herloa",
                                              "haloc_axa") else 0)
             for k in registered_kinds() if k != "accurate"]
    n = 200_000
    for spec, mc in zip(specs, m.simulate_error_metrics_sweep(
            specs, n_samples=n, strategy="lut", seed=7, device=CPU)):
        mo = an.exact_error_moments(spec, device=CPU)
        assert abs(mc.med - mo.med) / math.sqrt(mo.var_ed / n) < 4, spec
        assert abs(mc.mred - mo.mred) / math.sqrt(mo.var_red / n) < 4, spec
        er_var = mo.error_rate * (1 - mo.error_rate)
        assert abs(mc.error_rate - mo.error_rate) / math.sqrt(er_var / n) \
            < 4, spec
        assert mc.wce <= mo.wce, spec


def test_wrappers_and_summarize_equal_reference():
    specs = list(table1_specs())
    got = m.exact_error_metrics_sweep(specs, cache_tables=False, device=CPU)
    want = ref_m.exact_error_metrics_sweep([ref_spec(s) for s in specs],
                                           cache_tables=False)
    assert [fields(r) for r in got] == [fields(r) for r in want]
    assert m.summarize(got) == ref_m.summarize(want)
    assert [r.row()["MED"] for r in got] == [r.row()["MED"] for r in want]
    spec = specs[-1]
    assert fields(m.exact_error_metrics(spec, device=CPU)) == \
        fields(ref_m.exact_error_metrics(ref_spec(spec)))
    mul = MulSpec("truncated", 8, 3)
    want_mul = ref_m.exact_mul_error_metrics(RefMulSpec("truncated", 8, 3))
    assert fields(m.exact_mul_error_metrics(mul, device=CPU)) == \
        fields(want_mul)
    assert m.exact_mul_error_metrics_sweep([mul], device=CPU)[0].row() == \
        {**want_mul.row()}


def test_default_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = paper_spec("haloc_axa")
    for call in (lambda: m.simulate_error_metrics(spec, n_samples=10),
                 lambda: m.simulate_error_metrics_sweep([spec],
                                                        n_samples=10),
                 lambda: m.exhaustive_error_metrics(AdderSpec("loa", 4, 2,
                                                              0)),
                 lambda: m.error_distances(np.zeros(2, np.uint64),
                                           np.zeros(2, np.uint64), spec)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
