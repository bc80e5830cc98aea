"""The port's exact error analytics (``repro_torch.ax.analytics``) against
``repro.ax.analytics``, on the CPU (``backend="torch", device="cpu"``).

Every report and moment is compared with ``==``: the table reductions are
integer and the float composition is the reference's own host code, so
the port must be bit-identical to both of the reference's backends
(``numpy`` and ``jax``) — the seven Table-1 kinds at N=32, the whole N=8
design space, N=16 specs at m = 11 and 12, and the 61 N=8 multiplier
specs.  The device build of the delta tables equals the reference's
numpy build, and the error paths raise as the reference's do.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.ax import analytics as ref_an
from repro.ax import lut as ref_lut
from repro.ax.mul import MulSpec as RefMulSpec
from repro.ax.mul import lut as ref_mul_lut
from repro.core.specs import AdderSpec as RefSpec
from repro_torch.ax import analytics as an
from repro_torch.ax import lut as port_lut
from repro_torch.ax import registered_kinds
from repro_torch.ax.mul import MulSpec
from repro_torch.ax.mul import lut as port_mul_lut
from repro_torch.core.specs import AdderSpec, table1_specs
from repro_torch.obs import cache_stats

CPU = "cpu"
FIELDS = ("n_samples", "med", "mred", "nmed", "error_rate", "wce", "exact")


def ref_spec(s):
    return RefSpec(s.kind, s.n_bits, s.lsm_bits, s.const_bits)


def ref_mul(s):
    return RefMulSpec(s.kind, s.n_bits, s.trunc_bits, s.row_bits)


def fields(report):
    return tuple(getattr(report, f) for f in FIELDS)


def moments(mo):
    return dataclasses.astuple(mo)[1:]


@pytest.mark.parametrize("spec", table1_specs(), ids=lambda s: s.kind)
def test_table1_equals_both_reference_backends(spec):
    got = an.exact_error_metrics(spec, device=CPU)
    for backend in ("numpy", "jax"):
        want = ref_an.exact_error_metrics(ref_spec(spec), backend=backend)
        assert fields(got) == fields(want), backend
        assert moments(an.exact_error_moments(spec, device=CPU)) == \
            moments(ref_an.exact_error_moments(ref_spec(spec),
                                               backend=backend)), backend
    assert fields(an.exact_error_metrics(spec, backend="numpy")) == \
        fields(got)


@pytest.mark.parametrize("kind", registered_kinds())
def test_n8_design_space_equals_reference(kind):
    specs = an.design_space(n_bits=(8,), kinds=(kind,))
    assert specs == tuple(AdderSpec(s.kind, s.n_bits, s.lsm_bits,
                                    s.const_bits)
                          for s in ref_an.design_space((8,), kinds=(kind,)))
    got = an.exact_error_metrics_sweep(specs, cache_tables=False, device=CPU)
    want = ref_an.exact_error_metrics_sweep([ref_spec(s) for s in specs],
                                            cache_tables=False)
    assert [fields(r) for r in got] == [fields(r) for r in want]
    for spec in specs:
        if kind == "accurate":
            continue
        assert moments(an.exact_error_moments(spec, device=CPU,
                                              cache_tables=False)) == \
            moments(ref_an.exact_error_moments(ref_spec(spec)))


def test_design_space_sizes_equal_reference():
    got = an.design_space((8, 16, 32))
    assert len(got) == 672
    assert [(s.kind, s.n_bits, s.lsm_bits, s.const_bits) for s in got] == \
        [(s.kind, s.n_bits, s.lsm_bits, s.const_bits)
         for s in ref_an.design_space((8, 16, 32))]
    assert [dataclasses.astuple(s) for s in an.mul_design_space((8,))] == \
        [dataclasses.astuple(s) for s in ref_an.mul_design_space((8,))]


@pytest.mark.parametrize("spec", [
    AdderSpec("haloc_axa", 16, 12, 5), AdderSpec("oloca", 16, 11, 3),
    AdderSpec("eta", 16, 12, 0), AdderSpec("m_herloa", 16, 11, 9)],
    ids=lambda s: s.short_name)
def test_wide_tables_n16_equal_reference(spec):
    for cache in (False, True):
        got = an.exact_error_metrics(spec, device=CPU, cache_tables=cache)
        assert fields(got) == fields(ref_an.exact_error_metrics(
            ref_spec(spec), cache_tables=cache))
    assert moments(an.exact_error_moments(spec, device=CPU)) == \
        moments(ref_an.exact_error_moments(ref_spec(spec)))


def test_sweep_memoizes_and_mixes_widths():
    specs = list(table1_specs()) + [AdderSpec("haloc_axa", 16, 8, 4),
                                    AdderSpec("haloc_axa", 8, 6, 3),
                                    AdderSpec("haloc_axa", 16, 6, 3)]
    got = an.exact_error_metrics_sweep(specs, device=CPU)
    for spec, rep in zip(specs, got):
        assert rep == an.exact_error_metrics(spec, device=CPU), spec
    assert got[-1].wce == got[-2].wce and got[-1].med == got[-2].med


def test_closed_equals_compose_n16():
    """As the reference asserts: the digamma closed form against the exact
    composition at N=16, MRED to 1e-12 relative, the rest bit for bit."""
    for kind in ("loa", "herloa", "haloc_axa"):
        spec = AdderSpec(kind, 16, 8, 4 if kind == "haloc_axa" else 0)
        comp = an.exact_error_metrics(spec, method="compose", device=CPU)
        closed = an.exact_error_metrics(spec, method="closed", device=CPU)
        assert closed.mred == pytest.approx(comp.mred, rel=1e-12)
        assert (comp.med, comp.error_rate, comp.wce) == \
            (closed.med, closed.error_rate, closed.wce)
        assert fields(closed) == fields(ref_an.exact_error_metrics(
            ref_spec(spec), method="closed"))


@pytest.mark.parametrize("kind", ["accurate", "truncated", "broken_array",
                                  "mitchell"])
def test_mul_design_space_equals_reference(kind):
    specs = an.mul_design_space((8,), kinds=(kind,))
    got = an.exact_mul_error_metrics_sweep(specs, cache_tables=False,
                                           device=CPU)
    want = ref_an.exact_mul_error_metrics_sweep(
        [ref_mul(s) for s in specs], cache_tables=False)
    assert [fields(r) for r in got] == [fields(r) for r in want]
    cached = an.exact_mul_error_metrics_sweep(specs, device=CPU)
    assert [fields(r) for r in cached] == [fields(r) for r in want]


def test_mul_design_space_has_61_specs():
    assert len(an.mul_design_space((8,))) == 61


@pytest.mark.parametrize("spec", [
    MulSpec("truncated", 14, 6), MulSpec("truncated", 15, 9),
    MulSpec("broken_array", 13, 5, 0), MulSpec("truncated", 8, 4)],
    ids=lambda s: s.short_name)
def test_mul_closed_form_equals_reference(spec):
    got = an.exact_mul_error_metrics(spec, method="closed", device=CPU)
    want = ref_an.exact_mul_error_metrics(ref_mul(spec), method="closed")
    assert fields(got) == fields(want)


@pytest.mark.parametrize("kind", registered_kinds())
def test_device_build_equals_host_tables(kind):
    specs = [s for s in an.design_space((8,), kinds=(kind,))
             if kind != "accurate"]
    for spec in specs:
        got = port_lut.build_delta(spec, CPU).numpy()
        np.testing.assert_array_equal(
            got, ref_lut.error_delta_table(ref_spec(spec)), err_msg=str(spec))
        np.testing.assert_array_equal(port_lut.error_delta_table(spec), got)
        np.testing.assert_array_equal(
            port_lut.abs_error_table(spec),
            ref_lut.abs_error_table(ref_spec(spec)))
    if kind in ("haloc_axa", "oloca"):
        spec = AdderSpec(kind, 32, 12, 5)
        np.testing.assert_array_equal(
            port_lut.build_delta(spec, CPU).numpy(),
            ref_lut.error_delta_table_nocache(ref_spec(spec)))


def test_mul_device_build_equals_host_tables():
    for spec in an.mul_design_space((6,)):
        got = port_mul_lut.build_mul_delta(spec, CPU).numpy()
        want = ref_mul_lut.mul_error_delta_table_nocache(ref_mul(spec))
        np.testing.assert_array_equal(got, want, err_msg=str(spec))
        np.testing.assert_array_equal(
            port_mul_lut.mul_error_delta_table(spec), want)


def test_error_paths_raise_as_the_reference():
    loa = AdderSpec("loa", 32, 10, 0)
    with pytest.raises(ValueError, match="backend"):
        an.exact_error_metrics(loa, backend="fortran")
    with pytest.raises(ValueError, match="backend"):
        ref_an.exact_error_metrics(ref_spec(loa), backend="fortran")
    for mod, spec in ((an, loa), (ref_an, ref_spec(loa))):
        kw = {"device": CPU} if mod is an else {}
        with pytest.raises(ValueError, match="compose"):
            mod.exact_error_metrics(spec, method="compose", **kw)
        with pytest.raises(ValueError, match="method"):
            mod.exact_error_metrics(spec, method="sorcery", **kw)
    with pytest.raises(ValueError, match="MAX_LUT_LSM_BITS"):
        an.exact_error_metrics(AdderSpec("loa", 32, 16, 0), device=CPU)
    with pytest.raises(ValueError, match="MAX_LUT_LSM_BITS"):
        port_lut.build_delta(AdderSpec("loa", 32, 13, 0), CPU)
    with pytest.raises(ValueError, match="compose"):
        an.exact_mul_error_metrics(MulSpec("truncated", 14, 6),
                                   method="compose", device=CPU)
    with pytest.raises(ValueError, match="closed form"):
        an.exact_mul_error_metrics(MulSpec("mitchell", 8, 2),
                                   method="closed", device=CPU)
    with pytest.raises(ValueError, match="trunc_bits"):
        an.exact_mul_error_metrics(MulSpec("truncated", 15, 13),
                                   method="closed", device=CPU)
    with pytest.raises(ValueError, match="n_bits <= 12"):
        port_mul_lut.build_mul_delta(MulSpec("truncated", 13, 2), CPU)


def test_default_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = AdderSpec("haloc_axa", 16, 8, 4)
    for call in (lambda: an.exact_error_metrics(spec),
                 lambda: an.exact_error_moments(spec),
                 lambda: an.exact_error_metrics_sweep([spec]),
                 lambda: an.exact_mul_error_metrics(MulSpec("truncated", 8,
                                                            3))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # the host backend is an explicit request, and needs no card
    assert an.exact_error_metrics(spec, backend="numpy").exact


def test_caches_registered_under_the_reference_names():
    names = set(cache_stats())
    assert {"ax.lut.packed", "ax.lut.delta", "ax.lut.abs_error",
            "ax.mul.lut.product", "ax.mul.lut.delta", "ax.mul.lut.signed",
            "ax.mul.lut.taps", "ax.analytics.reciprocals",
            "ax.analytics.mul_reciprocals", "ax.engine"} <= names
    before = cache_stats("ax.analytics.reciprocals")[
        "ax.analytics.reciprocals"]
    an.exact_error_metrics(AdderSpec("loa", 32, 10, 0), device=CPU)
    an.exact_error_metrics(AdderSpec("loawa", 32, 10, 0), device=CPU)
    after = cache_stats("ax.analytics.reciprocals")[
        "ax.analytics.reciprocals"]
    assert after["hits"] + after["misses"] >= \
        before["hits"] + before["misses"] + 2
