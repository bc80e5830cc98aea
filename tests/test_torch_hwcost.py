"""The port's hardware-cost model (``repro_torch.core.hwcost`` and its copy
of ``core.netlist``) against ``repro.core.hwcost``, on the CPU.

The netlist counts are integer; the energies come from toggle activities
whose flip counts the port takes with a popcount on the device, from the
reference's random vectors, so every report equals the reference's with
``==``.  The reference's own assertions (``tests/test_hwcost.py``) are
run again on the port.
"""

import numpy as np
import pytest
import torch

from repro.ax.mul import MulSpec as RefMulSpec
from repro.core import hwcost as ref_hw
from repro.core import netlist as ref_nl
from repro.core.specs import AdderSpec as RefSpec
from repro_torch.ax import analytics as an
from repro_torch.ax.mul import MulSpec
from repro_torch.core import hwcost as hw
from repro_torch.core import netlist as nl
from repro_torch.core.specs import TABLE1_KINDS, AdderSpec, paper_spec

CPU = "cpu"
HW = ("transistors", "energy_fj", "delay_ns", "power_uw")


def ref_spec(s):
    return RefSpec(s.kind, s.n_bits, s.lsm_bits, s.const_bits)


def ref_mul(s):
    return RefMulSpec(s.kind, s.n_bits, s.trunc_bits, s.row_bits)


def hw_fields(r):
    return tuple(getattr(r, f) for f in HW)


def test_netlist_counts_equal_reference():
    for spec in an.design_space((8, 16, 32)):
        r = ref_spec(spec)
        assert nl.transistor_count(spec) == ref_nl.transistor_count(r)
        assert nl.gate_count(spec) == ref_nl.gate_count(r)
        assert nl.lsm_gates(spec) == ref_nl.lsm_gates(r)
    for spec in an.mul_design_space((4, 8, 12)):
        r = ref_mul(spec)
        assert nl.mul_transistor_count(spec) == ref_nl.mul_transistor_count(r)
        assert nl.mul_gates(spec) == ref_nl.mul_gates(r)
        assert nl.mul_column_heights(spec) == ref_nl.mul_column_heights(r)
        assert nl.mul_gate_count(spec) == ref_nl.mul_gate_count(r)


@pytest.mark.parametrize("kind", TABLE1_KINDS + ("eta",))
def test_report_equals_reference(kind):
    spec = paper_spec(kind)
    got = hw.report(spec, device=CPU)
    want = ref_hw.report(ref_spec(spec))
    assert hw_fields(got) == hw_fields(want)
    assert got.row() == {**want.row()}
    assert hw.switching_power_uw(spec, device=CPU) == \
        ref_hw.switching_power_uw(ref_spec(spec))
    assert hw.energy_per_add_joules(spec, device=CPU) == \
        ref_hw.energy_per_add_joules(ref_spec(spec))


def test_reports_at_other_widths_equal_reference():
    for spec in (AdderSpec("haloc_axa", 16, 8, 4), AdderSpec("loa", 8, 3, 0),
                 AdderSpec("eta", 16, 12, 0), AdderSpec("accurate", 16)):
        assert hw_fields(hw.report(spec, device=CPU)) == \
            hw_fields(ref_hw.report(ref_spec(spec)))


@pytest.mark.parametrize("kind", ["accurate", "truncated", "broken_array",
                                  "mitchell"])
def test_mul_reports_equal_reference(kind):
    for spec in an.mul_design_space((8,), kinds=(kind,))[::2]:
        assert hw_fields(hw.mul_report(spec, device=CPU)) == \
            hw_fields(ref_hw.mul_report(ref_mul(spec))), spec
        assert hw.mul_delay_ns(spec) == ref_hw.mul_delay_ns(ref_mul(spec))


def test_mac_reports_equal_reference():
    for adder in ("accurate", "haloc_axa"):
        for mul in (MulSpec("truncated", 8, 3), MulSpec("mitchell", 8, 2),
                    MulSpec("broken_array", 8, 3, 2)):
            got = hw.mac_report(paper_spec(adder), mul, device=CPU)
            want = ref_hw.mac_report(ref_spec(paper_spec(adder)),
                                     ref_mul(mul))
            assert hw_fields(got) == hw_fields(want)
            assert got.row() == {**want.row()}
            assert hw.energy_per_mac_joules(paper_spec(adder), mul,
                                            device=CPU) == \
                ref_hw.energy_per_mac_joules(ref_spec(paper_spec(adder)),
                                             ref_mul(mul))


def test_paper_table1_is_the_reference_table():
    assert hw.PAPER_TABLE1 == ref_hw.PAPER_TABLE1


def test_popcount_counts_bits():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 1 << 63, 4096, dtype=np.int64)
    x[:4] = (0, 1, (1 << 63) - 1, 1 << 62)
    got = hw.popcount(torch.from_numpy(x)).numpy()
    assert got.tolist() == [bin(int(v)).count("1") for v in x]


# ------------------------------ the reference's tests/test_hwcost.py --

def test_transistor_counts_vs_table1():
    exact = {"accurate", "loa", "loawa", "oloca"}
    for kind in TABLE1_KINDS:
        t = nl.transistor_count(paper_spec(kind))
        p = hw.PAPER_TABLE1[kind]["trans"]
        if kind in exact:
            assert t == p, (kind, t, p)
        else:
            assert abs(t - p) <= 60, (kind, t, p)


def test_energy_anchors_and_predictions():
    for kind in ("accurate", "loa"):
        assert abs(hw.switching_energy_fj(paper_spec(kind), device=CPU)
                   - hw.PAPER_TABLE1[kind]["energy_fj"]) < 1e-6
    for kind in ("loawa", "oloca", "herloa", "m_herloa", "haloc_axa"):
        e = hw.switching_energy_fj(paper_spec(kind), device=CPU)
        p = hw.PAPER_TABLE1[kind]["energy_fj"]
        assert abs(e - p) / p < 0.08, (kind, e, p)


def test_haloc_is_cheapest_of_accuracy_improved():
    e = {k: hw.switching_energy_fj(paper_spec(k), device=CPU)
         for k in TABLE1_KINDS}
    for other in ("accurate", "loa", "loawa", "herloa", "m_herloa"):
        assert e["haloc_axa"] < e[other], (other, e)


def test_delay_model():
    assert hw.delay_ns(paper_spec("accurate")) == pytest.approx(0.24)
    for kind in TABLE1_KINDS:
        if kind != "accurate":
            assert hw.delay_ns(paper_spec(kind)) == pytest.approx(0.21)


def test_lsm_gate_inventories():
    g = nl.lsm_gates(paper_spec("haloc_axa"))
    assert g == {"or2": 4, "and2": 2, "xor2": 2}
    assert nl.gate_count(paper_spec("loa")) == 11
    assert nl.lsm_gates(paper_spec("accurate")) == {"or2": 0, "and2": 0,
                                                    "xor2": 0}


def test_report_row():
    r = hw.report(paper_spec("haloc_axa"), device=CPU)
    assert r.transistors == 1538
    assert 45 < r.energy_fj < 60
    assert r.power_uw == pytest.approx(r.energy_fj / r.delay_ns)


def test_default_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hw.report(paper_spec("haloc_axa"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hw.mul_report(MulSpec("truncated", 8, 3))
