"""Switching energy / power / delay model, calibrated to Table I (the port
of ``repro.core.hwcost``).

The paper measures avg switching power/delay/energy in HSPICE (32nm PTM,
high-performance).  Without SPICE we use a standard activity-based model:

    E_op  =  sum_over_gates  C_gate * Vdd^2 * alpha_gate

where C_gate is proportional to the gate's transistor count (switched
capacitance proxy) and alpha_gate is the gate's measured toggle activity
over random input vectors (from the bit-exact behavioral simulation).

Calibration: an affine fit on the ACCURATE and LOA adders' Table-I
energies; every other adder's energy is then PREDICTED.

Delay: the paper reports 0.24 ns for the accurate 32-bit CLA and 0.21 ns
for every approximate adder (the (N-m)-bit MSM dominates; all LSMs are
single-gate-depth).  We model delay as CLA group-chain depth * per-stage
delay, calibrated on those two points.

The toggle activities draw the reference's random vectors (numpy
``default_rng``, seeds 11 and 13), run the adder's full sum
(``add_full``) or the multiplier's product through the ``"torch"``
backend's lanes on ``device`` and count the flipped bits with a popcount
there, so every report equals the reference's bit for bit.  Every entry
takes ``device=None``, which is the card; without a CUDA device that
default raises and names ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

from repro_torch.core import specs as S
from repro_torch.core.metrics import analysis_device
from repro_torch.core.netlist import (
    T_AND2, T_OR2, T_XOR2, lsm_gates, mul_column_heights,
    mul_transistor_count, transistor_count, _cla_transistors,
)
from repro_torch.core.specs import AdderSpec
from repro_torch.obs.caches import register_lru as _register_lru

# Table-I anchors (paper, 32nm PTM HP, 32-bit, m=10, k=5).
PAPER_TABLE1 = {
    "accurate": {"trans": 2208, "power_uw": 302.19, "delay_ns": 0.24,
                 "energy_fj": 66.25, "med": None, "mred": None},
    "loa": {"trans": 1548, "power_uw": 242.18, "delay_ns": 0.21,
            "energy_fj": 55.05, "med": 191.9, "mred": 6.19e-8},
    "loawa": {"trans": 1542, "power_uw": 237.86, "delay_ns": 0.21,
              "energy_fj": 53.42, "med": 255.7, "mred": 8.25e-8},
    "oloca": {"trans": 1518, "power_uw": 226.69, "delay_ns": 0.21,
              "energy_fj": 51.71, "med": 190.6, "mred": 6.15e-8},
    "herloa": {"trans": 1632, "power_uw": 265.15, "delay_ns": 0.21,
               "energy_fj": 60.04, "med": 97.7, "mred": 2.94e-8},
    "m_herloa": {"trans": 1572, "power_uw": 233.57, "delay_ns": 0.21,
                 "energy_fj": 52.92, "med": 94.9, "mred": 2.91e-8},
    "haloc_axa": {"trans": 1542, "power_uw": 226.39, "delay_ns": 0.21,
                  "energy_fj": 51.45, "med": 123.9, "mred": 3.77e-8},
}


@dataclasses.dataclass(frozen=True)
class HwReport:
    spec: AdderSpec
    transistors: int
    energy_fj: float
    delay_ns: float
    power_uw: float

    def row(self) -> Dict[str, object]:
        return {"adder": self.spec.kind, "transistors": self.transistors,
                "energy_fj": self.energy_fj, "delay_ns": self.delay_ns,
                "power_uw": self.power_uw}


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each non-negative int64 lane (SWAR: pair, nibble and
    byte sums, then the eight bytes folded by shifts; every step stays
    non-negative, so the shifts are logical)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def _flip_rate(out: torch.Tensor, width: int, n_vectors: int) -> float:
    """Average per-bit toggle rate of an output bus over consecutive
    vectors (``out`` int64 lanes, non-negative)."""
    ones = int(popcount(out[1:] ^ out[:-1]).sum())
    return float(ones) / (n_vectors - 1) / width


def _vectors(n_bits: int, n_vectors: int, seed: int, device: torch.device):
    """The reference's random operand vectors, as int64 lanes on
    ``device``."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << n_bits, size=n_vectors, dtype=np.uint64)
    b = rng.integers(0, 1 << n_bits, size=n_vectors, dtype=np.uint64)
    return (torch.from_numpy(a.view(np.int64)).to(device),
            torch.from_numpy(b.view(np.int64)).to(device))


@functools.lru_cache(maxsize=None)
def _toggle_activity(spec: AdderSpec, device: torch.device,
                     n_vectors: int = 20000, seed: int = 11) -> float:
    """Average per-output-bit toggle rate of the adder over a random
    vector stream (proxy for internal switching activity)."""
    from repro_torch.ax import make_engine
    a, b = _vectors(spec.n_bits, n_vectors, seed, device)
    s = make_engine(spec, backend="torch", device=device).add_full(a, b)
    return _flip_rate(s, spec.n_bits + 1, n_vectors)


# Energy split: the MSM (carry logic) toggles more than the LSM's
# single-level gates.  Weight MSM transistors by the adder's output toggle
# activity and LSM gates by their input activity (0.5 for uniform bits).
_LSM_ALPHA = 0.5


_register_lru("core.hwcost.toggle", _toggle_activity)


def _energy_units(spec: AdderSpec, device: torch.device) -> float:
    msm_t = (_cla_transistors(spec.n_bits) if spec.kind == S.ACCURATE
             else _cla_transistors(spec.msm_bits))
    act = _toggle_activity(spec, device)
    g = lsm_gates(spec)
    lsm_t = g["or2"] * T_OR2 + g["and2"] * T_AND2 + g["xor2"] * T_XOR2
    return msm_t * act + lsm_t * _LSM_ALPHA


@functools.lru_cache(maxsize=None)
def _calibration(device: torch.device):
    """Affine fit E = alpha * units + beta on TWO anchors (accurate, LOA);
    the remaining five adders' energies are PREDICTIONS.  beta captures
    activity-independent overheads (input loading, output buffers) that
    unit-scaling alone misses."""
    u_acc = _energy_units(AdderSpec(kind=S.ACCURATE, n_bits=32), device)
    u_loa = _energy_units(AdderSpec(kind=S.LOA, n_bits=32, lsm_bits=10,
                                    const_bits=0), device)
    e_acc = PAPER_TABLE1["accurate"]["energy_fj"]
    e_loa = PAPER_TABLE1["loa"]["energy_fj"]
    alpha = (e_acc - e_loa) / (u_acc - u_loa)
    beta = e_acc - alpha * u_acc
    return alpha, beta


def switching_energy_fj(spec: AdderSpec, device=None) -> float:
    dev = analysis_device(device)
    alpha, beta = _calibration(dev)
    return alpha * _energy_units(spec, dev) + beta


def delay_ns(spec: AdderSpec) -> float:
    """CLA group-chain model calibrated on (32b -> 0.24ns, 22b -> 0.21ns)."""
    bits = spec.n_bits if spec.kind == S.ACCURATE else spec.msm_bits
    groups = -(-bits // 4)
    # delay = a + b * groups; fit on (8 groups, 0.24) and (6 groups, 0.21)
    a_c, b_c = 0.12, 0.015
    return a_c + b_c * groups


def switching_power_uw(spec: AdderSpec, device=None) -> float:
    # fJ / ns == microwatt
    return switching_energy_fj(spec, device) / delay_ns(spec)


def report(spec: AdderSpec, device=None) -> HwReport:
    e = switching_energy_fj(spec, device)
    d = delay_ns(spec)
    return HwReport(spec=spec, transistors=transistor_count(spec),
                    energy_fj=e, delay_ns=d, power_uw=e / d)


def energy_per_add_joules(spec: AdderSpec, device=None) -> float:
    return switching_energy_fj(spec, device) * 1e-15


# ------------------------------------------------------- multipliers --
#
# Same activity-based model, same (alpha, beta) calibration, applied to
# the multiplier netlists of repro_torch.core.netlist: switched
# capacitance ~ transistor count, activity measured on the multiplier's
# own output bus over random vectors.


@dataclasses.dataclass(frozen=True)
class MulHwReport:
    spec: object                      # MulSpec (core stays import-light)
    transistors: int
    energy_fj: float
    delay_ns: float
    power_uw: float

    def row(self) -> Dict[str, object]:
        return {"mul": self.spec.kind, "N": self.spec.n_bits,
                "t": self.spec.effective_trunc_bits,
                "v": self.spec.effective_row_bits,
                "transistors": self.transistors,
                "energy_fj": self.energy_fj, "delay_ns": self.delay_ns,
                "power_uw": self.power_uw}


@functools.lru_cache(maxsize=None)
def _mul_toggle_activity(spec, device: torch.device, n_vectors: int = 20000,
                         seed: int = 13) -> float:
    """Average per-output-bit toggle rate of the multiplier's product
    bus over a random vector stream (the ``"torch"`` backend's lane
    multiply, reference form)."""
    from repro_torch.kernels.mul import mul_lanes
    a, b = _vectors(spec.n_bits, n_vectors, seed, device)
    p = mul_lanes(a, b, spec, "reference")
    return _flip_rate(p, spec.product_bits, n_vectors)


_register_lru("core.hwcost.mul_toggle", _mul_toggle_activity)


def mul_switching_energy_fj(spec, device=None) -> float:
    dev = analysis_device(device)
    alpha, beta = _calibration(dev)
    return alpha * mul_transistor_count(spec) \
        * _mul_toggle_activity(spec, dev) + beta


def mul_delay_ns(spec) -> float:
    """Stage-count model on the adder family's per-stage constants:
    array kinds pay a Dadda-style reduction depth (log_{1.5} of the
    tallest kept column) plus the final CPA's group chain; Mitchell
    pays LOD + barrel-shifter depth plus its mantissa adder chain."""
    a_c, b_c = 0.12, 0.015
    n = spec.n_bits
    if spec.kind == "mitchell":
        lod_shift = 2 * max(1, (n - 1).bit_length())
        groups = -(-2 * (n - spec.effective_trunc_bits) // 4)
        return a_c + b_c * (lod_shift + groups)
    hmax = max(mul_column_heights(spec) + [1])
    depth = 0
    h = 1
    while h < hmax:
        h = (h * 3 + 1) // 2           # Dadda column-height sequence
        depth += 1
    groups = -(-2 * n // 4)
    return a_c + b_c * (depth + groups)


def mul_report(spec, device=None) -> MulHwReport:
    e = mul_switching_energy_fj(spec, device)
    d = mul_delay_ns(spec)
    return MulHwReport(spec=spec, transistors=mul_transistor_count(spec),
                       energy_fj=e, delay_ns=d, power_uw=e / d)


@dataclasses.dataclass(frozen=True)
class MacHwReport:
    """One multiply-accumulate lane: multiplier followed by the
    accumulating adder (serial critical path, summed energy/area)."""
    adder: HwReport
    mul: MulHwReport
    transistors: int
    energy_fj: float
    delay_ns: float
    power_uw: float

    def row(self) -> Dict[str, object]:
        return {"adder": self.adder.spec.kind,
                "mul": self.mul.spec.kind,
                "mul_N": self.mul.spec.n_bits,
                "mul_t": self.mul.spec.effective_trunc_bits,
                "mul_v": self.mul.spec.effective_row_bits,
                "transistors": self.transistors,
                "energy_fj": self.energy_fj, "delay_ns": self.delay_ns,
                "power_uw": self.power_uw}


def mac_report(adder_spec: AdderSpec, mul_spec, device=None) -> MacHwReport:
    ar = report(adder_spec, device)
    mr = mul_report(mul_spec, device)
    e = ar.energy_fj + mr.energy_fj
    d = ar.delay_ns + mr.delay_ns
    return MacHwReport(adder=ar, mul=mr,
                       transistors=ar.transistors + mr.transistors,
                       energy_fj=e, delay_ns=d, power_uw=e / d)


def energy_per_mac_joules(adder_spec: AdderSpec, mul_spec,
                          device=None) -> float:
    return mac_report(adder_spec, mul_spec, device).energy_fj * 1e-15
