"""The port's integrity layer (``repro_torch.integrity``,
``repro_torch.ioutil``, ``detection_campaign``) against
``repro.integrity``, on the CPU.  Equality throughout: the datapath is
integer and the float budgets are computed from the same integers in the
same order.

One counterpart per test of ``tests/test_integrity.py`` (the
checkpointer test stays with the reference: the port has no
checkpointer), each holding the port to the reference on the same
seeded inputs where the reference computes the same thing:

- golden digests equal to the reference's for every cache name, and a
  device copy's digest equal to its host table's;
- ``ScrubReport`` labels; a corruption burned into the copy the kernels
  gather from is found there and repaired in place;
- ``CanaryReport``s of healthy and bus-faulted engines;
- ``AbftVerdict``s: ``out``, flags, ``max_deviation``, ``budget``;
- the persistent cache's round trip, corruption, truncation and salt;
- ``detection_campaign(quick=True, backend="torch")`` records equal to
  the reference's numpy records apart from ``backend``.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from repro import integrity as ref_integrity
from repro.ax import engine as ref_engine
from repro.ax import lut as ref_lut
from repro.ax.mul import lut as ref_mul_lut
from repro.ax.mul.specs import MulSpec as RefMulSpec
from repro.core.specs import AdderSpec as RefSpec
from repro.numerics.fixed_point import FixedPointFormat as RefFmt
from repro.resilience.faults import FaultSpec as RefFaultSpec
from repro_torch import ioutil, obs
from repro_torch.ax.engine import make_engine
from repro_torch.ax import lut as lut_lib
from repro_torch.ax.lut import _canonical, compile_lut, device_table
from repro_torch.ax.mul import lut as mul_lut
from repro_torch.ax.mul.specs import MulSpec
from repro_torch.ax.registry import get_adder, registered_kinds
from repro_torch.core.specs import AdderSpec
from repro_torch.integrity import (AbftChecker, CanarySuite, LutScrubber,
                                   PersistentCache, expected_add_outputs,
                                   golden_entries, mac_error_budget,
                                   make_probe, scrub_entries, table_digest,
                                   verify_engine_tables, verify_entry)
from repro_torch.integrity.digests import golden_digest, record_golden
from repro_torch.integrity.store import activate, active_cache, deactivate
from repro_torch.numerics.fixed_point import FixedPointFormat
from repro_torch.resilience.faults import FaultSpec
from repro_torch.serving.clock import VirtualClock

CPU = dict(backend="torch", device="cpu")
DEV = torch.device("cpu")
SPEC = AdderSpec("haloc_axa", 16, lsm_bits=8, const_bits=4)
REF_SPEC = RefSpec("haloc_axa", 16, lsm_bits=8, const_bits=4)
FMT16 = FixedPointFormat(16, 0)
MUL = MulSpec("broken_array", 8, 3, 1)
REF_MUL = RefMulSpec("broken_array", 8, 3, 1)


@pytest.fixture()
def fresh_obs():
    obs.reset_all()
    obs.enable()
    yield
    obs.disable()
    obs.reset_all()


def _corrupt_in_place(table, idx, bitmask):
    """Flip ``bitmask`` at flat ``idx`` of a host array or a tensor."""
    if isinstance(table, torch.Tensor):
        flat = table.view(-1)
        flat[idx] ^= bitmask
        return
    table.flags.writeable = True
    table[idx] ^= type(table[idx])(bitmask)
    table.flags.writeable = False


def _entry(cache, key):
    return next(e for e in golden_entries(cache) if e.key == key)


def _dev_key(spec):
    return (_canonical(spec), DEV)


def _report_fields(r):
    return (r.checked, r.add_mismatches, r.mul_mismatches, r.at)


# --------------------------------------------------------- ioutil --

def test_sha256_helpers_agree(tmp_path):
    from repro import ioutil as ref_ioutil
    payload = b"approximate adders\x00\xff" * 97
    p = tmp_path / "blob.bin"
    p.write_bytes(payload)
    assert ioutil.sha256_file(str(p)) == ioutil.sha256_bytes(payload)
    assert ioutil.sha256_bytes(payload) == ref_ioutil.sha256_bytes(payload)


def test_atomic_write_bytes_replaces_and_leaves_no_tmp(tmp_path):
    p = tmp_path / "entry.npy"
    ioutil.atomic_write_bytes(str(p), b"first")
    ioutil.atomic_write_bytes(str(p), b"second")
    assert p.read_bytes() == b"second"
    assert [f for f in os.listdir(tmp_path) if f.startswith(".tmp")] == []


def test_atomic_replace_dir(tmp_path):
    tmp = tmp_path / "stage"
    tmp.mkdir()
    (tmp / "a.txt").write_text("x")
    final = tmp_path / "published"
    final.mkdir()
    (final / "stale.txt").write_text("old")
    ioutil.atomic_replace_dir(str(tmp), str(final))
    assert (final / "a.txt").read_text() == "x"
    assert not (final / "stale.txt").exists()
    assert not tmp.exists()


# ------------------------------------------------- golden registry --

def test_table_digest_sensitive_to_content_dtype_shape():
    a = np.arange(16, dtype=np.uint16)
    assert table_digest(a) == table_digest(a.copy())
    assert table_digest(a) == ref_integrity.table_digest(a)
    assert table_digest(a) != table_digest(a.astype(np.int32))
    assert table_digest(a) != table_digest(a.reshape(4, 4))
    b = a.copy()
    b[3] ^= 1
    assert table_digest(a) != table_digest(b)
    # a tensor holding the pattern hashes as the pattern it holds
    t16 = torch.from_numpy(a.view(np.int16).copy())
    assert table_digest(t16, np.uint16) == table_digest(a)
    assert table_digest(t16) != table_digest(a)
    t32 = torch.from_numpy(a.astype(np.int32))
    assert table_digest(t32, np.uint16) == table_digest(a)


def test_compile_registers_golden_and_verifies():
    table = compile_lut(SPEC)
    key = (_canonical(SPEC),)
    entries = [e for e in golden_entries("ax.lut.packed") if e.key == key]
    assert len(entries) == 1
    assert entries[0].table is table
    assert verify_entry(entries[0])
    live = device_table(SPEC, "cpu")
    entry = _entry("ax.lut.device", _dev_key(SPEC))
    assert entry.table is live and verify_entry(entry)
    assert entry.digest == entries[0].digest


def _port_and_ref_tables():
    """(cache, port key, port builder, reference key, reference builder)
    for every host cache name."""
    canon, rcanon = _canonical(SPEC), ref_lut._canonical(REF_SPEC)
    mc, rmc = mul_lut._canonical(MUL), ref_mul_lut._canonical(REF_MUL)
    w = (1, -3, 5)
    return [
        ("ax.lut.packed", (canon,), lambda: compile_lut(SPEC),
         (rcanon,), lambda: ref_lut.compile_lut(REF_SPEC)),
        ("ax.lut.delta", (canon,), lambda: lut_lib.error_delta_table(SPEC),
         (rcanon,), lambda: ref_lut.error_delta_table(REF_SPEC)),
        ("ax.lut.abs_error", (canon,), lambda: lut_lib.abs_error_table(SPEC),
         (rcanon,), lambda: ref_lut.abs_error_table(REF_SPEC)),
        ("ax.mul.lut.product", (mc,), lambda: mul_lut.compile_mul_lut(MUL),
         (rmc,), lambda: ref_mul_lut.compile_mul_lut(REF_MUL)),
        ("ax.mul.lut.delta", (mc,),
         lambda: mul_lut.mul_error_delta_table(MUL),
         (rmc,), lambda: ref_mul_lut.mul_error_delta_table(REF_MUL)),
        ("ax.mul.lut.signed", (mc,), lambda: mul_lut.signed_mul_table(MUL),
         (rmc,), lambda: ref_mul_lut.signed_mul_table(REF_MUL)),
        ("ax.mul.lut.taps", (mc, w), lambda: mul_lut.tap_tables(MUL, w),
         (rmc, w), lambda: ref_mul_lut.tap_tables(REF_MUL, w)),
    ]


@pytest.mark.parametrize("case", range(7))
def test_golden_digests_equal_the_references(case):
    cache, key, build, ref_key, ref_build = _port_and_ref_tables()[case]
    build()
    ref_build()
    got = golden_digest(cache, key)
    assert got is not None
    assert got == ref_integrity.golden_digest(cache, ref_key)
    # and the rebuild closure reproduces the golden off-cache
    entry = _entry(cache, key)
    assert table_digest(entry.rebuild(), entry.pattern) == got


def test_device_copies_carry_their_host_tables_digest():
    w = (1, -3, 5)
    canon, mc = _canonical(SPEC), mul_lut._canonical(MUL)
    device_table(SPEC, "cpu")
    lut_lib.device_abs_error_table(SPEC, "cpu")
    mul_lut.device_mul_table(MUL, "cpu")
    mul_lut.device_signed_table(MUL, "cpu")
    mul_lut.device_signed_table16(MUL, "cpu")
    mul_lut.device_tap_tables(MUL, w, "cpu")
    pairs = [("ax.lut.device", (canon, DEV), "ax.lut.packed", (canon,)),
             ("ax.lut.device_abs_error", (canon, DEV), "ax.lut.abs_error",
              (canon,)),
             ("ax.mul.lut.device", (mc, DEV), "ax.mul.lut.product", (mc,)),
             ("ax.mul.lut.device_signed", (mc, DEV), "ax.mul.lut.signed",
              (mc,)),
             ("ax.mul.lut.device_signed16", (mc, DEV), "ax.mul.lut.signed",
              (mc,)),
             ("ax.mul.lut.device_taps", (mc, w, DEV), "ax.mul.lut.taps",
              (mc, w))]
    for cache, key, host_cache, host_key in pairs:
        entry = _entry(cache, key)
        assert isinstance(entry.table, torch.Tensor), cache
        host = golden_digest(host_cache, host_key)
        assert entry.digest == host, cache
        assert table_digest(entry.table, entry.pattern) == host, cache
    # conv2d_mac's signed tap tables: a derived table, keyed spec first
    from repro_torch.kernels.conv2d_mac import signed_tap_tables
    t = signed_tap_tables(MUL, w, 16, "cpu")
    entry = _entry("kernels.conv2d_mac.signed_taps", (mc, w, 16, DEV))
    assert entry.table is t and verify_entry(entry)


@pytest.mark.parametrize("bit", [3, 15, 16, 20, 30])
def test_device_abs_error_flip_in_any_bit_found_and_repaired(bit):
    """``ax.lut.device_abs_error`` is an int32 copy of a uint16 table: a
    flip in its upper half (bits 16-31) is no value of the pattern, so
    it must fail the digest and not be narrowed away."""
    canon = _canonical(SPEC)
    live = lut_lib.device_abs_error_table(SPEC, "cpu")
    healthy = live.clone()
    entry = _entry("ax.lut.device_abs_error", (canon, DEV))
    assert verify_entry(entry)
    _corrupt_in_place(live, 77, 1 << bit)
    assert not verify_entry(entry)
    report = LutScrubber(cache="ax.lut.device_abs_error").scrub_once(0.0)
    label = ("ax.lut.device_abs_error", repr((canon, DEV)))
    assert label in report.corrupted and label in report.repaired
    assert torch.equal(live, healthy)


def test_derived_device_copy_never_bakes_in_a_corrupted_host_table():
    """``conv2d_mac``'s signed tap rows are derived from the host tap
    tables at upload: a host table corrupted before the upload gives a
    device copy that fails its golden (taken from a fresh build) and is
    repaired to the healthy rows."""
    from repro_torch.kernels import conv2d_mac as conv_k
    w = (3, -7, 2, 5)
    mc = mul_lut._canonical(MUL)
    taps = mul_lut.tap_tables(MUL, w)
    taps.flags.writeable = True
    taps[1, 9] ^= 1 << 4
    taps.flags.writeable = False
    rows = conv_k.signed_tap_tables(MUL, w, 16, "cpu")
    entry = _entry("kernels.conv2d_mac.signed_taps", (mc, w, 16, DEV))
    assert not verify_entry(entry)
    report = scrub_entries([_entry("ax.mul.lut.taps", (mc, w)), entry])
    assert report.repaired == (("ax.mul.lut.taps", repr((mc, w))),
                               ("kernels.conv2d_mac.signed_taps",
                                repr((mc, w, 16, DEV))))
    want = conv_k._signed_rows(mul_lut._tap_tables_nocache(MUL, w), 16)
    assert torch.equal(rows, torch.from_numpy(want))


# ------------------------------------------------------- scrubbing --

def test_scrub_detects_and_repairs_in_place():
    table = compile_lut(SPEC)
    live = device_table(SPEC, "cpu")
    golden = table.copy()
    golden_live = live.clone()
    a = np.arange(1 << 12, dtype=np.int64)
    b = a[::-1].copy()
    eng = make_engine(SPEC, strategy="lut", **CPU)
    want = eng.add(a, b).clone()

    # (a_low, b_low) = (0, 255) is gathered by every 256th pair
    _corrupt_in_place(table, 255, 1 << 3)
    _corrupt_in_place(live, 255, 1 << 3)
    assert not torch.equal(eng.add(a, b), want)   # the gather sees it
    canon = _canonical(SPEC)
    report = scrub_entries([_entry("ax.lut.packed", (canon,)),
                            _entry("ax.lut.device", (canon, DEV))])
    assert not report.ok and not report.unrepaired
    assert report.repaired == (("ax.lut.packed", repr((canon,))),
                               ("ax.lut.device", repr((canon, DEV))))
    np.testing.assert_array_equal(table, golden)
    assert torch.equal(live, golden_live)
    # the engine gathers from the same tensor: bit-identical again
    assert torch.equal(eng.add(a, b), want)
    # the reference labels its host entry the same way
    ref_table = ref_lut.compile_lut(REF_SPEC)
    _corrupt_in_place(ref_table, 255, 1 << 3)
    ref_report = ref_integrity.scrub_entries(
        [e for e in ref_integrity.golden_entries("ax.lut.packed")
         if e.key == (ref_lut._canonical(REF_SPEC),)])
    assert ref_report.repaired == report.repaired[:1]


def test_scrubber_cadence_on_virtual_clock():
    clk = VirtualClock()
    s = LutScrubber(interval_s=10.0, clock=clk, cache="ax.lut.device")
    device_table(SPEC, "cpu")
    assert s.maybe_run() is None            # not due yet
    clk.advance(10.5)
    first = s.maybe_run()
    assert first is not None and first.ok and first.at == 10.5
    assert first.checked == len(golden_entries("ax.lut.device"))
    assert s.maybe_run() is None            # cadence re-armed
    clk.advance(10.5)
    assert s.maybe_run() is not None
    assert s.runs == 2 and s.corruptions == 0


def test_patrol_scrubber_walks_the_registry_a_slice_a_run():
    """``slice_bytes``: each run hashes the next entries until it has
    covered that many bytes, wrapping around; a corruption is found
    within one walk of the registry."""
    cache = "test.patrol"
    tables = [np.full(8, i, dtype=np.uint16) for i in range(5)]
    for i, t in enumerate(tables):
        record_golden(cache, (i,), t, functools.partial(
            np.full, 8, i, dtype=np.uint16))
    clk = VirtualClock()
    s = LutScrubber(interval_s=1.0, clock=clk, cache=cache, slice_bytes=32)
    _corrupt_in_place(tables[3], 5, 1 << 9)
    labels = []
    for _ in range(3):
        clk.advance(1.0)
        r = s.maybe_run()
        labels.append((r.checked, r.corrupted))
    assert labels == [(2, ()), (2, ((cache, repr((3,))),)), (2, ())]
    assert s.repairs == 1 and int(tables[3][5]) == 3
    with pytest.raises(ValueError):
        LutScrubber(slice_bytes=0)


def test_scrubber_alarm_feed_trips_breaker_and_policy():
    from repro_torch.serving.breaker import CircuitBreaker, OPEN

    class _Policy:
        def __init__(self):
            self.alarms = []

        def force_fallback(self):
            return True

        def on_integrity_alarm(self, report):
            self.alarms.append(report)
            return True

    live = device_table(SPEC, "cpu")
    pol = _Policy()
    brk = CircuitBreaker()
    seen = []
    clk = VirtualClock()
    s = LutScrubber(interval_s=1.0, clock=clk, cache="ax.lut.device",
                    breaker=brk, policy=pol, alarm=seen.append)
    _corrupt_in_place(live, 0, 1)
    clk.advance(1.5)
    report = s.maybe_run()
    assert not report.ok and report.repaired
    assert report.corrupted == (("ax.lut.device",
                                 repr(_dev_key(SPEC))),)
    assert brk.state == OPEN and brk.trips == 1
    assert pol.alarms == [report] and seen == [report]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_unrepairable_corruption_stays_visible(as_tensor):
    """A corrupted table whose rebuild does NOT hash to the golden
    digest must not be silently 'repaired' with unverifiable data — a
    host array or a device copy."""
    live = np.arange(8, dtype=np.uint16)
    if as_tensor:
        entry_table = torch.from_numpy(live.view(np.int16).copy())
        bad = lambda: torch.zeros(8, dtype=torch.int16)  # noqa: E731
        cache = "test.unrepairable_device"
        record_golden(cache, ("k",), entry_table, bad, pattern=np.uint16)
    else:
        entry_table = live.copy()
        cache = "test.unrepairable"
        record_golden(cache, ("k",), entry_table,
                      lambda: np.zeros(8, dtype=np.uint16))  # bad rebuild
    entry = next(e for e in golden_entries(cache))
    _corrupt_in_place(entry_table, 2, 1)
    report = scrub_entries([entry])
    assert not report.ok and report.unrepaired and not report.repaired
    assert int(entry_table[2]) == 3   # untouched: corruption left visible
    # un-corrupt before leaving: later full-registry scrubs (e.g. the
    # detection campaign's healthy pass) walk this entry too
    _corrupt_in_place(entry_table, 2, 1)
    assert verify_entry(entry)


def test_verify_engine_tables_repairs_before_serving():
    make_engine(SPEC, strategy="lut", **CPU)
    table = compile_lut(SPEC)
    live = device_table(SPEC, "cpu")
    golden, golden_live = table.copy(), live.clone()
    _corrupt_in_place(table, 17, 1 << 2)
    _corrupt_in_place(live, 17, 1 << 2)
    report = verify_engine_tables(SPEC, device="cpu")
    assert set(report.repaired) == {
        ("ax.lut.packed", repr((_canonical(SPEC),))),
        ("ax.lut.device", repr(_dev_key(SPEC)))}
    np.testing.assert_array_equal(table, golden)
    assert torch.equal(live, golden_live)


def test_make_engine_integrity_knob_repairs():
    live = device_table(SPEC, "cpu")
    golden = live.clone()
    _corrupt_in_place(live, 9, 1 << 4)
    eng = make_engine(SPEC, strategy="lut", integrity=True, **CPU)
    assert torch.equal(live, golden)
    a, b = make_probe(SPEC.n_bits, n=64)
    got = eng.add(a.astype(np.int64), b.astype(np.int64))
    np.testing.assert_array_equal(got.numpy().astype(np.uint64)
                                  & np.uint64(0xFFFF),
                                  expected_add_outputs(SPEC, a, b))
    # an unrepairable device entry refuses to serve
    entry = _entry("ax.lut.device", _dev_key(SPEC))
    record_golden(entry.cache, entry.key, entry.table,
                  lambda: torch.zeros_like(live), pattern=np.uint16,
                  digest=entry.digest)
    try:
        _corrupt_in_place(live, 9, 1 << 4)
        with pytest.raises(IOError, match="unrepairable"):
            make_engine(SPEC, strategy="lut", integrity=True, **CPU)
    finally:
        _corrupt_in_place(live, 9, 1 << 4)
        record_golden(entry.cache, entry.key, entry.table, entry.rebuild,
                      pattern=np.uint16, digest=entry.digest)
    assert verify_entry(_entry("ax.lut.device", _dev_key(SPEC)))


def test_exhaustive_n8_single_bit_stuckat_detection():
    """For EVERY non-exact registered kind at N=8, EVERY single-bit
    stuck-at corruption of EVERY entry of the device copy the lut add
    gathers from is caught by the digest check, and one repair pass
    restores bit-identical ``engine.add`` in every strategy, equal to
    the reference's."""
    a, b = make_probe(8, n=512, seed=3)
    a64, b64 = a.astype(np.int64), b.astype(np.int64)
    for kind in registered_kinds():
        if get_adder(kind).is_exact:
            continue
        spec = AdderSpec(kind, 8, lsm_bits=4, const_bits=2)
        if not lut_lib.lut_supported(spec):
            continue
        live = device_table(spec, "cpu")
        golden = live.clone()
        flat = live.view(-1)
        entry = _entry("ax.lut.device", _dev_key(spec))
        width = spec.lsm_bits + 1          # low sum | carry
        missed = 0
        for idx in range(flat.numel()):
            clean = int(golden[idx])
            for bit in range(width):
                for stuck in (0, 1):
                    want = (clean | (1 << bit)) if stuck else \
                        (clean & ~(1 << bit))
                    if want == clean:
                        continue           # unobservable: no corruption
                    flat[idx] = want
                    if verify_entry(entry):
                        missed += 1
                    flat[idx] = clean
        assert missed == 0, f"{kind}: {missed} corruptions escaped"

        # one full detect+repair cycle, then cross-strategy bit-identity
        _corrupt_in_place(live, flat.numel() // 2, 1 << (width - 1))
        report = scrub_entries([entry])
        assert report.repaired
        assert torch.equal(live, golden)
        want = expected_add_outputs(spec, a, b)
        np.testing.assert_array_equal(
            want, ref_integrity.expected_add_outputs(
                RefSpec(kind, 8, lsm_bits=4, const_bits=2), a, b))
        for strategy in ("reference", "fused", "lut"):
            eng = make_engine(spec, strategy=strategy, **CPU)
            got = eng.add(a64, b64).numpy().astype(np.uint64) & 0xFF
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{kind}/{strategy}")


# ---------------------------------------------------------- canary --

@pytest.mark.parametrize("kind", ["haloc_axa", "loa", "eta"])
def test_canary_healthy_never_fails(kind):
    eng = make_engine(kind, strategy="lut", **CPU)
    report = CanarySuite(eng, n=256).run_once(0.0)
    assert report.ok, f"{kind}: {report}"
    ref = ref_integrity.CanarySuite(
        ref_engine.make_engine(kind, backend="numpy", strategy="lut"),
        n=256).run_once(0.0)
    assert _report_fields(report) == _report_fields(ref)


def test_canary_detects_output_bus_fault():
    fault = FaultSpec("stuck_at_1", bits=(13,))
    eng = make_engine("haloc_axa", strategy="lut", fault=fault, **CPU)
    suite = CanarySuite(eng)
    report = suite.run_once(0.0)
    assert not report.ok and report.add_mismatches > 0
    assert suite.failures == 1
    ref = ref_integrity.CanarySuite(ref_engine.make_engine(
        "haloc_axa", backend="numpy", strategy="lut",
        fault=RefFaultSpec("stuck_at_1", bits=(13,)))).run_once(0.0)
    assert _report_fields(report) == _report_fields(ref)


def test_canary_cadence_and_alarm():
    from repro_torch.serving.breaker import CircuitBreaker, OPEN
    fault = FaultSpec("bit_flip", bits=(5, 21), rate=0.25)
    clk = VirtualClock()
    brk = CircuitBreaker()
    eng = make_engine("haloc_axa", strategy="lut", fault=fault, **CPU)
    suite = CanarySuite(eng, interval_s=5.0, clock=clk, breaker=brk)
    assert suite.maybe_run() is None
    clk.advance(5.1)
    report = suite.maybe_run()
    assert report is not None and not report.ok
    assert brk.state == OPEN
    ref = ref_integrity.CanarySuite(ref_engine.make_engine(
        "haloc_axa", backend="numpy", strategy="lut",
        fault=RefFaultSpec("bit_flip", bits=(5, 21), rate=0.25)))
    assert _report_fields(report)[:3] == \
        _report_fields(ref.run_once(5.1))[:3]


def test_canary_covers_multiplier_products():
    eng = make_engine("haloc_axa", mul=MUL, **CPU)
    suite = CanarySuite(eng, n=128)
    report = suite.run_once(0.0)
    assert report.ok and report.checked > 128 + 5    # add + mul probes
    ref = ref_integrity.CanarySuite(ref_engine.make_engine(
        "haloc_axa", backend="numpy", mul=REF_MUL), n=128).run_once(0.0)
    assert _report_fields(report) == _report_fields(ref)
    # a multiplier whose products drift is caught by the mul probe alone
    bad = make_engine("haloc_axa", mul=MulSpec("broken_array", 8, 4, 1),
                      **CPU)
    suite._mul = CanarySuite(bad, n=128)._mul
    assert suite.run_once(0.0).mul_mismatches > 0


# ------------------------------------------------------------ abft --

def _verdict_equal(v, ref):
    np.testing.assert_array_equal(v.out.numpy(), np.asarray(ref.out))
    assert v.out.dtype == torch.int32
    assert (v.ok, v.flagged_rows, v.flagged_cols) == \
        (ref.ok, ref.flagged_rows, ref.flagged_cols)
    assert v.max_deviation == ref.max_deviation
    assert v.budget == ref.budget


def test_abft_budget_calibration_monotonic():
    b1 = mac_error_budget(SPEC, None, count=16, n_adds=1, n_products=0)
    b2 = mac_error_budget(SPEC, None, count=16, n_adds=4, n_products=0)
    assert 0 < b1 < b2
    assert b1 == ref_integrity.mac_error_budget(REF_SPEC, None, 16, 1, 0)
    exact = AdderSpec("accurate", 16)
    assert mac_error_budget(exact, None, 16, 4, 0) == 0.0
    assert mac_error_budget(SPEC, MUL, 1024, 3, 64) == \
        ref_integrity.mac_error_budget(REF_SPEC, REF_MUL, 1024, 3, 64)


def test_abft_matmul_healthy_and_fault_detection():
    rng = np.random.default_rng(7)
    a = rng.integers(-128, 128, size=(24, 48), dtype=np.int64) \
        .astype(np.int8)
    b = rng.integers(-128, 128, size=(48, 32), dtype=np.int64) \
        .astype(np.int8)
    eng = make_engine("haloc_axa", **CPU)
    ref_eng = ref_engine.make_engine("haloc_axa", backend="numpy")
    ck, ref_ck = AbftChecker(eng), ref_integrity.AbftChecker(ref_eng)
    block = (128, 128, 16)
    v = ck.matmul(a, b, block=block)
    assert v.ok and not v.flagged_cols and not v.flagged_rows
    _verdict_equal(v, ref_ck.matmul(a, b, block=block))

    out = eng.matmul(a, b, block=block).clone()
    out[:, 3] ^= 1 << 19                       # stuck bus bit, one col
    v2 = ck.verify_matmul(out, a, b, block=block)
    assert not v2.ok and 3 in v2.flagged_cols
    exact = a.astype(np.int64) @ b.astype(np.int64)
    np.testing.assert_array_equal(v2.out[:, 3].numpy().astype(np.int64),
                                  exact[:, 3])
    assert ck.checks == 2 and ck.flags == 1
    _verdict_equal(v2, ref_ck.verify_matmul(out.numpy(), a, b,
                                            block=block))
    # a flagged row is recomputed on its own
    out = eng.matmul(a, b, block=block).clone()
    out[5, :] |= 1 << 20
    v3 = ck.verify_matmul(out, a, b, block=block)
    assert 5 in v3.flagged_rows
    np.testing.assert_array_equal(v3.out[5].numpy(), exact[5])
    _verdict_equal(v3, ref_ck.verify_matmul(out.numpy(), a, b,
                                            block=block))


def test_abft_matmul_healthy_with_approx_multiplier():
    rng = np.random.default_rng(9)
    a = rng.integers(-128, 128, size=(16, 64), dtype=np.int64) \
        .astype(np.int8)
    b = rng.integers(-128, 128, size=(64, 16), dtype=np.int64) \
        .astype(np.int8)
    eng = make_engine("haloc_axa", mul="broken_array", **CPU)
    v = AbftChecker(eng).matmul(a, b, block=(128, 128, 16))
    assert v.ok
    ref = ref_integrity.AbftChecker(ref_engine.make_engine(
        "haloc_axa", backend="numpy", mul="broken_array")).matmul(
            a, b, block=(128, 128, 16))
    _verdict_equal(v, ref)


def test_abft_conv2d_healthy_and_fault_detection():
    rng = np.random.default_rng(11)
    eng = make_engine(SPEC, fmt=FMT16, mul=MUL, **CPU)
    ref_eng = ref_engine.make_engine(
        REF_SPEC, fmt=RefFmt(16, 0), backend="numpy",
        mul=REF_MUL)
    kernel = ((1, 3, 1), (3, -5, 3), (1, 3, 1))
    q = rng.integers(-255, 256, size=(3, 24, 24)).astype(np.int32)
    ck, ref_ck = AbftChecker(eng), ref_integrity.AbftChecker(ref_eng)
    v = ck.conv2d(q, kernel, shift=2)
    assert v.ok
    _verdict_equal(v, ref_ck.conv2d(q, kernel, shift=2))

    out = eng.conv2d(q, kernel, shift=2).clone()
    out[1] |= 1 << 12                          # stuck bus bit, one image
    v2 = ck.verify_conv2d(out, q, kernel, shift=2)
    assert not v2.ok and v2.flagged_rows == (1,)
    # flagged image recomputed on the exact datapath
    p = np.pad(q[1].astype(np.int64), 1, mode="edge")
    acc = np.zeros((24, 24), dtype=np.int64)
    for r in range(3):
        for c in range(3):
            acc += kernel[r][c] * p[r:r + 24, c:c + 24]
    np.testing.assert_array_equal(v2.out[1].numpy(), (acc + 2) >> 2)
    _verdict_equal(v2, ref_ck.verify_conv2d(out.numpy(), q, kernel,
                                            shift=2))
    # the exact-product path: w * sum(view), no table; one 2-D image
    exact_eng = make_engine(SPEC, fmt=FMT16, mul="accurate", **CPU)
    ref_exact = ref_engine.make_engine(
        REF_SPEC, fmt=RefFmt(16, 0), backend="numpy",
        mul="accurate")
    v3 = AbftChecker(exact_eng).conv2d(q[0], kernel, shift=0)
    _verdict_equal(v3, ref_integrity.AbftChecker(ref_exact).conv2d(
        q[0], kernel, shift=0))


# ---------------------------------------------- persistent store --

def test_persistent_cache_roundtrip(tmp_path):
    cache = PersistentCache(str(tmp_path))
    table = np.arange(64, dtype=np.uint16)
    cache.put("unit", ("spec", 1), table)
    got = cache.get("unit", ("spec", 1))
    np.testing.assert_array_equal(got, table)
    assert not got.flags.writeable
    assert cache.hits == 1 and cache.corrupt == 0
    assert cache.get("unit", ("other", 2)) is None
    assert cache.misses == 1
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert len(manifest) == 1


def test_persistent_cache_never_serves_corruption(tmp_path):
    cache = PersistentCache(str(tmp_path))
    table = np.arange(256, dtype=np.uint16)
    cache.put("unit", "k", table)
    entry = next(p for p in tmp_path.iterdir() if p.suffix == ".npy")
    raw = bytearray(entry.read_bytes())
    raw[-3] ^= 0x40
    entry.write_bytes(bytes(raw))
    assert cache.get("unit", "k") is None      # detected, dropped
    assert cache.corrupt == 1
    assert not entry.exists()                  # corrupt entry deleted
    # and a rebuilt put serves again
    cache.put("unit", "k", table)
    np.testing.assert_array_equal(cache.get("unit", "k"), table)


def test_persistent_cache_never_serves_truncation(tmp_path):
    cache = PersistentCache(str(tmp_path))
    cache.put("unit", "k", np.arange(1024, dtype=np.int32))
    entry = next(p for p in tmp_path.iterdir() if p.suffix == ".npy")
    entry.write_bytes(entry.read_bytes()[:100])   # torn write
    assert cache.get("unit", "k") is None
    assert cache.corrupt == 1


def test_persistent_cache_version_salt_invalidates(tmp_path):
    from repro_torch.integrity import store
    a = PersistentCache(str(tmp_path), salt="v1")
    b = PersistentCache(str(tmp_path), salt="v2")
    a.put("unit", "k", np.ones(4))
    assert b.get("unit", "k") is None
    # the port salts with its own versions, under its own variable
    salt = store._version_salt()
    assert f"torch={torch.__version__}" in salt
    assert f"cuda={torch.version.cuda}" in salt and "jax" not in salt
    assert store.CACHE_ENV == "REPRO_TORCH_CACHE_DIR"
    assert store.CACHE_ENV != ref_integrity.CACHE_ENV


def test_compile_lut_warm_starts_from_persistent_cache(tmp_path):
    spec = AdderSpec("loawa", 16, lsm_bits=6, const_bits=0)
    activate(str(tmp_path))
    try:
        lut_lib._compile_canonical.cache_clear()
        cold = compile_lut(spec).copy()
        store = active_cache()
        assert store.misses >= 1
        lut_lib._compile_canonical.cache_clear()   # "new process"
        warm = compile_lut(spec)
        assert store.hits >= 1
        np.testing.assert_array_equal(warm, cold)
        # warm-started tables still verify against the golden digest
        entry = _entry("ax.lut.packed", (_canonical(spec),))
        assert entry.table is warm and verify_entry(entry)
        assert entry.digest == ref_integrity.table_digest(
            ref_lut.compile_lut(RefSpec("loawa", 16, 6, 0)))
        # the multiplier tables publish and warm-start too
        mul_lut._mul_lut_cached.cache_clear()
        mul_lut._signed_table_cached.cache_clear()
        mul_lut.compile_mul_lut(MUL)
        mul_lut.signed_mul_table(MUL)
        hits = store.hits
        mul_lut._mul_lut_cached.cache_clear()
        mul_lut._signed_table_cached.cache_clear()
        mul_lut.compile_mul_lut(MUL)
        mul_lut.signed_mul_table(MUL)
        assert store.hits == hits + 2
    finally:
        deactivate()
        lut_lib._compile_canonical.cache_clear()
        mul_lut._mul_lut_cached.cache_clear()
        mul_lut._signed_table_cached.cache_clear()


def test_corrupt_persistent_entry_falls_back_to_recompile(tmp_path):
    spec = AdderSpec("loa", 16, lsm_bits=6, const_bits=0)
    activate(str(tmp_path))
    try:
        lut_lib._compile_canonical.cache_clear()
        cold = compile_lut(spec).copy()
        for p in tmp_path.iterdir():        # corrupt every entry
            if p.suffix == ".npy":
                raw = bytearray(p.read_bytes())
                raw[len(raw) // 2] ^= 0xFF
                p.write_bytes(bytes(raw))
        lut_lib._compile_canonical.cache_clear()
        rebuilt = compile_lut(spec)
        np.testing.assert_array_equal(rebuilt, cold)
        assert active_cache().corrupt >= 1
    finally:
        deactivate()
        lut_lib._compile_canonical.cache_clear()


def test_store_inactive_by_default(tmp_path, monkeypatch):
    import repro_torch.integrity.store as store_mod
    monkeypatch.delenv(store_mod.CACHE_ENV, raising=False)
    deactivate()
    assert active_cache() is None
    assert store_mod.cache_get("x", "k") is None   # no-op, no raise
    # the reference's variable does not turn the port's cache on
    monkeypatch.setenv(ref_integrity.CACHE_ENV, str(tmp_path))
    monkeypatch.setattr(store_mod, "_ENV_CHECKED", False)
    assert active_cache() is None
    monkeypatch.setenv(store_mod.CACHE_ENV, str(tmp_path))
    monkeypatch.setattr(store_mod, "_ENV_CHECKED", False)
    try:
        assert active_cache() is not None
    finally:
        deactivate()


# ------------------------------------------- serving integration --

def test_scheduler_ticks_integrity_watchdogs():
    import repro_torch.serving as sv
    live = device_table(SPEC, "cpu")
    clk = sv.VirtualClock()
    ex = sv.SimExecutor(clk, pix_per_s=1e6)
    brk = sv.CircuitBreaker()
    scrubber = LutScrubber(interval_s=2.0, clock=clk,
                           cache="ax.lut.device", breaker=brk)
    eng = make_engine(SPEC, strategy="lut", **CPU)
    canary = CanarySuite(eng, interval_s=2.0, clock=clk)
    sched = sv.Scheduler(ex, clock=clk, breaker=brk,
                         integrity=(scrubber, canary))
    assert sched.integrity == (scrubber, canary)
    sched.pump()
    assert scrubber.runs == 0 and canary.runs == 0    # not due yet
    _corrupt_in_place(live, 2, 1 << 3)
    clk.advance(2.5)
    sched.pump()
    assert scrubber.runs == 1 and scrubber.corruptions == 1
    assert brk.state == sv.OPEN                # alarm gated dispatch
    report = scrubber.last_report
    assert report.repaired                     # and repaired in place
    assert canary.runs == 1 and canary.last_report.ok   # after repair


def test_breaker_record_integrity_trips_and_degrades(fresh_obs):
    import repro_torch.serving as sv
    from repro_torch.imgproc.plan import PIPELINES, compile_pipeline
    from repro_torch.resilience.degrade import DegradePolicy

    pipe = compile_pipeline(PIPELINES["pipe_blur_sharpen_down"],
                            kind="haloc_axa", **CPU)
    pol = DegradePolicy(pipe, min_samples=256)
    brk = sv.CircuitBreaker(policy=pol)
    brk.record_integrity(0.0)
    assert brk.state == sv.OPEN and brk.trips == 1
    assert pol.level == 1                      # stepped one Pareto rung
    # direct alarm path steps another rung
    assert pol.on_integrity_alarm(None)
    assert pol.level == 2
    snap = obs.metrics_snapshot()["counters"]
    assert snap["serve.integrity_alarms"] == 1
    assert snap["degrade.integrity_alarms"] == 1


# ------------------------------------------------------- campaign --

PROVENANCE = ("backend",)


@pytest.fixture(scope="module")
def quick_campaigns():
    from repro.resilience.harness import detection_campaign as ref_campaign
    from repro_torch.resilience.harness import detection_campaign
    return detection_campaign(quick=True), ref_campaign(quick=True)


def test_quick_detection_campaign_meets_acceptance(quick_campaigns):
    records, ref_records = quick_campaigns
    assert records
    detected = sum(r["detected"] for r in records)
    cells = sum(r["cells"] for r in records)
    assert detected / cells >= 0.95
    assert all(r["false_positive_rate"] == 0.0 for r in records)
    assert all(np.isfinite(r["detection_latency_s"]) for r in records
               if r["detected"])
    assert all(json.dumps(r) for r in records)   # trajectory-ready
    assert all(r["backend"] == "torch" for r in records)
    strip = [{k: v for k, v in r.items() if k not in PROVENANCE}
             for r in records]
    assert strip == [{k: v for k, v in r.items() if k not in PROVENANCE}
                     for r in ref_records]


def test_detection_records_are_trajectory_keyed(quick_campaigns):
    from benchmarks.run import METRIC_FIELDS, record_key
    records, _ = quick_campaigns
    keys = {record_key(r) for r in records}
    assert len(keys) == len(records)            # identity is unique
    for r in records:
        for metric in ("detected", "cells", "coverage",
                       "detection_latency_s", "false_positive_rate"):
            assert metric in METRIC_FIELDS
    # the tables the campaign corrupted are whole again
    spec = make_engine("haloc_axa", **CPU).spec
    for entry in golden_entries():
        if entry.key[0] == _canonical(spec):
            assert verify_entry(entry), entry.cache
