"""The port's telemetry (``repro_torch.obs``) against ``repro.obs``, on
the CPU.

The counterparts of ``tests/test_obs.py``: span nesting, threads, the
Chrome-trace schema and ``sync_span``; counters, gauges and histograms
(percentiles equal to the reference's ``quantile``); the named cache
stats (every name the reference registers for a site the port has); the
drift monitor, whose statuses equal the reference's for the same
observations, and stage by stage for a stock pipeline on the port's
``torch`` CPU backend against the reference's ``numpy`` backend; and the
disabled fast paths, which are shared no-ops.  Equality throughout.
"""

import json

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.core.specs import AdderSpec as RefSpec
from repro_torch import obs
from repro_torch.core.specs import AdderSpec

CPU = dict(backend="torch", device="cpu")


@pytest.fixture()
def fresh_obs():
    """The port's telemetry ON with clean state; OFF and clean after."""
    obs.reset_all()
    obs.enable()
    yield
    obs.disable()
    obs.reset_all()


@pytest.fixture()
def both_obs():
    """The port's and the reference's telemetry ON, both clean; both OFF
    and clean after."""
    for o in (obs, ref_obs):
        o.reset_all()
        o.enable()
    yield
    for o in (obs, ref_obs):
        o.disable()
        o.reset_all()


# ------------------------------------------------------------- spans --

def test_span_nesting_order_and_parents(fresh_obs):
    with obs.span("outer", label="a"):
        assert obs.current_span() == "outer"
        with obs.span("inner"):
            assert obs.current_stack() == ("outer", "inner")
    assert obs.current_stack() == ()
    events = obs.get_tracer().events
    assert [(e.name, e.depth, e.parent) for e in events] == \
        [("inner", 1, "outer"), ("outer", 0, None)]
    outer, inner = events[1], events[0]
    assert outer.args == {"label": "a"}
    assert inner.ts >= outer.ts and inner.dur <= outer.dur


def test_span_set_attaches_args(fresh_obs):
    with obs.span("s") as sp:
        sp.set(tiles=9)
    assert obs.get_tracer().events[0].args == {"tiles": 9}


def test_span_threads_get_disjoint_stacks(fresh_obs):
    import threading
    seen = {}

    def worker():
        seen["stack"] = obs.current_stack()
        with obs.span("worker-span"):
            seen["inner"] = obs.current_stack()

    with obs.span("main-span"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen["stack"] == ()
    assert seen["inner"] == ("worker-span",)
    tids = {e.name: e.tid for e in obs.get_tracer().events}
    assert tids["worker-span"] != tids["main-span"]


def test_chrome_trace_schema(fresh_obs, tmp_path):
    with obs.span("outer", kind="haloc_axa", shape=(4, 64)):
        with obs.span("inner"):
            pass
    path = tmp_path / "trace.json"
    obs.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    meta = [e for e in events if e["ph"] == "M"]
    spans = [e for e in events if e["ph"] == "X"]
    assert meta and meta[0]["name"] == "thread_name"
    assert len(spans) == 2
    for e in spans:
        assert set(e) >= {"name", "ph", "ts", "dur", "pid", "tid", "args"}
        assert e["ts"] >= 0 and e["dur"] >= 0
        for v in e["args"].values():
            assert isinstance(v, (bool, int, float, str))
    by_name = {e["name"]: e for e in spans}
    assert by_name["inner"]["args"]["parent"] == "outer"
    assert by_name["outer"]["args"]["depth"] == 0


def test_sync_span_is_identity():
    """Disabled: the value itself, no span.  Enabled: the value itself
    under a ``device_sync`` span; tensors on the CPU (nested too) have no
    device to wait for."""
    obs.disable()
    x = object()
    assert obs.sync_span(x) is x
    obs.reset_all()
    with obs.telemetry(True):
        t = torch.arange(4)
        nested = {"a": [t, (t, 3)]}
        assert obs.sync_span(t) is t
        assert obs.sync_span(nested, name="drain", batch=1) is nested
    names = [e.name for e in obs.get_tracer().events]
    assert names == ["device_sync", "drain"]
    obs.reset_all()


# ----------------------------------------------------------- metrics --

@pytest.mark.parametrize("samples", [
    [float(v) for v in range(1, 101)],
    [0.25, 3.0, 1e-6, 7.5, 7.5, 2.0, 1e3],
    [42.0],
])
def test_histogram_percentiles_equal_reference(fresh_obs, samples):
    h = obs.histogram("lat")
    for v in samples:
        h.record(v)
    assert h.count == len(samples)
    for q in (0, 1, 50, 95, 99, 100):
        assert h.percentile(q) == ref_obs.quantile(samples, q)
        assert obs.quantile(samples, q) == ref_obs.quantile(samples, q)
    s = h.summary()
    assert s["min"] == min(samples) and s["max"] == max(samples)
    assert s["p99"] == ref_obs.quantile(samples, 99)
    assert np.isnan(obs.quantile([], 50))


def test_counter_and_gauge_high_water(fresh_obs):
    c = obs.counter("pixels")
    c.inc(10)
    c.inc(5)
    g = obs.gauge("in_flight")
    g.inc()
    g.inc()
    g.dec()
    snap = obs.metrics_snapshot()
    assert snap["counters"]["pixels"] == 15
    assert snap["gauges"]["in_flight"] == {"value": 1, "high_water": 2}
    assert obs.metrics_snapshot("pix")["counters"] == {"pixels": 15}
    assert "caches" not in obs.metrics_snapshot("pix")


def test_write_metrics_is_json_safe(fresh_obs, tmp_path):
    obs.histogram("empty")
    obs.counter("n").inc()
    path = tmp_path / "metrics.json"
    obs.write_metrics(str(path))
    doc = json.loads(path.read_text())
    assert doc["counters"]["n"] == 1
    assert doc["histograms"]["empty"]["p50"] is None
    assert "caches" in doc


# ------------------------------------------------------- cache stats --

def test_cache_names_cover_the_references_sites():
    """Every name the reference registers for a site the port has, plus
    the port's device tables and the fault masks."""
    import repro.ax.mul.lut  # noqa: F401
    import repro.core.hwcost  # noqa: F401
    import repro.imgproc.plan  # noqa: F401
    import repro.imgproc.tiles  # noqa: F401
    import repro_torch.ax.analytics  # noqa: F401
    import repro_torch.ax.mul.lut  # noqa: F401
    import repro_torch.core.hwcost  # noqa: F401
    import repro_torch.imgproc.tiles  # noqa: F401
    import repro_torch.resilience.faults  # noqa: F401
    ported = set(ref_obs.cache_names()) - {"ax.analytics.jax_reduce"}
    ported = {n for n in ported if not n.startswith("imgproc.workload.")}
    names = set(obs.cache_names())
    assert ported <= names, sorted(ported - names)
    for extra in ("ax.lut.device", "ax.lut.device_abs_error",
                  "ax.mul.lut.device_signed16", "resilience.faults.flip_mask"):
        assert extra in names, extra


def test_cache_stats_count_hits_and_misses():
    from repro_torch.ax import make_engine
    from repro_torch.obs.caches import get_cached
    get_cached("ax.lut.packed").cache_clear()
    get_cached("ax.lut.device").cache_clear()
    spec = AdderSpec("haloc_axa", n_bits=16, lsm_bits=6, const_bits=3)
    before = obs.cache_stats("ax.lut.device")["ax.lut.device"]
    eng = make_engine(spec, strategy="lut", **CPU)
    a = torch.arange(64, dtype=torch.int32)
    eng.add(a, a)
    mid = obs.cache_stats("ax.lut.device")["ax.lut.device"]
    assert mid["misses"] > before["misses"]
    eng.add(a, a)
    after = obs.cache_stats("ax.lut.device")["ax.lut.device"]
    assert after["hits"] > mid["hits"] and after["size"] >= 1
    assert not obs.enabled()
    assert "ax.lut.device" in obs.format_cache_stats("ax.")


# ------------------------------------------------------------- drift --

SPEC = AdderSpec("haloc_axa", n_bits=16, lsm_bits=8, const_bits=4)
REF_SPEC = RefSpec("haloc_axa", n_bits=16, lsm_bits=8, const_bits=4)


def _uniform_operands(n=20000, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 16, n, dtype=np.uint64),
            rng.integers(0, 1 << 16, n, dtype=np.uint64))


def _fields(st):
    return (st.stage, st.n, st.mean_abs, st.budget_med, st.threshold,
            st.tripped)


def _assert_same_statuses(port_mon, ref_mon):
    got = [_fields(s) for s in port_mon.statuses()]
    want = [_fields(s) for s in ref_mon.statuses()]
    assert got == want


def test_drift_monitor_budget_equals_reference():
    for spec, ref in ((SPEC, REF_SPEC),
                      (AdderSpec("loa", 16, 6), RefSpec("loa", 16, 6)),
                      (AdderSpec("accurate", 16), RefSpec("accurate", 16))):
        mon, rmon = obs.DriftMonitor(spec), ref_obs.DriftMonitor(ref)
        assert (mon.budget_med, mon.budget_nmed, mon.budget_sigma) == \
            (rmon.budget_med, rmon.budget_nmed, rmon.budget_sigma)
        for n in (1, 100, 10 ** 6):
            assert mon.threshold(n) == rmon.threshold(n)


def test_drift_matched_config_stays_quiet_as_reference():
    mon, rmon = obs.DriftMonitor(SPEC), ref_obs.DriftMonitor(REF_SPEC)
    a, b = _uniform_operands()
    for i in range(0, a.size, 4096):
        mon.observe_operands("blur", torch.from_numpy(
            a[i:i + 4096].astype(np.int64)), b[i:i + 4096])
        rmon.observe_operands("blur", a[i:i + 4096], b[i:i + 4096])
    _assert_same_statuses(mon, rmon)
    st = mon.status("blur")
    assert st.n >= mon.min_samples and 0.9 < st.ratio < 1.1
    assert mon.ok() and mon.drifted() == ()


def test_drift_trips_on_mis_budgeted_config_as_reference():
    mon, rmon = obs.DriftMonitor(SPEC), ref_obs.DriftMonitor(REF_SPEC)
    a, b = _uniform_operands(seed=5)
    mon.observe_operands("sharpen", a, b,
                         spec=AdderSpec("loa", 16, 8, 4))
    rmon.observe_operands("sharpen", a, b,
                          spec=RefSpec("loa", 16, 8, 4))
    _assert_same_statuses(mon, rmon)
    assert mon.status("sharpen").tripped
    assert mon.drifted() == ("sharpen",)
    assert "DRIFT" in mon.report()


def test_drift_min_samples_and_exact_budget_as_reference():
    mon = obs.DriftMonitor(SPEC, min_samples=1024)
    rmon = ref_obs.DriftMonitor(REF_SPEC, min_samples=1024)
    for m in (mon, rmon):
        m.observe_errors("s", np.full(100, 1e6))
    assert not mon.status("s").tripped
    for m in (mon, rmon):
        m.observe_errors("s", np.full(1024, 1e6), n_adds=3)
    _assert_same_statuses(mon, rmon)
    assert mon.status("s").tripped
    exact = obs.DriftMonitor(AdderSpec("accurate", 16, 8), min_samples=1)
    a, b = _uniform_operands(n=64)
    exact.observe_operands("s", a, b)
    st = exact.status("s")
    assert st.mean_abs == 0.0 and not st.tripped


def test_engine_capture_labels_stage_from_span(both_obs):
    from repro.ax import make_engine as ref_make_engine
    from repro_torch.ax import make_engine
    eng = make_engine(SPEC, **CPU)
    ref = ref_make_engine(REF_SPEC, backend="numpy")
    a, b = _uniform_operands(n=9000, seed=9)
    ta = torch.from_numpy(a.astype(np.int32))
    tb = torch.from_numpy(b.astype(np.int32))
    with obs.installed(obs.DriftMonitor(SPEC, min_samples=1)) as mon:
        with obs.span("stage:gaussian_blur"):
            eng.add(ta, tb)
        eng.add(ta, tb)  # outside any stage span
    with ref_obs.installed(ref_obs.DriftMonitor(REF_SPEC,
                                                min_samples=1)) as rmon:
        with ref_obs.span("stage:gaussian_blur"):
            ref.add(a, b)
        ref.add(a, b)
    assert {st.stage for st in mon.statuses()} == \
        {"gaussian_blur", "unlabeled"}
    _assert_same_statuses(mon, rmon)


def test_engine_capture_off_when_disabled():
    from repro_torch.ax import make_engine
    obs.disable()
    eng = make_engine(SPEC, **CPU)
    a, b = _uniform_operands(n=256)
    with obs.installed(obs.DriftMonitor(SPEC, min_samples=1)) as mon:
        eng.add(torch.from_numpy(a.astype(np.int32)),
                torch.from_numpy(b.astype(np.int32)))
    assert mon.statuses() == ()


def test_engine_capture_skips_a_suppressed_region(fresh_obs):
    """Inside a compiled ``cuda`` plan (the reference's jit) capture
    records nothing, and accumulate_signed keeps the fused fold."""
    from repro_torch.ax import make_engine
    from repro_torch.numerics.fixed_point import FixedPointFormat
    eng = make_engine(SPEC, fmt=FixedPointFormat(16, 3), **CPU)
    q = torch.arange(64, dtype=torch.int32).reshape(8, 8)
    with obs.installed(obs.DriftMonitor(SPEC, min_samples=1)) as mon:
        with obs.drift.suppressed():
            assert not obs.drift.capturing()
            eng.scaled_add(q, q, 3, -2)
        assert mon.statuses() == ()
        assert obs.drift.capturing()
        eng.scaled_add(q, q, 3, -2)
    assert [st.stage for st in mon.statuses()] == ["unlabeled"]


@pytest.mark.parametrize("stages", [("gaussian_blur", "sharpen"),
                                    ("gaussian_blur", "sharpen",
                                     "downsample2x"),
                                    ("gaussian_blur", "sobel")])
@pytest.mark.parametrize("requant", ["stage", "fused"])
def test_pipeline_capture_equals_reference_stage_by_stage(both_obs, stages,
                                                          requant):
    """The shadow pattern: a crop through the port's ``torch`` CPU
    pipeline and through the reference's ``numpy`` pipeline, each with a
    monitor installed: equal statuses, stage by stage."""
    from repro.imgproc import run_pipeline as ref_run_pipeline
    from repro.imgproc import synthetic_batch
    from repro_torch.imgproc import run_pipeline
    batch = synthetic_batch(2, 32, seed=2)
    with obs.installed(obs.DriftMonitor(SPEC, min_samples=64)) as mon:
        got = run_pipeline(stages, batch, kind="haloc_axa",
                           requant=requant, **CPU)
    with ref_obs.installed(ref_obs.DriftMonitor(REF_SPEC,
                                                min_samples=64)) as rmon:
        want = ref_run_pipeline(stages, batch, kind="haloc_axa",
                                backend="numpy", requant=requant)
    np.testing.assert_array_equal(got, want)
    assert {st.stage for st in mon.statuses()} >= set(stages) - {
        "downsample2x"}
    _assert_same_statuses(mon, rmon)
    assert mon.ok(), mon.report()


# ----------------------------------------------------- disabled = off --

def test_disabled_span_is_shared_noop():
    obs.disable()
    s1, s2 = obs.span("a"), obs.span("b", x=1)
    assert s1 is s2
    n_before = len(obs.get_tracer().events)
    with obs.span("not-recorded"):
        assert obs.current_stack() == ()
    assert len(obs.get_tracer().events) == n_before


def test_disabled_instruments_are_shared_noop():
    obs.disable()
    c = obs.counter("x")
    assert c is obs.gauge("y") is obs.histogram("z")
    c.inc(100)
    c.record(1.0)
    c.set(5)
    assert np.isnan(c.percentile(50))
    snap = obs.metrics_snapshot()
    assert "x" not in snap["counters"]
    assert "z" not in snap["histograms"]


def test_telemetry_scope_restores_flag():
    obs.disable()
    with obs.telemetry(True):
        assert obs.enabled()
        with obs.telemetry(False):
            assert not obs.enabled()
        assert obs.enabled()
    assert not obs.enabled()


def test_plan_and_tiles_spans_and_counters(fresh_obs, tmp_path):
    """``plan:compile``, ``plan:call``, ``stage:*``, ``tiles:dispatch`` and
    ``tiles:tile`` spans, the pixel and dispatch counters, and the
    tiled executor's ``raw`` (equal output, no tiles hook)."""
    from repro_torch.imgproc import compile_pipeline, compile_tiled
    from repro_torch.imgproc import synthetic_batch
    pipe = compile_pipeline(("gaussian_blur", "sharpen", "downsample2x"),
                            kind="loawa", requant="fused", **CPU)
    batch = synthetic_batch(2, 48, seed=4)
    out = pipe(batch)
    run = compile_tiled(pipe, batch.shape, tile=(16, 16))
    tiled = run(batch)
    def tiles_spans():
        return sum(e.name.startswith("tiles:")
                   for e in obs.get_tracer().events)

    n = tiles_spans()
    raw = run.raw(batch)
    assert tiles_spans() == n
    assert torch.equal(tiled, out) and torch.equal(raw, out)
    names = [e.name for e in obs.get_tracer().events]
    for name in ("plan:compile", "plan:call", "stage:gaussian_blur",
                 "stage:sharpen", "stage:downsample2x", "tiles:dispatch",
                 "tiles:tile"):
        assert name in names, name
    snap = obs.metrics_snapshot()
    assert snap["counters"]["plan.pixels_in"] == batch.size
    assert snap["counters"]["tiles.dispatches"] == 1
    assert snap["counters"]["tiles.tiles_dispatched"] == \
        names.count("tiles:tile")
    path = obs.export_chrome_trace(str(tmp_path / "t.json"))
    assert "tiles:dispatch" in open(path).read()
