"""The port's stream executor (``repro_torch.imgproc.run_streaming``)
against the semantics of ``repro.imgproc.run_streaming``, on the CPU.

The counterparts of ``tests/test_resilience.py``'s hardened-streaming
cases (poisoned batches leave nothing pending and are named, ``isolate``
at depth 1 and more, deadline retry with backoff, the empty stream,
transient dispatch and drain faults, retry exhaustion, bad knobs, and
``late()`` as the one definition of lateness), ``tests/test_obs.py``'s
latency percentiles and ``stream.*`` metrics, and ``tests/test_tiles.py``'s
streaming-equals-sequential, with the port's CPU pipelines and plain
callables.  Where both runners take the same stream, the port's result
equals the reference's field for field (times aside).
"""

import collections
import time

import numpy as np
import pytest

from repro import obs as ref_obs
from repro.imgproc.corpus import run_streaming as ref_run_streaming
from repro_torch import obs
from repro_torch.imgproc import (StreamResult, compile_pipeline,
                                 compile_tiled, run_streaming,
                                 synthetic_batch)
from repro_torch.imgproc.plan import PIPELINES
from repro_torch.resilience.faults import FaultSpec

CPU = dict(backend="torch", device="cpu")
PIPE = PIPELINES["pipe_blur_sharpen_down"]


@pytest.fixture()
def fresh_obs():
    obs.reset_all()
    obs.enable()
    yield
    obs.disable()
    obs.reset_all()


class _Fut:
    """A result-like handle that records whether it was ever settled."""

    def __init__(self, arr, raise_on_drain=False):
        self.arr = np.asarray(arr)
        self.raise_on_drain = raise_on_drain
        self.settled = False

    def __array__(self, dtype=None, copy=None):
        self.settled = True
        if self.raise_on_drain:
            raise RuntimeError("device poisoned")
        return self.arr


def _poisoned_stream(n=6, bad=2):
    futs = []

    def fn(batch):
        fut = _Fut(batch, raise_on_drain=int(batch[0, 0, 0]) == bad)
        futs.append(fut)
        return fut

    batches = []
    for i in range(n):
        b = np.zeros((1, 8, 8), np.uint8)
        b[0, 0, 0] = i
        batches.append(b)
    return fn, batches, futs


def _same_partitions(got, want):
    assert (got.failed, got.retried, got.degraded, got.pixels) == \
        (want.failed, want.retried, want.degraded, want.pixels)
    assert len(got.outputs) == len(want.outputs)
    for x, y in zip(got.outputs, want.outputs):
        if y is None:
            assert x is None
        else:
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------- hardened streaming --

def test_poisoned_batch_leaves_no_pending_results(fresh_obs):
    fn, batches, futs = _poisoned_stream(n=6, bad=2)
    with pytest.raises(RuntimeError, match=r"batch 2"):
        run_streaming(fn, batches, depth=3)
    assert futs and all(f.settled for f in futs)
    snap = obs.metrics_snapshot()
    assert snap["gauges"]["stream.batches_in_flight"]["value"] == 0
    assert snap["counters"]["stream.failed_batches"] == 1


def test_dispatch_failure_names_batch_index():
    def fn(batch):
        if int(batch[0, 0, 0]) == 1:
            raise ValueError("compile exploded")
        return batch

    _, batches, _ = _poisoned_stream(n=3)
    with pytest.raises(RuntimeError, match=r"batch 1 failed during"):
        run_streaming(fn, batches, depth=2)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_isolate_records_failure_as_reference(depth):
    fn, batches, futs = _poisoned_stream(n=6, bad=2)
    r = run_streaming(fn, batches, depth=depth, isolate=True)
    assert r.failed == (2,) and r.outputs[2] is None
    for i in (0, 1, 3, 4, 5):
        np.testing.assert_array_equal(r.outputs[i], batches[i])
    assert all(f.settled for f in futs)
    assert len(r.batch_seconds) == 5
    fn, batches, _ = _poisoned_stream(n=6, bad=2)
    _same_partitions(r, ref_run_streaming(fn, batches, depth=depth,
                                          isolate=True))


def test_isolate_depth_invariance():
    runs = []
    for depth in (1, 2, 4):
        fn, batches, _ = _poisoned_stream(n=6, bad=3)
        runs.append(run_streaming(fn, batches, depth=depth, isolate=True))
    for r in runs[1:]:
        _same_partitions(r, runs[0])
    assert runs[0].failed == (3,)


def test_deadline_retry_with_backoff():
    calls = collections.Counter()

    def fn(batch):
        i = int(batch[0, 0, 0])
        calls[i] += 1
        if i == 1 and calls[i] == 1:
            time.sleep(0.3)
        return batch

    _, batches, _ = _poisoned_stream(n=4)
    r = run_streaming(fn, batches, depth=1, deadline_s=0.1,
                      max_retries=2, backoff_s=0.0)
    assert r.retried == (1,) and r.failed == ()
    assert calls[1] == 2 and calls[0] == 1
    for i in range(4):
        np.testing.assert_array_equal(r.outputs[i], batches[i])


def test_empty_stream_is_well_formed():
    r = run_streaming(lambda b: b, [])
    assert r.outputs == [] and r.pixels == 0 and r.mpix_per_s == 0.0
    assert r.failed == r.retried == r.degraded == ()
    assert r.batch_seconds == ()
    assert StreamResult(outputs=[], seconds=0.0, pixels=0).mpix_per_s == 0.0


def test_retry_failures_recovers_transient_dispatch_fault():
    calls = collections.Counter()

    def fn(batch):
        i = int(batch[0, 0, 0])
        calls[i] += 1
        if i == 1 and calls[i] == 1:
            raise RuntimeError("transient dispatch fault")
        return batch

    _, batches, _ = _poisoned_stream(n=4)
    r = run_streaming(fn, batches, depth=2, retry_failures=True,
                      max_retries=2, backoff_s=0.0)
    assert r.retried == (1,) and r.failed == () and calls[1] == 2
    for i in range(4):
        np.testing.assert_array_equal(r.outputs[i], batches[i])


def test_retry_failures_recovers_transient_drain_fault():
    seen = collections.Counter()

    def fn(batch):
        i = int(batch[0, 0, 0])
        seen[i] += 1
        return _Fut(batch, raise_on_drain=(i == 2 and seen[i] == 1))

    _, batches, _ = _poisoned_stream(n=5)
    r = run_streaming(fn, batches, depth=2, retry_failures=True,
                      max_retries=2, backoff_s=0.0)
    assert r.retried == (2,) and r.failed == () and seen[2] == 2
    for i in range(5):
        np.testing.assert_array_equal(r.outputs[i], batches[i])


@pytest.mark.parametrize("depth", [1, 3])
def test_retry_exhaustion_lands_in_failed(depth):
    attempts = collections.Counter()

    def fn(batch):
        i = int(batch[0, 0, 0])
        attempts[i] += 1
        return _Fut(batch, raise_on_drain=(i == 2))

    _, batches, _ = _poisoned_stream(n=5)
    r = run_streaming(fn, batches, depth=depth, retry_failures=True,
                      isolate=True, max_retries=2, backoff_s=0.0)
    assert r.failed == (2,) and r.outputs[2] is None
    assert 2 in r.retried and attempts[2] == 3
    for i in (0, 1, 3, 4):
        np.testing.assert_array_equal(r.outputs[i], batches[i])


def test_retry_exhaustion_without_isolate_raises_with_attempts():
    def fn(batch):
        if int(batch[0, 0, 0]) == 1:
            raise RuntimeError("hard fault")
        return batch

    _, batches, _ = _poisoned_stream(n=3)
    with pytest.raises(RuntimeError, match=r"batch 1 .*attempt 3"):
        run_streaming(fn, batches, depth=2, retry_failures=True,
                      max_retries=2, backoff_s=0.0)


def test_run_streaming_rejects_bad_knobs():
    batches = [np.zeros((1, 4, 4), np.uint8)]
    with pytest.raises(ValueError, match="depth"):
        run_streaming(lambda b: b, batches, depth=0)
    with pytest.raises(ValueError, match="deadline_s"):
        run_streaming(lambda b: b, batches, deadline_s=0.0)
    with pytest.raises(ValueError, match="max_retries"):
        run_streaming(lambda b: b, batches, max_retries=-1)
    with pytest.raises(ValueError, match="backoff_s"):
        run_streaming(lambda b: b, batches, backoff_s=-0.1)


def test_straggler_late_is_single_source_of_truth():
    from repro_torch.runtime.straggler import (StragglerConfig,
                                               StragglerMonitor)
    mon = StragglerMonitor(StragglerConfig(min_samples=4))
    for i in range(6):
        assert not mon.late(i, 0.010)
    assert mon.late(6, 0.200)
    assert mon.late(7, 0.012, deadline=0.011)
    assert not mon.late(8, 0.010, deadline=0.011)
    flagged = []
    mon2 = StragglerMonitor(StragglerConfig(min_samples=2),
                            on_flag=lambda s, dt: flagged.append(s))
    for i, dt in enumerate((0.01, 0.01, 0.01, 1.0)):
        mon2.record(i, dt)
    assert flagged == [3] and mon2.flagged == [(3, 1.0)]


def test_straggler_outliers_retry_through_the_stream():
    """A ``StragglerConfig`` without a deadline: the stream's own history
    flags the slow batch, which re-dispatches once."""
    from repro_torch.runtime.straggler import StragglerConfig
    calls = collections.Counter()

    def fn(batch):
        i = int(batch[0, 0, 0])
        calls[i] += 1
        time.sleep(0.002 if not (i == 9 and calls[i] == 1) else 0.2)
        return batch

    _, batches, _ = _poisoned_stream(n=12)
    r = run_streaming(fn, batches, depth=1, backoff_s=0.0,
                      straggler=StragglerConfig(min_samples=4,
                                                threshold=3.0))
    assert 9 in r.retried and calls[9] >= 2
    for i in range(12):
        np.testing.assert_array_equal(r.outputs[i], batches[i])


# ------------------------------------------------- latency metrics --

def test_stream_result_latency_percentiles():
    lat = tuple(float(v) for v in range(1, 11))
    r = StreamResult(outputs=[], seconds=1.0, pixels=10 ** 6,
                     batch_seconds=lat)
    assert (r.p50_s, r.p95_s, r.p99_s) == \
        (ref_obs.quantile(lat, 50), ref_obs.quantile(lat, 95),
         ref_obs.quantile(lat, 99))
    assert r.p50_s == pytest.approx(5.5) and r.mpix_per_s == 1.0
    assert np.isnan(StreamResult(outputs=[], seconds=1.0, pixels=1).p50_s)


def test_run_streaming_records_latencies_without_telemetry():
    obs.disable()
    batches = [np.zeros((1, 8, 8), np.uint8) for _ in range(5)]
    r = run_streaming(lambda b: b, batches, depth=2)
    assert len(r.batch_seconds) == 5
    assert all(t >= 0 for t in r.batch_seconds)
    assert r.p95_s >= r.p50_s


def test_run_streaming_metrics_when_enabled(fresh_obs):
    batches = [np.zeros((1, 8, 8), np.uint8) for _ in range(4)]
    run_streaming(lambda b: b, batches, depth=2)
    snap = obs.metrics_snapshot()
    assert snap["counters"]["stream.batches"] == 4
    assert snap["counters"]["stream.pixels"] == 4 * 64
    assert snap["histograms"]["stream.batch_seconds"]["count"] == 4
    assert snap["gauges"]["stream.batches_in_flight"]["value"] == 0
    assert snap["gauges"]["stream.batches_in_flight"]["high_water"] == 2
    names = [e.name for e in obs.get_tracer().events]
    assert names.count("stream:dispatch") == 4
    assert names.count("stream:drain") == 4


# ------------------------------------------ streaming = sequential --

@pytest.mark.parametrize("requant", ["stage", "fused"])
@pytest.mark.parametrize("tiled", [False, True])
def test_streaming_equals_sequential(requant, tiled):
    pipe = compile_pipeline(PIPE, kind="haloc_axa", requant=requant, **CPU)
    batches = [synthetic_batch(2, 48, seed=s) for s in range(4)]
    fn = compile_tiled(pipe, batches[0].shape, tile=(16, 16)) if tiled \
        else pipe
    seq = [pipe(b).numpy() for b in batches]
    for depth in (1, 2, 3):
        r = run_streaming(fn, batches, depth=depth)
        assert r.failed == r.retried == r.degraded == ()
        for got, want in zip(r.outputs, seq):
            assert isinstance(got, np.ndarray)
            np.testing.assert_array_equal(got, want)
        assert r.pixels == sum(b.size for b in batches) and \
            r.mpix_per_s > 0


def test_run_streaming_degrade_hook_equals_reference(fresh_obs):
    """A faulted stream with a policy watching, on the port's ``torch``
    CPU plan and the reference's ``numpy`` plan: the same degraded
    indices and outputs, each from the recovered plan."""
    from repro.imgproc.plan import compile_pipeline as ref_compile
    from repro.resilience.degrade import DegradePolicy as RefPolicy
    from repro.resilience.faults import FaultSpec as RefFault
    from repro_torch.resilience.degrade import DegradePolicy
    pipe = compile_pipeline(PIPE, kind="haloc_axa",
                            fault=FaultSpec("stuck_at_1", (11,)), **CPU)
    pol = DegradePolicy(pipe, min_samples=512)
    batches = [synthetic_batch(2, 32, seed=9 + i) for i in range(3)]
    r = run_streaming(pipe, batches, depth=2, degrade=pol)
    assert pol.level >= 1 and r.failed == ()
    assert r.degraded and r.degraded[0] == 0
    for i in r.degraded:
        np.testing.assert_array_equal(r.outputs[i],
                                      pol.pipe(batches[i]).numpy())
    ref_obs.reset_all()
    ref_obs.enable()
    try:
        rpipe = ref_compile(PIPE, kind="haloc_axa", backend="numpy",
                            fault=RefFault("stuck_at_1", (11,)))
        rpol = RefPolicy(rpipe, min_samples=512)
        want = ref_run_streaming(rpipe, batches, depth=2, degrade=rpol)
    finally:
        ref_obs.disable()
        ref_obs.reset_all()
    _same_partitions(r, want)
    assert (pol.level, pol.trips) == (rpol.level, rpol.trips)
