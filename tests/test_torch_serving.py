"""The port's serving front door (``repro_torch.serving``) against
``repro.serving``, on the CPU.

One counterpart per test of ``tests/test_serving.py``, all on a virtual
clock (deterministic, zero wall sleeps) except the wall clock's own
test.  Where the reference runs the same scenario, the port is held to
it with ``==``: the outcome sequences (type, reason, start, finish,
attempts, lateness) and the ``run_traffic`` records, including the three
simulated cells committed to ``BENCH_serve.json``.  ``PlanExecutor`` on
the ``"torch"`` backend on the CPU serves the same uint8 outputs as the
reference's numpy executor at 32 x 32.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from repro import serving as ref_sv
from repro_torch import obs
from repro_torch import serving as sv
from repro_torch.runtime.straggler import StragglerConfig, StragglerMonitor

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = dict(backend="torch", device="cpu")


@pytest.fixture()
def fresh_obs():
    obs.reset_all()
    obs.enable()
    yield
    obs.disable()
    obs.reset_all()


def _img(size=32, fill=7):
    return np.full((size, size), fill, np.uint8)


def _sim(pix_per_s=1e6, pkg=sv, **kw):
    clk = pkg.VirtualClock()
    ex = pkg.SimExecutor(clk, pix_per_s=pix_per_s, **kw)
    est = pkg.CostEstimator(pix_per_s=pix_per_s)
    return clk, ex, est


def _trace(outcomes):
    """An outcome sequence with the package-local request ids left out."""
    rows = []
    for o in outcomes:
        rows.append((type(o).__name__, getattr(o, "reason", None),
                     getattr(o, "started", None), getattr(o, "finished",
                                                          None),
                     getattr(o, "attempts", None), getattr(o, "late", None),
                     getattr(o, "at", None)))
    return rows


# -------------------------------------------------------------- clock --

def test_virtual_clock_basics():
    clk = sv.VirtualClock()
    assert clk.now() == 0.0
    clk.sleep(0.5)
    assert clk.now() == 0.5
    clk.advance_to(0.25)                 # never rewinds
    assert clk.now() == 0.5
    clk.advance_to(1.5)
    assert clk.now() == 1.5
    with pytest.raises(ValueError, match="cannot advance"):
        clk.advance(-0.1)


def test_virtual_clock_positive_advance_always_moves():
    clk = sv.VirtualClock(start=0.27486669760536514)
    t0 = clk.now()
    clk.sleep(1.3877787807814457e-17)    # absorbed by plain float add
    assert clk.now() > t0
    ref = ref_sv.VirtualClock(start=0.27486669760536514)
    ref.sleep(1.3877787807814457e-17)
    assert clk.now() == ref.now()
    clk.sleep(0.0)                       # a zero sleep is still a no-op
    assert clk.now() == pytest.approx(t0, abs=1e-12)


def test_wall_clock_is_monotone():
    clk = sv.WallClock()
    a = clk.now()
    clk.sleep(0.0)
    assert clk.now() >= a


# ---------------------------------------------------------- estimator --

def test_estimator_ewma_and_validation():
    est = sv.CostEstimator(pix_per_s=1e6, overhead_s=0.001)
    ref = ref_sv.CostEstimator(pix_per_s=1e6, overhead_s=0.001)
    assert est.estimate(1000) == pytest.approx(0.002)
    for pixels, secs in ((1000, 0.0005), (1000, 0.001), (0, 1.0),
                         (100, 0.0), (4096, 0.003)):
        est.observe(pixels, secs)
        ref.observe(pixels, secs)
        assert (est.pix_per_s, est.observations) == \
            (ref.pix_per_s, ref.observations)
    assert 1e6 < est.pix_per_s < 2e6
    with pytest.raises(ValueError, match="pix_per_s"):
        sv.CostEstimator(pix_per_s=0)
    with pytest.raises(ValueError, match="overhead_s"):
        sv.CostEstimator(overhead_s=-1)
    with pytest.raises(ValueError, match="alpha"):
        sv.CostEstimator(alpha=0.0)


def test_estimator_calibrate_from_sim_executor():
    clk = sv.VirtualClock()
    ex = sv.SimExecutor(clk, pix_per_s=2e6)
    est = sv.CostEstimator(pix_per_s=123.0)
    measured = est.calibrate(ex, _img(32), "pipe_blur_sharpen_down", clk)
    assert measured == pytest.approx(2e6)
    assert est.estimate(2e6) == pytest.approx(1.0)


# ------------------------------------------- admission / backpressure --

def test_queue_full_rejection_is_typed():
    q = sv.AdmissionQueue(sv.AdmissionConfig(max_depth=2, preempt=False))
    assert q.offer(sv.Request(image=_img())) == (None, None)
    assert q.offer(sv.Request(image=_img())) == (None, None)
    rej, evicted = q.offer(sv.Request(image=_img()))
    assert evicted is None
    assert isinstance(rej, sv.Rejected) and not rej.ok
    assert rej.reason == "queue_full" and rej.depth == 2
    assert len(q) == 2                   # refusal never grows the queue


def test_backlog_rejection_is_typed():
    est = sv.CostEstimator(pix_per_s=1e6)   # 32x32 -> ~1 ms each
    q = sv.AdmissionQueue(
        sv.AdmissionConfig(max_depth=64, max_backlog_s=0.0025), est)
    assert q.offer(sv.Request(image=_img()))[0] is None
    assert q.offer(sv.Request(image=_img()))[0] is None
    rej, _ = q.offer(sv.Request(image=_img()))
    assert rej is not None and rej.reason == "backlog"
    assert rej.backlog_s == pytest.approx(2 * 1024 / 1e6)


def test_priority_preemption_evicts_lowest():
    q = sv.AdmissionQueue(sv.AdmissionConfig(max_depth=2))
    lo = sv.Request(image=_img(), priority=0)
    mid = sv.Request(image=_img(), priority=1)
    q.offer(lo)
    q.offer(mid)
    hi = sv.Request(image=_img(), priority=2)
    rej, evicted = q.offer(hi)
    assert rej is None and evicted is lo    # lowest priority loses
    assert len(q) == 2
    rej, evicted = q.offer(sv.Request(image=_img(), priority=1))
    assert rej is not None and evicted is None


def test_preemption_undone_when_backlog_still_refuses():
    est = sv.CostEstimator(pix_per_s=1e6)
    q = sv.AdmissionQueue(
        sv.AdmissionConfig(max_depth=1, max_backlog_s=0.0005), est)
    small = sv.Request(image=_img(8), priority=0)        # 64 px
    assert q.offer(small)[0] is None
    big = sv.Request(image=_img(64), priority=5)         # 4096 px > cap
    rej, evicted = q.offer(big)
    assert rej is not None and rej.reason == "backlog"
    assert evicted is None
    assert q.requests(small.bucket) == (small,)          # victim restored


def test_take_orders_priority_then_fifo():
    q = sv.AdmissionQueue(sv.AdmissionConfig(max_depth=8))
    reqs = [sv.Request(image=_img(), priority=p) for p in (0, 2, 1, 2)]
    for r in reqs:
        q.offer(r)
    chosen = q.take(reqs[0].bucket, 3)
    assert chosen == (reqs[1], reqs[2], reqs[3])
    assert len(q) == 1


# ------------------------------------------------------------ batcher --

def _queued(requests, est=None):
    q = sv.AdmissionQueue(sv.AdmissionConfig(max_depth=64), est)
    for r in requests:
        assert q.offer(r)[0] is None
    return q


def test_batcher_dispatches_on_fill():
    est = sv.CostEstimator(pix_per_s=1e6)
    b = sv.Batcher(sv.BatcherConfig(max_batch=3, max_wait_s=1.0), est)
    reqs = [dataclasses.replace(sv.Request(image=_img()), arrival=0.0)
            for _ in range(3)]
    q = _queued(reqs, est)
    assert b.due(q, reqs[0].bucket, now=0.0)      # full: no waiting
    batches = b.collect(q, now=0.0)
    assert len(batches) == 1 and len(batches[0]) == 3
    assert batches[0].pipeline == "pipe_blur_sharpen_down"
    assert len(q) == 0


def test_batcher_dispatches_on_max_wait():
    est = sv.CostEstimator(pix_per_s=1e6)
    b = sv.Batcher(sv.BatcherConfig(max_batch=4, max_wait_s=0.010), est)
    req = dataclasses.replace(sv.Request(image=_img()), arrival=0.0)
    q = _queued([req], est)
    assert not b.due(q, req.bucket, now=0.004)    # light load: wait
    assert b.due(q, req.bucket, now=0.010)        # latency floor hit


def test_batcher_dispatches_on_deadline_margin():
    est = sv.CostEstimator(pix_per_s=1e6)         # ~1 ms service
    b = sv.Batcher(sv.BatcherConfig(max_batch=4, max_wait_s=10.0,
                                    safety=2.0), est)
    req = dataclasses.replace(
        sv.Request(image=_img(), deadline=0.0035), arrival=0.0)
    q = _queued([req], est)
    assert not b.due(q, req.bucket, now=0.0005)   # slack still covers
    assert b.due(q, req.bucket, now=0.002)        # slack < est * safety


def test_batcher_sheds_expired_and_doomed():
    est = sv.CostEstimator(pix_per_s=1e6)
    b = sv.Batcher(sv.BatcherConfig(max_batch=4), est)
    expired = dataclasses.replace(
        sv.Request(image=_img(), deadline=0.5), arrival=0.0)
    doomed = dataclasses.replace(
        sv.Request(image=_img(64), deadline=1.001), arrival=0.0)
    healthy = dataclasses.replace(
        sv.Request(image=_img(), deadline=5.0), arrival=0.0)
    q = _queued([expired, doomed, healthy], est)
    sheds = b.shed(q, now=1.0)
    assert {(s.rid, s.reason) for s in sheds} == \
        {(expired.rid, "expired"), (doomed.rid, "doomed")}
    assert len(q) == 1 and q.oldest(healthy.bucket) is healthy


# ---------------------------------------------------------- scheduler --

def _scenario(pkg, build):
    """Run ``build(pkg)`` -> (scheduler, executor) and drain; returns the
    outcome trace."""
    sched, ex = build(pkg)
    sched.drain()
    return _trace(sched.outcomes), sched, ex


def _same_in_both(build):
    got, sched, ex = _scenario(sv, build)
    want, _, _ = _scenario(ref_sv, build)
    assert got == want
    return sched, ex


def test_scheduler_completes_and_routes_outputs():
    def build(pkg):
        clk, ex, est = _sim(pkg=pkg)
        sched = pkg.Scheduler(ex, clock=clk, estimator=est,
                              batching=pkg.BatcherConfig(max_batch=2))
        for i in range(5):
            assert sched.submit(pkg.Request(image=_img(fill=i))) is None
        return sched, ex

    sched, _ = _same_in_both(build)
    done = {o.rid: o for o in sched.outcomes}
    assert len(done) == 5
    for out in done.values():
        assert isinstance(out, sv.Completed) and out.ok
        np.testing.assert_array_equal(out.output, out.request.image)
        assert out.attempts == 1 and not out.late
        assert out.finished >= out.started >= out.request.arrival
    assert len(sched.queue) == 0


def test_expired_request_is_shed_not_dispatched():
    clk, ex, est = _sim()
    sched = sv.Scheduler(ex, clock=clk, estimator=est)
    req = sv.Request(image=_img(), deadline=clk.now() + 0.01)
    sched.submit(req)
    clk.advance(0.02)                    # deadline passes in the queue
    out = sched.drain()
    assert [type(o) for o in out] == [sv.Shed]
    assert out[0].reason == "expired" and out[0].rid == req.rid
    assert ex.calls == 0                 # NEVER ran


def test_expired_mid_batch_is_shed_before_the_attempt():
    def build(pkg):
        clk, ex, est = _sim(pkg=pkg)
        ex.fail_first = 10 ** 6
        sched = pkg.Scheduler(
            ex, clock=clk, estimator=est,
            config=pkg.SchedulerConfig(max_retries=3, backoff_s=0.05),
            batching=pkg.BatcherConfig(max_batch=2))
        sched.submit(pkg.Request(image=_img(), deadline=clk.now() + 0.04))
        return sched, ex

    sched, ex = _same_in_both(build)
    out = sched.outcomes
    assert [type(o) for o in out] == [sv.Shed]
    assert out[0].reason == "expired"
    assert ex.calls == 1                 # first attempt only


def test_retry_with_backoff_then_success():
    def build(pkg):
        clk, ex, est = _sim(pkg=pkg, fail_first=1)
        sched = pkg.Scheduler(ex, clock=clk, estimator=est,
                              config=pkg.SchedulerConfig(max_retries=2,
                                                         backoff_s=0.001))
        sched.submit(pkg.Request(image=_img()))
        return sched, ex

    sched, ex = _same_in_both(build)
    out = sched.outcomes
    assert [type(o) for o in out] == [sv.Completed]
    assert out[0].attempts == 2
    assert ex.calls == 2


def test_poisoned_request_isolated_neighbors_survive():
    def build(pkg):
        clk, ex, est = _sim(
            pkg=pkg,
            fail_when=lambda imgs: bool((imgs == 255).all(axis=(1, 2))
                                        .any()))
        sched = pkg.Scheduler(ex, clock=clk, estimator=est,
                              config=pkg.SchedulerConfig(max_retries=1,
                                                         backoff_s=0.0),
                              batching=pkg.BatcherConfig(max_batch=3))
        for fill in (1, 255, 2):
            sched.submit(pkg.Request(image=_img(fill=fill)))
        return sched, ex

    sched, _ = _same_in_both(build)
    for o in sched.outcomes:
        if int(o.request.image[0, 0]) == 255:
            assert isinstance(o, sv.Failed) and o.attempts >= 3
        else:
            assert isinstance(o, sv.Completed)
            np.testing.assert_array_equal(o.output, o.request.image)


def test_timeout_verdict_routes_through_straggler_late():
    clk = sv.VirtualClock()
    ex = sv.SimExecutor(clk, pix_per_s=1e4)        # 100x slower than est
    est = sv.CostEstimator(pix_per_s=1e6)
    mon = StragglerMonitor(StragglerConfig(min_samples=1 << 30))
    sched = sv.Scheduler(ex, clock=clk, estimator=est, straggler=mon,
                         config=sv.SchedulerConfig(timeout_factor=4.0))
    sched.submit(sv.Request(image=_img()))
    out = sched.drain()
    assert isinstance(out[0], sv.Completed)
    assert out[0].late                    # late but served, not dropped
    assert len(mon.times) == 1            # verdict recorded in the monitor


# ------------------------------------------------------------ breaker --

class _FakeLadder:
    """Duck-typed DegradePolicy: records forced fallbacks."""

    def __init__(self, rungs=3):
        self.level = 0
        self.ladder = tuple(range(rungs))

    @property
    def exhausted(self):
        return self.level >= len(self.ladder)

    def force_fallback(self):
        if self.exhausted:
            return False
        self.level += 1
        return True


def test_breaker_state_machine():
    br = sv.CircuitBreaker(sv.BreakerConfig(failure_threshold=2,
                                            cooldown_s=1.0,
                                            probe_successes=2))
    assert br.allow(0.0) and br.state == sv.CLOSED
    br.record_failure(0.0)
    assert br.state == sv.CLOSED
    br.record_failure(0.1)
    assert br.state == sv.OPEN and br.trips == 1
    assert not br.allow(0.5)
    assert br.retry_after(0.5) == pytest.approx(0.6)
    assert br.allow(1.2) and br.state == sv.HALF_OPEN and br.probing
    br.record_success(1.3)
    assert br.state == sv.HALF_OPEN
    br.record_success(1.4)
    assert br.state == sv.CLOSED and not br.probing
    br.record_drift(2.0)
    assert br.state == sv.OPEN and br.trips == 2


def test_failed_probe_reopens_and_degrades_again():
    pol = _FakeLadder()
    br = sv.CircuitBreaker(sv.BreakerConfig(failure_threshold=1,
                                            cooldown_s=0.5), policy=pol)
    br.record_failure(0.0)
    assert pol.level == 1
    assert br.allow(0.6)
    br.record_failure(0.7)
    assert br.state == sv.OPEN and br.trips == 2 and pol.level == 2
    assert not br.allow(0.8)


def test_breaker_trips_degrades_and_recovers_in_scheduler():
    def build(pkg):
        clk, ex, est = _sim(pkg=pkg, fail_first=2)
        br = pkg.CircuitBreaker(pkg.BreakerConfig(failure_threshold=2,
                                                  cooldown_s=0.01),
                                policy=_FakeLadder())
        sched = pkg.Scheduler(ex, clock=clk, estimator=est, breaker=br,
                              config=pkg.SchedulerConfig(max_retries=2,
                                                         backoff_s=0.001),
                              batching=pkg.BatcherConfig(max_batch=4))
        for i in range(8):
            sched.submit(pkg.Request(image=_img(fill=i)))
        return sched, ex

    sched, ex = _same_in_both(build)
    br = sched.breaker
    assert all(isinstance(o, sv.Completed) for o in sched.outcomes)
    assert len(sched.outcomes) == 8
    assert br.trips == 1 and br.state == sv.CLOSED
    assert br.policy.level == 1
    assert ex.failures == 2


def test_breaker_steps_real_pareto_ladder():
    """A breaker trip lands the attached DegradePolicy on the
    next-cheapest rung of the port's exact Pareto ladder (recompiled
    without the fault, on the CPU), and the half-open probe recovers."""
    from repro_torch.imgproc.plan import PIPELINES, compile_pipeline
    from repro_torch.resilience.degrade import DegradePolicy
    from repro_torch.resilience.faults import FaultSpec
    pipe = compile_pipeline(PIPELINES["pipe_blur_sharpen_down"],
                            kind="haloc_axa",
                            fault=FaultSpec("stuck_at_1", bits=(11,)),
                            **CPU)
    pol = DegradePolicy(pipe, min_samples=512)
    base_spec = pipe.engine.spec
    clk, ex, est = _sim(fail_first=1)
    br = sv.CircuitBreaker(sv.BreakerConfig(failure_threshold=1,
                                            cooldown_s=0.01), policy=pol)
    sched = sv.Scheduler(ex, clock=clk, estimator=est, breaker=br,
                         config=sv.SchedulerConfig(max_retries=1,
                                                   backoff_s=0.001))
    for i in range(3):
        sched.submit(sv.Request(image=_img(fill=i)))
    sched.drain()
    assert br.trips >= 1 and br.state == sv.CLOSED
    assert pol.level >= 1
    assert pol.pipe.engine.spec == pol.ladder[pol.level - 1]
    assert pol.pipe.engine.spec != base_spec
    assert pol.pipe.engine.fault is None
    assert pol.pipe.engine.device.type == "cpu"
    assert all(isinstance(o, sv.Completed) for o in sched.outcomes)


# --------------------------------------------- overload (acceptance) --

def _traffic_cell(rate_rps, n, seed, depth=64, backlog_s=float("inf"),
                  pkg=sv):
    clk, ex, est = _sim(pkg=pkg)
    sched = pkg.Scheduler(
        ex, clock=clk, estimator=est,
        admission=pkg.AdmissionConfig(max_depth=depth,
                                      max_backlog_s=backlog_s),
        batching=pkg.BatcherConfig(max_batch=4, max_wait_s=0.002))
    mix = pkg.TrafficMix("cell", rate_rps=rate_rps, sizes=(32, 64),
                         size_weights=(0.8, 0.2), deadline_s=0.05)
    rep = pkg.run_traffic(sched, pkg.make_arrivals(mix, n=n, seed=seed),
                          mix.name)
    return rep, sched, ex


def test_overload_sheds_and_bounds_latency():
    base, _, _ = _traffic_cell(100.0, n=80, seed=3)
    assert len(base.completed) == base.offered == 80
    assert base.deadline_misses == 0

    over, sched, ex = _traffic_cell(1200.0, n=400, seed=4,
                                    depth=12, backlog_s=0.010)
    assert len(over.rejected) > 0 and len(over.shed) > 0
    assert len(over.completed) > 0
    assert len(sched.queue) == 0
    assert over.offered == 400
    assert over.p99_s <= 3.0 * base.p99_s
    assert all(c.started < c.request.deadline for c in over.completed)
    assert over.goodput_mpix_per_s > base.goodput_mpix_per_s
    # the reference's scheduler makes every decision the same way
    ref, _, _ = _traffic_cell(1200.0, n=400, seed=4, depth=12,
                              backlog_s=0.010, pkg=ref_sv)
    assert _trace(over.outcomes) == _trace(ref.outcomes)
    assert over.record(load_x=2.0) == ref.record(load_x=2.0)


def test_overload_replays_bit_identically():
    a, _, _ = _traffic_cell(1200.0, n=200, seed=11, depth=12,
                            backlog_s=0.010)
    b, _, _ = _traffic_cell(1200.0, n=200, seed=11, depth=12,
                            backlog_s=0.010)
    assert [type(o).__name__ for o in a.outcomes] == \
        [type(o).__name__ for o in b.outcomes]
    assert a.seconds == b.seconds
    assert a.p99_s == b.p99_s or (np.isnan(a.p99_s) and np.isnan(b.p99_s))
    assert a.record(load_x=2.0) == b.record(load_x=2.0)


def test_priority_survives_overload():
    clk, ex, est = _sim()
    sched = sv.Scheduler(
        ex, clock=clk, estimator=est,
        admission=sv.AdmissionConfig(max_depth=4),
        batching=sv.BatcherConfig(max_batch=4, max_wait_s=1.0))
    lows = [sv.Request(image=_img(fill=i), priority=0) for i in range(4)]
    for r in lows:
        assert sched.submit(r) is None
    hi = sv.Request(image=_img(fill=99), priority=1)
    assert sched.submit(hi) is None       # preempts, not rejected
    preempted = [o for o in sched.outcomes if isinstance(o, sv.Shed)]
    assert len(preempted) == 1 and preempted[0].reason == "preempted"
    sched.drain()
    done = {o.rid: o for o in sched.outcomes}
    assert isinstance(done[hi.rid], sv.Completed)


# ------------------------------------------------- traffic / reports --

def test_make_arrivals_deterministic_and_ordered():
    a = sv.make_arrivals(sv.MIXED_MIX, n=32, seed=5)
    b = sv.make_arrivals(sv.MIXED_MIX, n=32, seed=5)
    ref = ref_sv.make_arrivals(ref_sv.MIXED_MIX, n=32, seed=5)
    assert [t for t, _ in a] == [t for t, _ in b] == [t for t, _ in ref]
    assert [t for t, _ in a] == sorted(t for t, _ in a)
    for (_, ra), (_, rb), (_, rr) in zip(a, b, ref):
        np.testing.assert_array_equal(ra.image, rb.image)
        np.testing.assert_array_equal(ra.image, rr.image)
        assert ra.deadline - rb.deadline == 0.0
        assert (ra.deadline, ra.priority) == (rr.deadline, rr.priority)
    sizes = {ra.image.shape[0] for _, ra in a}
    assert sizes <= {32, 64, 128} and 32 in sizes


def test_empty_traffic_report_is_well_formed():
    clk, ex, est = _sim()
    sched = sv.Scheduler(ex, clock=clk, estimator=est)
    rep = sv.run_traffic(sched, [], "empty")
    assert rep.offered == 0
    assert rep.goodput_mpix_per_s == 0.0
    assert rep.reject_rate == rep.shed_rate == 0.0
    assert np.isnan(rep.p50_s) and np.isnan(rep.p99_s)
    rec = rep.record()
    assert rec["p50_ms"] is None and rec["p99_ms"] is None
    assert "offered" in rep.summary()


def test_report_record_shape():
    rep, _, _ = _traffic_cell(100.0, n=40, seed=9)
    rec = rep.record(load_x=0.2, backend="sim")
    assert rec["op"] == "serve_traffic" and rec["mix"] == "cell"
    assert rec["load_x"] == 0.2 and rec["backend"] == "sim"
    assert rec["completed"] == 40 and rec["offered"] == 40
    assert rec["p99_ms"] > 0 and rec["goodput_mpix_per_s"] > 0
    assert rec["reject_rate"] == 0.0 and rec["deadline_miss_rate"] == 0.0
    ref, _, _ = _traffic_cell(100.0, n=40, seed=9, pkg=ref_sv)
    assert rec == ref.record(load_x=0.2, backend="sim")


def _bench_sim_cell(name, load_x, n, seed, depth=64,
                    backlog_s=float("inf"), fail_first=0):
    """``benchmarks/bench_serve.py``'s ``_sim_cell`` on the port."""
    pix_per_s = 1e6
    mix = sv.TrafficMix(name, rate_rps=1.0, sizes=(32, 64),
                        size_weights=(0.8, 0.2), deadline_s=0.05)
    capacity_rps = pix_per_s / mix.mean_pixels
    mix = sv.TrafficMix(name, rate_rps=load_x * capacity_rps,
                        sizes=mix.sizes, size_weights=mix.size_weights,
                        deadline_s=mix.deadline_s)
    clk = sv.VirtualClock()
    ex = sv.SimExecutor(clk, pix_per_s=pix_per_s, fail_first=fail_first)
    breaker = sv.CircuitBreaker(sv.BreakerConfig(
        failure_threshold=2, cooldown_s=0.005)) if fail_first else None
    sched = sv.Scheduler(
        ex, clock=clk, estimator=sv.CostEstimator(pix_per_s=pix_per_s),
        admission=sv.AdmissionConfig(max_depth=depth,
                                     max_backlog_s=backlog_s),
        batching=sv.BatcherConfig(max_batch=4, max_wait_s=0.002),
        config=sv.SchedulerConfig(max_retries=2, backoff_s=0.001),
        breaker=breaker)
    return sv.run_traffic(sched, sv.make_arrivals(mix, n=n, seed=seed),
                          name)


@pytest.mark.parametrize("cell", [
    ("uncontended", 0.2, dict(n=120, seed=3)),
    ("overload", 2.0, dict(n=400, seed=4, depth=12, backlog_s=0.010)),
    ("breaker", 0.5, dict(n=60, seed=5, fail_first=2)),
], ids=lambda c: c[0])
def test_sim_cells_equal_bench_serve(cell):
    """The three simulated cells of ``benchmarks/bench_serve.py`` (its
    quick parameters) equal ``BENCH_serve.json`` field for field, apart
    from the provenance keys."""
    name, load_x, kw = cell
    rec = _bench_sim_cell(name, load_x, **kw).record(
        load_x=load_x, backend="sim", kind="haloc_axa")
    committed = [r for r in json.loads((ROOT / "BENCH_serve.json")
                                       .read_text())
                 if r["backend"] == "sim" and r["mix"] == name]
    assert len(committed) == 1
    want = {k: v for k, v in committed[0].items()
            if k not in ("host_platform", "jax_version", "device_kind")}
    assert rec == want


def test_plan_executor_end_to_end():
    """Production wiring: the scheduler drives compiled plans on the
    ``"torch"`` backend on the CPU, and the outputs match a direct
    pipeline call and the reference's numpy executor."""
    from repro.imgproc.plan import PIPELINES as REF_PIPELINES
    from repro.imgproc.plan import compile_pipeline as ref_compile
    from repro_torch.image.pipeline import synthetic_image
    from repro_torch.imgproc.plan import PIPELINES, compile_pipeline
    ex = sv.PlanExecutor.compile(("pipe_blur_sharpen_down",), **CPU)
    clk = sv.VirtualClock()
    sched = sv.Scheduler(ex, clock=clk,
                         batching=sv.BatcherConfig(max_batch=2))
    imgs = [synthetic_image(32, seed=40 + i) for i in range(3)]
    reqs = [sv.Request(image=im) for im in imgs]
    for r in reqs:
        assert sched.submit(r) is None
    sched.drain()
    pipe = compile_pipeline(PIPELINES["pipe_blur_sharpen_down"],
                            kind="haloc_axa", **CPU)
    golden = pipe(np.stack(imgs)).numpy()
    ref_golden = np.asarray(ref_compile(
        REF_PIPELINES["pipe_blur_sharpen_down"], kind="haloc_axa",
        backend="numpy")(np.stack(imgs)))
    np.testing.assert_array_equal(golden, ref_golden)
    ref_ex = ref_sv.PlanExecutor.compile(("pipe_blur_sharpen_down",),
                                         backend="numpy")
    np.testing.assert_array_equal(
        ex(np.stack(imgs), "pipe_blur_sharpen_down"),
        ref_ex(np.stack(imgs), "pipe_blur_sharpen_down"))
    done = {o.rid: o for o in sched.outcomes}
    for i, r in enumerate(reqs):
        assert isinstance(done[r.rid], sv.Completed)
        assert isinstance(done[r.rid].output, np.ndarray)
        np.testing.assert_array_equal(done[r.rid].output, golden[i])
    with pytest.raises(KeyError, match="unknown pipeline"):
        ex(np.stack(imgs), "nope")


def test_plan_executor_serves_a_degrade_policy():
    """A DegradePolicy behind the executor: the batch goes to the
    policy's CURRENT plan (its device), so a breaker-driven fallback is
    what the next batch runs."""
    from repro_torch.image.pipeline import synthetic_image
    from repro_torch.imgproc.plan import PIPELINES, compile_pipeline
    from repro_torch.resilience.degrade import DegradePolicy
    pipe = compile_pipeline(PIPELINES["pipe_blur_sharpen_down"],
                            kind="haloc_axa", **CPU)
    pol = DegradePolicy(pipe, min_samples=256)
    ex = sv.PlanExecutor({"p": pol})
    imgs = np.stack([synthetic_image(32, seed=s) for s in (1, 2)])
    np.testing.assert_array_equal(ex(imgs, "p"), pipe(imgs).numpy())
    assert pol.force_fallback()
    np.testing.assert_array_equal(ex(imgs, "p"), pol.pipe(imgs).numpy())


# -------------------------------------------------------- observability --

def test_serving_metrics_and_spans(fresh_obs):
    rep, _, _ = _traffic_cell(1200.0, n=120, seed=6, depth=12,
                              backlog_s=0.010)
    snap = obs.metrics_snapshot(prefix="serve.")
    c = snap["counters"]
    assert c["serve.completed"] == len(rep.completed)
    assert c.get("serve.rejected", 0) == len(rep.rejected)
    assert c.get("serve.shed", 0) == len(rep.shed)
    assert len(rep.rejected) + len(rep.shed) > 0
    assert c["serve.admitted"] == rep.offered - len(rep.rejected)
    assert snap["histograms"]["serve.batch_occupancy"]["count"] > 0
    assert snap["histograms"]["serve.queue_wait_s"]["count"] == \
        len(rep.completed)
    assert snap["gauges"]["serve.queue_depth"]["value"] == 0
    assert all(k.startswith("serve.") for t in ("counters", "gauges",
                                                "histograms")
               for k in snap[t])
    names = {e.name for e in obs.get_tracer().events}
    assert {"serve:submit", "serve:batch", "serve:execute"} <= names


def test_serving_is_zero_cost_when_telemetry_off():
    obs.reset_all()
    assert not obs.enabled()
    rep, _, _ = _traffic_cell(100.0, n=30, seed=8)
    assert len(rep.completed) == 30
    snap = obs.metrics_snapshot()
    assert not any(k.startswith("serve.") for k in snap["counters"])
    assert obs.get_tracer().events == ()


def test_metrics_snapshot_prefix_filter(fresh_obs):
    obs.counter("serve.x").inc(3)
    obs.counter("stream.y").inc(2)
    obs.gauge("serve.g").set(1)
    full = obs.metrics_snapshot()
    assert "caches" in full and "stream.y" in full["counters"]
    flt = obs.metrics_snapshot(prefix="serve.")
    assert flt["counters"] == {"serve.x": 3}
    assert set(flt["gauges"]) == {"serve.g"}
    assert "caches" not in flt


# -------------------------------------------------- config validation --

@pytest.mark.parametrize("make,match", [
    (lambda p: p.AdmissionConfig(max_depth=0), "max_depth"),
    (lambda p: p.AdmissionConfig(max_backlog_s=0.0), "max_backlog_s"),
    (lambda p: p.BatcherConfig(max_batch=0), "max_batch"),
    (lambda p: p.BatcherConfig(max_wait_s=-1), "max_wait_s"),
    (lambda p: p.BatcherConfig(safety=0.0), "safety"),
    (lambda p: p.SchedulerConfig(max_retries=-1), "max_retries"),
    (lambda p: p.SchedulerConfig(backoff_s=-0.1), "backoff_s"),
    (lambda p: p.SchedulerConfig(timeout_factor=0.0), "timeout_factor"),
    (lambda p: p.BreakerConfig(failure_threshold=0), "failure_threshold"),
    (lambda p: p.BreakerConfig(cooldown_s=-1), "cooldown_s"),
    (lambda p: p.BreakerConfig(probe_successes=0), "probe_successes"),
    (lambda p: p.TrafficMix("bad", rate_rps=0.0), "rate_rps"),
    (lambda p: p.TrafficMix("bad", rate_rps=1.0, sizes=()), "sizes"),
])
def test_config_validation_rejects_bad_knobs(make, match):
    with pytest.raises(ValueError, match=match) as got:
        make(sv)
    with pytest.raises(ValueError) as want:
        make(ref_sv)
    assert str(got.value) == str(want.value)


def test_straggler_monitor_configs_are_not_shared():
    a = StragglerMonitor()
    b = StragglerMonitor()
    assert a.cfg is not b.cfg
    a.cfg.window = 7
    assert b.cfg.window == 32


def test_exports_match_the_reference():
    assert sorted(sv.__all__) == sorted(ref_sv.__all__)


@pytest.mark.slow
def test_long_overload_campaign_stays_bounded():
    """10x the quick overload cell, still virtual time: the shedding
    contract must hold over a long campaign, not just the smoke run —
    no unbounded queue, bounded accepted-latency, goodput sustained."""
    base, _, _ = _traffic_cell(100.0, n=800, seed=3)
    over, sched, _ = _traffic_cell(1200.0, n=4000, seed=4,
                                   depth=12, backlog_s=0.010)
    assert over.offered == 4000
    assert len(sched.queue) == 0
    assert len(over.rejected) > 0 and len(over.shed) > 0
    assert over.p99_s <= 3.0 * base.p99_s
    assert over.goodput_mpix_per_s > base.goodput_mpix_per_s
    for o in over.completed:
        assert o.started < o.request.deadline
