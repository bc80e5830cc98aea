"""The port's fault injection and self-healing (``repro_torch.resilience``)
against ``repro.resilience``, on the CPU.  Equality throughout.

- Fault masks: ``apply_fault`` and ``transient_flip_mask`` equal the
  reference's numpy versions for every fault kind, unsigned and signed,
  at N in {8, 16, 32} on int32 and int64 lanes, bit N-1 and the
  container-width boundary included.
- Faulted pipelines: both stock pipelines x both requant modes x three
  faults on a 2 x 37 x 41 batch equal the reference's ``numpy`` backend
  on the port's ``torch`` backend AND on the ``cuda`` backend's code run
  with its kernels' plain versions (the fault seam of the one-launch
  signed fold); a healthy ``cuda`` engine keeps the one-launch fold.
- Tables: ``corrupt_lut``, ``faulted_delta_table`` and
  ``faulted_mean_abs_error`` equal, the shared LUT cache untouched.
- Degradation: ``pareto_ladder``, ``DegradePolicy``'s trips and level,
  ``recovery_cell`` and ``run_campaign(quick=True)`` field for field.
- Validation: the reference's messages.
"""

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.core.specs import AdderSpec as RefSpec
from repro.imgproc.plan import run_pipeline as ref_run_pipeline
from repro.resilience import faults as ref_faults
from repro_torch import obs
from repro_torch.core.specs import AdderSpec
from repro_torch.imgproc import compile_pipeline, run_pipeline
from repro_torch.imgproc import synthetic_batch
from repro_torch.imgproc.plan import PIPELINES
from repro_torch.resilience import faults
from repro_torch.resilience.faults import FaultSpec

CPU = dict(backend="torch", device="cpu")
PIPE = PIPELINES["pipe_blur_sharpen_down"]
SPEC = AdderSpec("haloc_axa", 16, lsm_bits=8, const_bits=4)
REF_SPEC = RefSpec("haloc_axa", 16, lsm_bits=8, const_bits=4)


def ref_fault(f):
    return ref_faults.FaultSpec(f.kind, f.bits, rate=f.rate, seed=f.seed)


@pytest.fixture()
def both_obs():
    for o in (obs, ref_obs):
        o.reset_all()
        o.enable()
    yield
    for o in (obs, ref_obs):
        o.disable()
        o.reset_all()


# ----------------------------------------------------- FaultSpec API --

def test_fault_spec_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("stuck_high", bits=(1,))
    with pytest.raises(ValueError, match="at least one target bit"):
        FaultSpec("stuck_at_1", bits=())
    with pytest.raises(ValueError, match="duplicate fault bit"):
        FaultSpec("stuck_at_1", bits=(3, 3))
    with pytest.raises(ValueError, match="fault bit position"):
        FaultSpec("stuck_at_1", bits=(64,))
    with pytest.raises(ValueError, match="rate must be in"):
        FaultSpec("bit_flip", bits=(1,), rate=0.0)
    with pytest.raises(ValueError, match="rate must be in"):
        FaultSpec("bit_flip", bits=(1,), rate=1.5)
    with pytest.raises(ValueError, match="fault seed"):
        FaultSpec("bit_flip", bits=(1,), seed=-1)
    assert FaultSpec("stuck_at_1", bits=5).bits == (5,)
    assert FaultSpec("stuck_at_1", bits=(1, 4)).mask == 0b10010
    for f in (FaultSpec("stuck_at_1", (11,)),
              FaultSpec("bit_flip", (3, 11), rate=2 ** -5, seed=4)):
        assert f.short_name == ref_fault(f).short_name


def test_validate_fault_checks_bus_width():
    f = FaultSpec("stuck_at_1", bits=(40,))
    with pytest.raises(ValueError, match=r"N=16"):
        faults.validate_fault(f, 16)
    assert faults.validate_fault(f, 64) is f
    assert faults.validate_fault(None, 16) is None
    with pytest.raises(ValueError, match="FaultSpec or None"):
        faults.validate_fault("stuck_at_1", 16)


def test_fault_entry_point_validation_at_compile():
    from repro_torch.ax import make_engine
    with pytest.raises(ValueError, match="fault bit position"):
        compile_pipeline(PIPE, kind="haloc_axa",
                         fault=FaultSpec("stuck_at_1", bits=(40,)), **CPU)
    with pytest.raises(ValueError, match="fault bit position"):
        make_engine(SPEC, fault=FaultSpec("stuck_at_0", bits=(16,)), **CPU)
    with pytest.raises(ValueError, match="FaultSpec or None"):
        make_engine(SPEC, fault="stuck_at_0", **CPU)


# ----------------------------------------------------------- masks --

def _mask_faults(n):
    hi, lo = min(11, n - 2), 3
    out = []
    for bits in ((lo,), (hi, lo), (n - 1,), (0, n - 1)):
        out += [FaultSpec("stuck_at_0", bits), FaultSpec("stuck_at_1", bits)]
        out += [FaultSpec("bit_flip", bits, rate=r, seed=s)
                for r, s in ((0.25, 3), (1.0, 0))]
    return out


@pytest.mark.parametrize("n_bits", [8, 16, 32])
@pytest.mark.parametrize("lanes", [np.int32, np.int64])
@pytest.mark.parametrize("signed", [False, True])
def test_apply_fault_equals_reference(n_bits, lanes, signed):
    """Every kind, bit N-1 and bit 0, on int32 and int64 lanes: the int32
    N=32 case is the container-width boundary (bit 31 and the all-ones
    constants wrap instead of overflowing)."""
    rng = np.random.default_rng(n_bits)
    u = rng.integers(0, 1 << n_bits, (3, 5, 7), dtype=np.uint64)
    if signed:
        half = 1 << (n_bits - 1)
        x = ((u.astype(np.int64) ^ half) - half).astype(lanes)
    else:
        x = u.astype(np.uint32).astype(lanes) if lanes == np.int32 \
            else u.astype(lanes)
    for f in _mask_faults(n_bits):
        want = np.asarray(ref_faults.apply_fault(x.copy(), ref_fault(f),
                                                 n_bits, signed=signed))
        got = faults.apply_fault(torch.from_numpy(x.copy()), f, n_bits,
                                 signed=signed)
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_array_equal(got.numpy(), want.astype(lanes),
                                      err_msg=f.short_name)


def test_apply_fault_int64_lanes_equal_uint64_containers():
    """The reference's numpy containers are uint64; the port's wide lanes
    are int64 holding the same pattern."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 1 << 16, 256, dtype=np.uint64)
    for f in _mask_faults(16):
        want = ref_faults.apply_fault(x.copy(), ref_fault(f), 16)
        got = faults.apply_fault(torch.from_numpy(x.astype(np.int64)), f, 16)
        np.testing.assert_array_equal(got.numpy().view(np.uint64), want,
                                      err_msg=f.short_name)


@pytest.mark.parametrize("bits,rate,seed", [((2, 9), 0.5, 11),
                                            ((0, 31), 2 ** -8, 0),
                                            ((15,), 1.0, 4294967295)])
def test_transient_flip_mask_equals_reference(bits, rate, seed):
    f = FaultSpec("bit_flip", bits, rate=rate, seed=seed)
    idx = np.arange(70000, dtype=np.uint32)
    want = ref_faults.transient_flip_mask(idx, ref_fault(f))
    got = faults.transient_flip_mask(torch.from_numpy(
        idx.astype(np.int64)), f)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(faults.transient_flip_mask(idx, f),
                                  want.astype(np.int64))


def test_flip_mask_depends_on_the_trailing_dims_and_is_cached():
    from repro_torch.obs.caches import get_cached
    f = FaultSpec("bit_flip", (3, 11), rate=0.25, seed=1)
    m = faults.flip_mask((4, 9, 13), f, torch.int32, "cpu")
    assert m.shape == (9, 13) and m.dtype == torch.int32
    before = get_cached("resilience.faults.flip_mask").cache_info().hits
    assert faults.flip_mask((1, 9, 13), f, torch.int32, "cpu") is m
    assert get_cached("resilience.faults.flip_mask").cache_info().hits \
        == before + 1
    x = torch.zeros(4, 9, 13, dtype=torch.int32)
    out = faults.apply_fault(x, f, 16)
    assert all(torch.equal(out[i], m) for i in range(4))


# ----------------------------------------------- faulted pipelines --

PIPE_FAULTS = [FaultSpec("stuck_at_1", (11,)), FaultSpec("stuck_at_0", (11,)),
               FaultSpec("bit_flip", (3, 11), rate=2 ** -5, seed=0)]


def _cuda_backend_on_cpu(monkeypatch):
    """The ``cuda`` backend's code on the CPU: its CUDA-only guards lifted,
    its kernel wrappers then take CPU tensors to their plain versions."""
    from repro_torch.ax import backends, engine
    monkeypatch.setattr(backends.CudaBackend, "_require_cuda",
                        staticmethod(lambda what, *ts: None))
    real = engine.resolve_device

    def resolve(backend, device=None):
        if backend.name == "cuda" and str(device) == "cpu":
            return torch.device("cpu")
        return real(backend, device)

    monkeypatch.setattr(engine, "resolve_device", resolve)


@pytest.mark.parametrize("workload", sorted(PIPELINES))
@pytest.mark.parametrize("requant", ["stage", "fused"])
@pytest.mark.parametrize("fault", PIPE_FAULTS, ids=lambda f: f.short_name)
def test_faulted_pipeline_equals_reference(monkeypatch, workload, requant,
                                           fault):
    batch = synthetic_batch(2, 41, seed=3)[:, :37, :]
    stages = PIPELINES[workload]
    want = ref_run_pipeline(stages, batch, kind="haloc_axa",
                            backend="numpy", requant=requant,
                            fault=ref_fault(fault))
    got = run_pipeline(stages, batch, kind="haloc_axa", requant=requant,
                       fault=fault, **CPU)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    healthy = run_pipeline(stages, batch, kind="haloc_axa",
                           requant=requant, **CPU)
    assert not np.array_equal(got, healthy)
    _cuda_backend_on_cpu(monkeypatch)
    on_cuda_code = run_pipeline(stages, batch, kind="haloc_axa",
                                requant=requant, fault=fault,
                                backend="cuda", device="cpu")
    np.testing.assert_array_equal(on_cuda_code, want)


def test_the_signed_fold_takes_the_fault_seam(monkeypatch):
    """A healthy ``cuda`` engine folds, sign-extends and rounds in the one
    signed launch; a faulted one takes mask, the stacked accumulate, the
    fault, then sign extension and rounding — equal to the reference."""
    from repro.ax import make_engine as ref_make_engine
    from repro.numerics.fixed_point import FixedPointFormat as RefFormat
    from repro_torch.ax import backends, make_engine
    from repro_torch.numerics.fixed_point import FixedPointFormat
    _cuda_backend_on_cpu(monkeypatch)
    calls = []
    for name in ("accumulate", "accumulate_signed"):
        real = getattr(backends.CudaBackend, name)

        def counted(self, *a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(self, *a, **kw)

        monkeypatch.setattr(backends.CudaBackend, name, counted)
    rng = np.random.default_rng(7)
    qx = rng.integers(-2000, 2000, (3, 11, 9)).astype(np.int32)
    qy = rng.integers(-2000, 2000, (3, 11, 9)).astype(np.int32)
    fmt = FixedPointFormat(16, 3)
    for fault in [None] + PIPE_FAULTS:
        eng = make_engine(SPEC, fmt=fmt, backend="cuda", device="cpu",
                          fault=fault)
        ref = ref_make_engine(REF_SPEC, fmt=RefFormat(16, 3),
                              backend="numpy",
                              fault=None if fault is None
                              else ref_fault(fault))
        calls.clear()
        got = eng.scaled_add(torch.from_numpy(qx), torch.from_numpy(qy),
                             3, -2, shift=1)
        assert calls == (["accumulate_signed"] if fault is None
                         else ["accumulate"])
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ref.scaled_add(qx, qy, 3, -2, shift=1)))


# ------------------------------------------------------- tables --

@pytest.mark.parametrize("fault", [FaultSpec("stuck_at_1", (3,)),
                                   FaultSpec("stuck_at_0", (8,)),
                                   FaultSpec("bit_flip", (0, 7), rate=0.3,
                                             seed=9)],
                         ids=lambda f: f.short_name)
def test_lut_faults_equal_reference(fault):
    from repro_torch.ax.lut import compile_lut, device_table
    before = compile_lut(SPEC)
    dev_before = device_table(SPEC, "cpu").clone()
    bad = faults.corrupt_lut(SPEC, fault)
    np.testing.assert_array_equal(
        bad, ref_faults.corrupt_lut(REF_SPEC, ref_fault(fault)))
    assert not bad.flags.writeable
    assert compile_lut(SPEC) is before
    assert torch.equal(device_table(SPEC, "cpu"), dev_before)
    np.testing.assert_array_equal(
        faults.faulted_delta_table(SPEC, fault),
        ref_faults.faulted_delta_table(REF_SPEC, ref_fault(fault)))
    assert faults.faulted_mean_abs_error(SPEC, fault) == \
        ref_faults.faulted_mean_abs_error(REF_SPEC, ref_fault(fault))
    with pytest.raises(ValueError, match="packed LUT entries"):
        faults.corrupt_lut(SPEC, FaultSpec("stuck_at_1", bits=(12,)))


def test_faulted_delta_table_predicts_drift_trip():
    fault = FaultSpec("stuck_at_1", bits=(7,))
    mon = obs.DriftMonitor(SPEC)
    assert faults.faulted_mean_abs_error(SPEC, fault) > mon.threshold(10 ** 6)


# -------------------------------------------------- degradation --

def test_pareto_ladder_equals_reference():
    from repro.resilience.degrade import pareto_ladder as ref_ladder
    from repro_torch.resilience.degrade import pareto_ladder
    got = pareto_ladder(SPEC, "cpu")
    want = ref_ladder(REF_SPEC)
    assert [(s.kind, s.n_bits, s.lsm_bits, s.const_bits) for s in got] == \
        [(s.kind, s.n_bits, s.lsm_bits, s.const_bits) for s in want]
    assert got[-1].kind == "accurate"
    assert pareto_ladder(SPEC, "cpu") is got           # cached
    with pytest.raises(ValueError, match="no fallback"):
        pareto_ladder(AdderSpec("accurate", 16), "cpu")


def test_degrade_policy_requires_telemetry():
    from repro_torch.resilience.degrade import DegradePolicy
    obs.disable()
    pipe = compile_pipeline(PIPE, kind="haloc_axa", **CPU)
    pol = DegradePolicy(pipe, min_samples=256)
    with pytest.raises(RuntimeError, match="telemetry"):
        pol.observe(synthetic_batch(1, 32))


@pytest.mark.parametrize("fault", [None, FaultSpec("stuck_at_1", (11,)),
                                   FaultSpec("bit_flip", (3, 11),
                                             rate=2 ** -2, seed=0)],
                         ids=lambda f: "healthy" if f is None
                         else f.short_name)
def test_degrade_policy_trips_as_reference(both_obs, fault):
    """The same batches through the port's policy (a ``torch`` CPU plan)
    and the reference's (``numpy``): the same ladder, and after every
    batch the same trips, level, current spec and drift statuses."""
    from repro.imgproc.plan import compile_pipeline as ref_compile
    from repro.resilience.degrade import DegradePolicy as RefPolicy
    from repro_torch.resilience.degrade import DegradePolicy
    pipe = compile_pipeline(PIPE, kind="haloc_axa", fault=fault, **CPU)
    rpipe = ref_compile(PIPE, kind="haloc_axa", backend="numpy",
                        fault=None if fault is None else ref_fault(fault))
    pol, rpol = DegradePolicy(pipe, min_samples=512), \
        RefPolicy(rpipe, min_samples=512)
    assert [s.short_name for s in pol.ladder] == \
        [s.short_name for s in rpol.ladder]
    for i in range(3):
        batch = synthetic_batch(2, 40, seed=11 + i)
        assert pol.observe(batch) == rpol.observe(batch)
        assert (pol.trips, pol.level) == (rpol.trips, rpol.level)
        assert pol.pipe.engine.spec.short_name == \
            rpol.pipe.engine.spec.short_name
        assert [(s.stage, s.n, s.mean_abs, s.threshold, s.tripped)
                for s in pol.monitor.statuses()] == \
            [(s.stage, s.n, s.mean_abs, s.threshold, s.tripped)
             for s in rpol.monitor.statuses()]
        np.testing.assert_array_equal(pol.run(batch).numpy(),
                                      np.asarray(rpol.run(batch)))
    assert (pol.trips >= 1) == (fault is not None)
    if fault is not None:
        assert pol.pipe.engine.fault is None
        assert pol.pipe.engine.backend.name == "torch"


def test_force_fallback_and_integrity_alarm(both_obs):
    from repro_torch.resilience.degrade import DegradePolicy
    pipe = compile_pipeline(PIPE, kind="haloc_axa", **CPU)
    pol = DegradePolicy(pipe, min_samples=256,
                        ladder=(AdderSpec("accurate", 16),))
    assert pol.device == torch.device("cpu")
    assert pol.on_integrity_alarm()
    assert pol.exhausted and pol.level == 1
    assert not pol.force_fallback()
    assert obs.metrics_snapshot()["counters"]["degrade.trips"] == 1
    assert "accurate16" in repr(pol)


def test_recovery_cell_equals_reference(both_obs):
    from repro.resilience.harness import recovery_cell as ref_recovery
    from repro_torch.resilience.harness import recovery_cell
    got = recovery_cell(backend="torch", device="cpu")
    want = ref_recovery(backend="numpy")
    assert got.pop("backend") == "torch" and want.pop("backend") == "numpy"
    assert got == want
    assert got["trips"] >= 1 and got["recovery_db"] >= 5.0
    snap = obs.metrics_snapshot()
    assert snap["counters"]["degrade.trips"] >= 1
    assert snap["gauges"]["degrade.level"]["value"] >= 1


def test_quick_campaign_equals_reference():
    from repro.resilience.harness import run_campaign as ref_campaign
    from repro_torch.resilience.harness import default_campaign_faults, \
        run_campaign
    got = run_campaign(quick=True, backend="torch", device="cpu")
    want = ref_campaign(quick=True, backend="numpy")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        rg, rw = g.record(), w.record()
        assert rg.pop("backend") == "torch" and rw.pop("backend") == "numpy"
        assert rg == rw
    assert [f.short_name for f in default_campaign_faults()] == \
        [f.short_name for f in __import__(
            "repro.resilience.harness",
            fromlist=["x"]).default_campaign_faults()]
    with pytest.raises(ValueError, match="plan-compiled pipelines"):
        run_campaign(workloads=("blend",), **CPU)


def test_resilience_exports_are_lazy():
    import repro_torch.resilience as res
    assert res.FaultSpec is FaultSpec
    assert "DegradePolicy" in dir(res)
    with pytest.raises(AttributeError):
        res.detection_campaign
