"""The port's package boundary and device rules, and its fixed point.

- ``repro_torch`` imports neither jax nor the ``repro`` package (checked
  in a subprocess: other test files load jax into the same worker, with
  telemetry on, a fault injected, a degrade policy and a stream, and the
  integrity, serving and I/O modules driven: lazy exports, the store's
  salt, a scrub, a canary, ABFT, the detection campaign's helpers and a
  served plan; and the LM path: the launcher, the transformer, the
  numerics config, a windowed smoke model generating under haloc_axa,
  an MLA + MoE smoke model, an RG-LRU and an SSD one generating; the
  deprecated kernel shims and the examples, one of them run)
  and no source file under ``src/repro_torch`` (``obs``, ``resilience``,
  ``runtime``, ``integrity``, ``serving``, ``models``, ``launch``,
  ``configs``, ``sharding`` and ``examples`` included, which import
  ``torch.distributed``) names them;
- a default engine asks for the card and raises without one, naming the
  explicit CPU spelling;
- ``quantize`` and the container conversions equal ``repro``'s on the
  same inputs (exact: the datapath is integer).
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.numerics import fixed_point as fp_j
from repro_torch.ax import backends as be_t
from repro_torch.ax import make_engine
from repro_torch.imgproc import compile_pipeline
from repro_torch.kernels.approx_add import adder_args
from repro_torch.numerics import fixed_point as fp_t
from repro_torch.core.specs import AdderSpec

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def test_import_and_cpu_pipeline_load_no_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import repro_torch\n"
        "from repro_torch.imgproc import compile_pipeline, synthetic_batch\n"
        "pipe = compile_pipeline(('gaussian_blur', 'sharpen', "
        "'downsample2x'), backend='torch', device='cpu')\n"
        "out = pipe(synthetic_batch(2, 16))\n"
        "assert tuple(out.shape) == (2, 8, 8), out.shape\n"
        "from repro_torch.ax import make_engine\n"
        "from repro_torch.imgproc import get_workload\n"
        "get_workload('conv3x3').run(synthetic_batch(1, 16), "
        "backend='torch', device='cpu')\n"
        "mac = make_engine('haloc_axa', mul='mitchell', backend='torch', "
        "device='cpu')\n"
        "mac.matmul(np.ones((2, 3), np.int8), np.ones((3, 2), np.int8))\n"
        "mac.mul(np.ones(4, np.int32), np.ones(4, np.int32))\n"
        "from repro_torch.ax.analytics import exact_error_metrics\n"
        "from repro_torch.core import hwcost, metrics\n"
        "from repro_torch.core.specs import AdderSpec\n"
        "exact_error_metrics(AdderSpec('haloc_axa', 8, 4, 2), "
        "device='cpu')\n"
        "hwcost.report(AdderSpec('loa', 8, 4, 0), device='cpu')\n"
        "metrics.simulate_error_metrics(AdderSpec('loa', 8, 4, 0), "
        "n_samples=100, device='cpu')\n"
        "from repro_torch import obs\n"
        "from repro_torch.imgproc import run_streaming\n"
        "from repro_torch.resilience import FaultSpec, DegradePolicy\n"
        "from repro_torch.resilience.harness import run_campaign\n"
        "from repro_torch.runtime.straggler import StragglerConfig\n"
        "obs.enable()\n"
        "bad_pipe = compile_pipeline(('gaussian_blur', 'sharpen', "
        "'downsample2x'), backend='torch', device='cpu', "
        "fault=FaultSpec('stuck_at_1', (11,)))\n"
        "pol = DegradePolicy(bad_pipe, min_samples=64, "
        "ladder=(AdderSpec('accurate', 16),))\n"
        "with obs.installed(obs.DriftMonitor(AdderSpec('haloc_axa', 16, 8, "
        "4))):\n"
        "    r = run_streaming(bad_pipe, [synthetic_batch(1, 16)] * 2, "
        "degrade=pol, straggler=StragglerConfig())\n"
        "assert len(r.outputs) == 2\n"
        "obs.sync_span(out)\n"
        "obs.disable()\n"
        "import repro_torch.integrity as integ\n"
        "import repro_torch.serving as sv\n"
        "from repro_torch import ioutil\n"
        "from repro_torch.integrity import store\n"
        "assert 'torch=' in store._version_salt()\n"
        "ioutil.sha256_bytes(b'x')\n"
        "eng = make_engine('haloc_axa', backend='torch', device='cpu', "
        "strategy='lut', integrity=True)\n"
        "assert integ.CanarySuite(eng, n=16).run_once(0.0).ok\n"
        "assert integ.LutScrubber(cache='ax.lut.device').scrub_once().ok\n"
        "v = integ.AbftChecker(mac).matmul(np.ones((2, 3), np.int8), "
        "np.ones((3, 2), np.int8))\n"
        "assert v.ok, v\n"
        "assert integ.mac_error_budget(eng.spec, None, 4, 1, 0) > 0\n"
        "from repro_torch.resilience.harness import _bus_fault_observable\n"
        "_bus_fault_observable(eng.spec, FaultSpec('stuck_at_1', (3,)), 0)\n"
        "ex = sv.PlanExecutor.compile(('pipe_blur_sharpen_down',), "
        "backend='torch', device='cpu')\n"
        "sched = sv.Scheduler(ex, clock=sv.VirtualClock(), integrity=("
        "integ.LutScrubber(interval_s=1.0),))\n"
        "rep = sv.run_traffic(sched, sv.make_arrivals(sv.SMALL_MIX, n=2, "
        "seed=0))\n"
        "assert len(rep.completed) == 2, rep.summary()\n"
        "import repro_torch.launch.serve\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.launch.steps import params_shapes\n"
        "from repro_torch.models import transformer as T\n"
        "from repro_torch.models.serving import generate\n"
        "from repro_torch.numerics.approx_ops import make_numerics\n"
        "lm = get_smoke_config('gemma3-27b').with_approx(make_numerics("
        "'haloc_axa', 'residual', backend='torch', device='cpu'))\n"
        "lp = T.init_params(0, lm, device='cpu')\n"
        "toks = generate(lp, lm, {'tokens': np.zeros((1, 20), np.int32)}, 2)\n"
        "assert tuple(toks.shape) == (1, 22), toks.shape\n"
        "ps = params_shapes(get_smoke_config('qwen3-4b'))\n"
        "import torch.distributed\n"
        "from repro_torch.sharding import rules as R\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "from repro_torch.launch.input_specs import batch_specs\n"
        "from repro_torch.launch.dryrun import active_param_count\n"
        "from repro_torch.runtime.elastic import choose_mesh_shape\n"
        "R.tree_shardings(ps, make_production_mesh(), R.PARAM_RULES)\n"
        "assert choose_mesh_shape(240, 16) == (15, 16)\n"
        "ds = get_smoke_config('deepseek-v2-236b')\n"
        "dp = T.init_params(0, ds, device='cpu')\n"
        "toks = generate(dp, ds, {'tokens': np.zeros((2, 8), np.int32)}, 2)\n"
        "assert tuple(toks.shape) == (2, 10), toks.shape\n"
        "for arch in ('recurrentgemma-9b', 'mamba2-1.3b'):\n"
        "    rc = get_smoke_config(arch)\n"
        "    rcp = T.init_params(0, rc, device='cpu')\n"
        "    toks = generate(rcp, rc, {'tokens': np.zeros((2, 9), np.int32)}, 2)\n"
        "    assert tuple(toks.shape) == (2, 11), toks.shape\n"
        "import repro_torch.kernels.ops\n"
        "from repro_torch.examples import (adder_design_space, approx_mac, "
        "image_reconstruction, quickstart, serve_decode, train_approx_lm)\n"
        "approx_mac.main(['--device', 'cpu', '--size', '16'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


def test_sources_name_neither_jax_nor_repro():
    pattern = re.compile(
        r"^\s*(import\s+jax|from\s+jax|from\s+repro\.|import\s+repro\.|"
        r"from\s+repro\s+import|import\s+repro\s*$)", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for sub in ("obs", "resilience", "runtime", "integrity", "serving",
                "models", "launch", "configs", "sharding", "examples"):
        scanned = [f for f in files if f.parent == PKG / sub]
        assert len(scanned) >= 2, sub
    assert PKG / "ioutil.py" in files
    for name in ("moe.py", "mla.py", "rglru.py", "ssd.py", "layers.py",
                 "transformer.py"):
        assert PKG / "models" / name in files
    for name in ("quickstart.py", "adder_design_space.py",
                 "image_reconstruction.py", "approx_mac.py",
                 "serve_decode.py", "train_approx_lm.py"):
        assert PKG / "examples" / name in files
    assert PKG / "kernels" / "ops.py" in files
    for path in files:
        text = path.read_text()
        assert not pattern.search(text), path
        assert "import jax" not in text, path


def test_check_ported_names_each_family_s_roadmap_item():
    """Every family is ported (dense, MoE, MLA, RG-LRU, SSD, and the
    vision and audio ones with cross attention): ``check_ported`` accepts
    all ten archs; the part that was left, sharding, is ported too: no
    ROADMAP item is named any more."""
    from repro_torch.configs import arch_names, get_config, get_smoke_config
    from repro_torch.models import transformer as T
    names = arch_names()
    assert len(names) == 10
    for name in names:
        for cfg in (get_config(name), get_smoke_config(name)):
            assert T.check_ported(cfg) is cfg
    assert not hasattr(T, "_UNPORTED") and not hasattr(T, "_no_sharding")
    for name in ("sharding/rules.py", "launch/mesh.py", "launch/dryrun.py",
                 "launch/input_specs.py", "runtime/elastic.py"):
        assert "Queue A item" not in (PKG / name).read_text(), name


def test_default_engine_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='torch', device='cpu'"):
        make_engine("haloc_axa")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_pipeline(("gaussian_blur",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_engine("haloc_axa", backend="torch")


def test_backend_and_device_rules():
    assert be_t.get_backend(None).name == "cuda"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        make_engine("haloc_axa", backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        make_engine("haloc_axa", backend="jax", device="cpu")
    ax = make_engine("haloc_axa", backend="torch", device="cpu")
    assert ax.device == torch.device("cpu") and ax.backend.name == "torch"
    assert make_engine("haloc_axa", backend="torch", device="cpu") is ax
    cpu = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        be_t.get_backend("cuda").add(cpu, cpu, ax.spec)


def test_unported_options_raise():
    assert make_engine("haloc_axa", backend="torch", device="cpu",
                       strategy="lut").strategy == "lut"
    # fault injection is ported: a FaultSpec is taken, anything else is
    # refused as the reference refuses it
    from repro_torch.resilience.faults import FaultSpec
    assert make_engine("haloc_axa", backend="torch", device="cpu",
                       fault=FaultSpec("stuck_at_1", (3,))).fault.bits == (3,)
    with pytest.raises(ValueError, match="FaultSpec or None"):
        make_engine("haloc_axa", backend="torch", device="cpu",
                    fault=object())
    spec = AdderSpec("haloc_axa", 16, 8, 4)
    t = torch.zeros((2, 3), dtype=torch.int32)
    # The cuda backend's lut kernel is the elementwise add's only, as on
    # the reference's Pallas backends.
    be = be_t.get_backend("cuda")
    with pytest.raises(NotImplementedError, match="elementwise add"):
        be.accumulate(t, spec, strategy="lut")
    with pytest.raises(NotImplementedError, match="elementwise add"):
        be.filter_chain(t, spec, (), strategy="lut")
    assert make_engine("haloc_axa", backend="torch", device="cpu",
                       strategy="auto").strategy == "fused"


def test_custom_kind_has_no_device_function():
    from repro_torch.ax.registry import register_adder, unregister_adder

    @register_adder("test_or_adder", order=999)
    def or_add(a, b, spec):
        return a | b

    try:
        spec = AdderSpec("test_or_adder", 16, 8, 4)
        with pytest.raises(NotImplementedError, match="test_or_adder"):
            adder_args(spec, False)
        ax = make_engine(spec, backend="torch", device="cpu")
        got = ax.add(np.array([5, 9], np.int32), np.array([2, 8], np.int32))
        assert got.tolist() == [7, 9]
    finally:
        unregister_adder("test_or_adder")


@pytest.mark.parametrize("n_bits,frac", [(16, 0), (16, 3), (16, 8), (8, 2),
                                         (30, 12)])
def test_quantize_matches_reference(n_bits, frac):
    fmt_j = fp_j.FixedPointFormat(n_bits, frac)
    fmt_t = fp_t.FixedPointFormat(n_bits, frac)
    rng = np.random.default_rng(n_bits * 31 + frac)
    step = 2.0 ** -frac
    halves = (np.arange(-40, 40) + 0.5) * step          # exact ties
    big = np.array([1e9, -1e9, fmt_t.max_int * step * 2,
                    fmt_t.min_int * step * 2, 255.0, -0.0, 0.0])
    x = np.concatenate([halves, big,
                        rng.uniform(-300, 300, 500)]).astype(np.float32)
    want = np.asarray(fp_j.quantize(jnp.asarray(x), fmt_j))
    got = fp_t.quantize(torch.as_tensor(x), fmt_t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    q = rng.integers(fmt_t.min_int, fmt_t.max_int + 1, 300).astype(np.int32)
    u = fp_t.signed_to_container(torch.as_tensor(q), fmt_t)
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(fp_j.signed_to_container(jnp.asarray(q),
                                                       fmt_j)))
    np.testing.assert_array_equal(
        fp_t.container_to_signed(u, fmt_t).numpy(), q)
    np.testing.assert_array_equal(
        fp_t.dequantize(torch.as_tensor(q), fmt_t).numpy(),
        np.asarray(fp_j.dequantize(jnp.asarray(q), fmt_j)))


def test_fixed_point_validation():
    with pytest.raises(ValueError):
        fp_t.FixedPointFormat(31, 0)
    with pytest.raises(ValueError):
        fp_t.FixedPointFormat(16, 16)
    assert fp_t.FixedPointFormat(16, 8).mask == 0xFFFF


def test_device_kind_table_is_the_headers():
    """The one kind-id table of the build covers every stock kind, and
    the device functions' switch in ``csrc/adders.cuh`` names exactly
    the ids that the build's -D flags define."""
    from repro_torch.core.specs import ALL_KINDS
    from repro_torch.kernels import _build

    assert set(_build.DEVICE_KINDS) == set(ALL_KINDS)
    assert len(set(_build.DEVICE_KINDS.values())) == len(_build.DEVICE_KINDS)
    header = (PKG / "csrc" / "adders.cuh").read_text()
    cases = set(re.findall(r"case (KIND_\w+):", header))
    defined = {d[2:].split("=")[0] for d in _build.DEFINES}
    # accurate is the switch's default case.
    assert cases | {"KIND_ACCURATE"} == {f"KIND_{k.upper()}"
                                         for k in _build.DEVICE_KINDS}
    assert cases <= defined
    for name in ("MAX_TERMS", "MAX_STAGES", "MAX_TAPS"):
        assert f"-D{name}={getattr(_build, name)}" in _build.DEFINES
    for src in PKG.glob("csrc/*.cu"):
        assert not re.search(r"#define (KIND_|MAX_)", src.read_text()), src
        assert "blocks_for(long long" not in src.read_text(), src


def test_mul_device_kind_table_is_the_header():
    """The multiplier kind ids of the build cover every stock multiplier,
    and ``csrc/muls.cuh``'s switch names exactly those the -D flags
    define (accurate is its default case)."""
    from repro_torch.ax.mul import registered_multipliers
    from repro_torch.kernels import _build

    assert set(_build.MUL_DEVICE_KINDS) == set(registered_multipliers())
    assert len(set(_build.MUL_DEVICE_KINDS.values())) == \
        len(_build.MUL_DEVICE_KINDS)
    header = (PKG / "csrc" / "muls.cuh").read_text()
    cases = set(re.findall(r"case (MUL_KIND_\w+):", header))
    defined = {d[2:].split("=")[0] for d in _build.DEFINES}
    assert cases | {"MUL_KIND_ACCURATE"} == {
        f"MUL_KIND_{k.upper()}" for k in _build.MUL_DEVICE_KINDS}
    assert cases <= defined
    assert "muls.cuh" in _build.HEADERS
    for name in ("mul", "mac_matmul", "conv2d_mac", "approx_matmul"):
        assert name in _build.SOURCES
        assert (PKG / "csrc" / f"{name}.cu").is_file()


def test_build_dir_rules(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    assert _build.build_dir() == ROOT / "build" / "repro_torch"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
    assert _build.build_dir() == tmp_path / "kernels"
    assert _build._lib_path("accumulate").parent == tmp_path / "kernels"
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR")
    monkeypatch.setattr(_build, "PACKAGE",
                        tmp_path / "lib" / "site-packages" / "repro_torch")
    with pytest.raises(RuntimeError, match="REPRO_TORCH_BUILD_DIR"):
        _build.build_dir()


def _chip_smoke_run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_refuses_without_a_card_or_the_repo(tmp_path):
    res = _chip_smoke_run(ROOT)
    assert res.returncode != 0 and '"ok"' not in res.stdout, res.stdout
    assert "cuda.is_available" in res.stderr
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    res = _chip_smoke_run(tmp_path)
    assert res.returncode != 0 and '"ok"' not in res.stdout, res.stdout
    assert "src/repro_torch" in res.stderr


def test_chip_smoke_bound_counts_least_operations():
    """The operations bound counts the adder in instructions
    (``HALOC_AXA_ADD``, held against the adder in test_torch_bounds.py),
    folds the taps' masks into the adds and scales only the taps whose
    weight is not 1."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gauss = (be_t.FilterStage(-1, (-1, 0, 1), (1, 2, 1), 2),
             be_t.FilterStage(-2, (-1, 0, 1), (1, 2, 1), 2))
    assert smoke.fold_ops((1, 1, 1)) == 2 * smoke.OPS_PER_ADD
    assert smoke.fold_ops((2, -1)) == 2 * smoke.OPS_PER_SCALE \
        + smoke.OPS_PER_ADD
    assert smoke.chain_ops(gauss) == 40
    assert smoke.chain_ops(gauss[:1]) + smoke.chain_ops(
        (be_t.FilterStage(-2, (1, -1), (1, -1)),)) == 20 + 0 + 1 + 8 + 1
