"""The port's lut strategy (``repro_torch.ax.lut`` and the
``kernels/lut_add`` plain version) against the reference's, bit for bit.

- ``compile_lut`` equals ``repro.ax.lut.compile_lut`` byte for byte:
  every kind x every valid (m, k) at N=8, and the Table-1 kinds at the
  paper's m=10;
- ``make_engine(strategy="lut").add`` on ``torch``/CPU equals the
  reference's ``numpy`` lut add: exhaustive at N=8, sampled at n16m8k4
  and n32m10k5;
- the ``torch`` backend's lut ``accumulate``/``filter_chain`` and
  ``compile_pipeline(strategy="lut")`` equal the reference's ``jax``
  backend with lut;
- the unsupported-configuration errors match the reference's.

Inputs are made with numpy from a seed and given to both packages.  The
CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.ax import backends as be_j
from repro.ax import lut as lut_j
from repro.ax import make_engine as make_engine_j
from repro.core import specs as specs_j
from repro.imgproc import run_pipeline as run_pipeline_j
from repro_torch.ax import backends as be_t
from repro_torch.ax import lut as lut_t
from repro_torch.ax import make_engine as make_engine_t
from repro_torch.core import specs as specs_t
from repro_torch.imgproc import PIPELINES, run_pipeline, synthetic_batch
from repro_torch.kernels import lut_add as lut_k

KINDS = specs_j.ALL_KINDS
CPU = dict(backend="torch", device="cpu")


def _valid_mk(kind, n_bits):
    out = []
    for m in range(1, n_bits + 1):
        for k in range(0, m + 1):
            try:
                specs_j.AdderSpec(kind, n_bits, m, k)
            except ValueError:
                continue
            out.append((m, k))
    return out


def _containers(rng, shape, n_bits):
    u = rng.integers(0, 1 << n_bits, shape, dtype=np.uint64)
    return u.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("kind", KINDS)
def test_compile_lut_equals_reference(kind):
    if kind == "accurate":
        with pytest.raises(ValueError, match="exact"):
            lut_t.compile_lut(specs_t.AdderSpec(kind, 8))
        return
    cells = [(8, m, k) for m, k in _valid_mk(kind, 8)]
    if kind in specs_j.TABLE1_KINDS:
        cells.append((32, 10, 5))
    for n_bits, m, k in cells:
        sj = specs_j.AdderSpec(kind, n_bits, m, k)
        st = specs_t.AdderSpec(kind, n_bits, m, k)
        want = lut_j.compile_lut(sj)
        got = lut_t.compile_lut(st)
        assert got.dtype == np.uint16 and not got.flags.writeable
        assert got.tobytes() == want.tobytes(), st.short_name
        # one table per canonical (kind, m, k), on the host and per device
        assert lut_t.compile_lut(st.replace(n_bits=m)) is got
        dev = lut_t.device_table(st, "cpu")
        assert dev.dtype == torch.int16 and dev is lut_t.device_table(
            st.replace(n_bits=m), "cpu")
        np.testing.assert_array_equal(dev.numpy().view(np.uint16), want)


@pytest.mark.parametrize("kind", KINDS)
def test_lut_add_exhaustive_n8(kind):
    """Every 8-bit pair, every valid (m, k): the port's lut add equals the
    reference's numpy lut add (exact kinds take the plain add)."""
    a, b = np.meshgrid(np.arange(256, dtype=np.uint64),
                       np.arange(256, dtype=np.uint64), indexing="ij")
    at = torch.as_tensor(a.astype(np.int32))
    bt = torch.as_tensor(b.astype(np.int32))
    for m, k in _valid_mk(kind, 8):
        sj = specs_j.AdderSpec(kind, 8, m, k)
        st = specs_t.AdderSpec(kind, 8, m, k)
        want = make_engine_j(sj, backend="numpy", strategy="lut").add(a, b)
        eng = make_engine_t(st, strategy="lut", **CPU)
        assert eng.strategy == "lut"
        got = eng.add(at, bt)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int32),
                                      err_msg=st.short_name)


@pytest.mark.parametrize("kind", KINDS)
def test_lut_add_sampled_n16_n32(kind):
    rng = np.random.default_rng(len(kind) + 3)
    for n_bits, m, k in ((16, 8, 4), (32, 10, 5)):
        sj = specs_j.AdderSpec(kind, n_bits, m, k)
        st = specs_t.AdderSpec(kind, n_bits, m, k)
        a, b = (_containers(rng, (257, 33), n_bits) for _ in range(2))
        au = a.view(np.uint32).astype(np.uint64)
        bu = b.view(np.uint32).astype(np.uint64)
        want = make_engine_j(sj, backend="numpy", strategy="lut").add(au, bu)
        got = make_engine_t(st, strategy="lut", **CPU).add(a, b)
        np.testing.assert_array_equal(
            got.numpy(), want.astype(np.uint32).view(np.int32),
            err_msg=st.short_name)
        # the wrapper on CPU tensors is the plain version
        if kind != "accurate":
            np.testing.assert_array_equal(
                lut_k.lut_add(torch.as_tensor(a), torch.as_tensor(b),
                              st).numpy(), got.numpy())


@pytest.mark.parametrize("kind", ["haloc_axa", "loa", "eta", "accurate"])
def test_lut_accumulate_and_chain_match_jax(kind):
    rng = np.random.default_rng(11)
    sj, st = (mod.AdderSpec(kind, 16, 8, 4) for mod in (specs_j, specs_t))
    terms = _containers(rng, (3, 5, 37), 16)
    ws = (1, -2, 3)
    want = be_j.get_backend("jax").accumulate(
        jnp.asarray(terms), sj, weights=ws, strategy="lut")
    got = be_t.get_backend("torch").accumulate(
        torch.as_tensor(terms), st, weights=ws, strategy="lut")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q = rng.integers(-1500, 1500, (2, 19, 23)).astype(np.int32)
    stages = ((-1, (-1, 0, 1), (1, 2, 1), 2), (-2, (1, -1), (1, -1), 0))
    want = be_j.get_backend("jax").filter_chain(
        jnp.asarray(q), sj, tuple(be_j.FilterStage(*s) for s in stages),
        strategy="lut")
    got = be_t.get_backend("torch").filter_chain(
        torch.as_tensor(q), st, tuple(be_t.FilterStage(*s) for s in stages),
        strategy="lut")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("requant", ["stage", "fused"])
@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_lut_pipelines_match_jax(pipeline, requant):
    batch = synthetic_batch(2, 32)
    stages = PIPELINES[pipeline]
    for kind in ("haloc_axa", "loawa", "accurate"):
        want = run_pipeline_j(stages, batch, kind=kind, backend="jax",
                              strategy="lut", requant=requant)
        got = run_pipeline(stages, batch, kind=kind, strategy="lut",
                           requant=requant, **CPU)
        np.testing.assert_array_equal(got, want, err_msg=kind)


def test_lut_unsupported_configurations_match_reference():
    for mod, lut in ((specs_j, lut_j), (specs_t, lut_t)):
        wide = mod.AdderSpec(kind="loa", n_bits=32,
                             lsm_bits=lut.MAX_LUT_LSM_BITS + 1)
        assert not lut.lut_supported(wide)
        with pytest.raises(ValueError, match="lsm_bits"):
            lut.compile_lut(wide)
        acc = mod.AdderSpec(kind="accurate", n_bits=16)
        assert lut.lut_supported(acc)
        with pytest.raises(ValueError, match="exact"):
            lut.compile_lut(acc)
    assert lut_t.MAX_LUT_LSM_BITS == lut_j.MAX_LUT_LSM_BITS
    wide_t = specs_t.AdderSpec(kind="loa", n_bits=32, lsm_bits=13)
    with pytest.raises(ValueError, match="LUT"):
        make_engine_j(specs_j.AdderSpec(kind="loa", n_bits=32, lsm_bits=13),
                      strategy="lut")
    with pytest.raises(ValueError, match="LUT"):
        make_engine_t(wide_t, strategy="lut", **CPU)
    # exact kinds need no table: the strategy degrades to the plain add
    eng = make_engine_t(specs_t.AdderSpec(kind="accurate", n_bits=16),
                        strategy="lut", **CPU)
    a = torch.tensor([40_000, 65_535], dtype=torch.int32)
    assert eng.add(a, a).tolist() == [(80_000) & 0xFFFF, 65_534]
    # the cuda backend runs exact kinds' lut accumulation as the plain
    # form (no table); it still takes CUDA tensors only
    with pytest.raises(ValueError, match="CUDA tensors"):
        be_t.get_backend("cuda").accumulate(
            torch.zeros((2, 3), dtype=torch.int32), eng.spec,
            strategy="lut")
