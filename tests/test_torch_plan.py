"""The port's pipelines, tiles and corpus against the reference's, bit
for bit: both stock pipelines x both requant modes x every Table-1 kind,
tiled equals untiled, and ``run_corpus`` rows equal to
``repro.imgproc.run_corpus(backend="jax")`` on the workloads both
packages have (PSNR/SSIM to 1e-9: the same numpy scoring of identical
uint8 images)."""

import numpy as np
import pytest

from repro.core.specs import TABLE1_KINDS
from repro.imgproc import fused_psnr_gate as fused_psnr_gate_j
from repro.imgproc import run_corpus as run_corpus_j
from repro.imgproc import run_pipeline as run_pipeline_j
from repro.imgproc import workload_names as workload_names_j
from repro_torch.imgproc import (PIPELINES, compile_pipeline, compile_tiled,
                                 format_table, fused_psnr_gate, run_corpus,
                                 run_pipeline, run_tiled, synthetic_batch,
                                 workload_names)

BATCH = synthetic_batch(4, 64)
CPU = dict(backend="torch", device="cpu")


@pytest.mark.parametrize("requant", ["stage", "fused"])
@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_pipelines_match_reference(pipeline, requant):
    stages = PIPELINES[pipeline]
    for kind in TABLE1_KINDS:
        want = run_pipeline_j(stages, BATCH, kind=kind, backend="jax",
                              requant=requant)
        got = run_pipeline(stages, BATCH, kind=kind, requant=requant, **CPU)
        np.testing.assert_array_equal(got, want, err_msg=kind)


def test_fused_requant_equals_stage_and_gate_matches_reference():
    for name, stages in PIPELINES.items():
        a = run_pipeline(stages, BATCH, requant="stage", **CPU)
        b = run_pipeline(stages, BATCH, requant="fused", **CPU)
        np.testing.assert_array_equal(a, b, err_msg=name)
    chain = ("box_blur", "downsample2x")
    want = fused_psnr_gate_j(chain, BATCH[:2], kind="loa", backend="numpy")
    got = fused_psnr_gate(chain, BATCH[:2], kind="loa", **CPU)
    assert abs(got.psnr_stage - want.psnr_stage) < 1e-9
    assert abs(got.psnr_fused - want.psnr_fused) < 1e-9
    assert got.bit_identical == want.bit_identical
    assert got.admissible()


def test_compile_pipeline_caches_and_validates():
    a = compile_pipeline(PIPELINES["pipe_blur_sobel"], **CPU)
    assert compile_pipeline(PIPELINES["pipe_blur_sobel"], **CPU) is a
    assert a.receptive_halo == 2 and a.total_down == 1
    with pytest.raises(ValueError, match="requant"):
        compile_pipeline(("gaussian_blur",), requant="late", **CPU)
    with pytest.raises(ValueError, match="unary"):
        compile_pipeline(("add",), **CPU)
    with pytest.raises(ValueError, match="empty"):
        compile_pipeline((), **CPU)


@pytest.mark.parametrize("requant", ["stage", "fused"])
@pytest.mark.parametrize("chain,hw,tile", [
    (("gaussian_blur", "sharpen", "downsample2x"), (64, 64), (16, 16)),
    (("gaussian_blur", "sharpen", "downsample2x"), (46, 38), (9, 13)),
    (("gaussian_blur", "sobel"), (37, 29), (7, 11)),
    (("box_blur", "brightness", "sobel"), (33, 40), (8, 5)),
    (("downsample2x", "gaussian_blur", "downsample2x"), (48, 40), (12, 20)),
])
def test_tiled_equals_untiled(chain, hw, tile, requant):
    imgs = synthetic_batch(2, 64)[:, :hw[0], :hw[1]]
    pipe = compile_pipeline(chain, kind="haloc_axa", requant=requant, **CPU)
    untiled = pipe(imgs).numpy()
    np.testing.assert_array_equal(run_tiled(pipe, imgs, tile=tile), untiled)
    wider = compile_tiled(pipe, imgs.shape, tile,
                          halo=pipe.receptive_halo + 3)
    np.testing.assert_array_equal(wider(imgs).numpy(), untiled)
    want = run_pipeline_j(chain, imgs, kind="haloc_axa", backend="numpy",
                          requant=requant)
    np.testing.assert_array_equal(untiled, want)


def test_tiled_validation():
    pipe = compile_pipeline(("gaussian_blur", "downsample2x"), **CPU)
    with pytest.raises(ValueError, match="divisible"):
        run_tiled(pipe, BATCH[:, :63, :64], tile=(16, 16))
    with pytest.raises(ValueError, match="narrower"):
        compile_tiled(pipe, BATCH.shape, (16, 16), halo=0)
    fn = compile_tiled(pipe, BATCH.shape, (16, 16))
    with pytest.raises(ValueError, match="compiled for shape"):
        fn(BATCH[:2])


def test_corpus_rows_match_reference():
    kinds = ("accurate", "haloc_axa", "loawa")
    names = workload_names(batched_only=True)
    # 8 operators, 2 stock pipelines and the conv3x3 MAC workload: the
    # reference's batched sweep.
    assert len(names) == 11 and "conv3x3" in names
    assert names == workload_names_j(batched_only=True)
    want = run_corpus_j(kinds=kinds, workloads=names, batch=BATCH,
                        backend="jax")
    got = run_corpus(kinds=kinds, workloads=names, batch=BATCH, **CPU)
    assert [(r.kind, r.workload) for r in got] == \
        [(r.kind, r.workload) for r in want]
    for g, w in zip(got, want):
        assert g.band == w.band, (g.kind, g.workload)
        if np.isinf(w.psnr):
            assert np.isinf(g.psnr)
        else:
            assert abs(g.psnr - w.psnr) <= 1e-9, (g.kind, g.workload)
        assert abs(g.ssim - w.ssim) <= 1e-9, (g.kind, g.workload)
        assert g.mpix_per_s > 0
    table = format_table(got)
    assert "haloc_axa" in table and "pipe_blur_sobel" in table
    fused = run_corpus(kinds=("haloc_axa",), workloads=["pipe_blur_sobel"],
                       batch=BATCH, workload_kw={
                           "pipe_blur_sobel": {"requant": "fused"}}, **CPU)
    assert fused[0].psnr == [r for r in got if r.kind == "haloc_axa" and
                             r.workload == "pipe_blur_sobel"][0].psnr
    with pytest.raises(ValueError, match="not in this sweep"):
        run_corpus(kinds=("accurate",), workloads=["add"], batch=BATCH,
                   workload_kw={"blend": {}}, **CPU)
