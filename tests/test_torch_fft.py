"""The port's Fig-5 reconstruction against the reference's, bit for bit:
the butterfly stage (``kernels/butterfly`` plain version and
``AxEngine.butterfly``), the fixed-point FFT (``image/fft``), the
reconstruction (``image/pipeline``), and the ``fft_reconstruct``
workload in ``run_corpus(include_fft=True)``.

The butterfly follows ``butterfly_pallas`` (run here in interpret mode,
as ``tests/test_ax.py`` runs it) and the reference's ``"jax"`` backend at
every N; at N=32 it also equals ``ref_butterfly``.  Inputs are made with
numpy from a seed and given to both packages; tolerance is zero
differing elements, and PSNR/SSIM are compared as equal floats.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.ax import make_engine as make_engine_j
from repro.core import specs as specs_j
from repro.image import fft as fft_j
from repro.image import pipeline as pipe_j
from repro.imgproc import get_workload as get_workload_j
from repro.imgproc import run_corpus as run_corpus_j
from repro.imgproc import workload_names as workload_names_j
from repro.kernels.ref import ref_butterfly
from repro_torch.ax import get_backend
from repro_torch.ax import make_engine as make_engine_t
from repro_torch.core import specs as specs_t
from repro_torch.image import fft as fft_t
from repro_torch.image import pipeline as pipe_t
from repro_torch.imgproc import get_workload, run_corpus, workload_names
from repro_torch.kernels import butterfly as bf_k

CPU = dict(backend="torch", device="cpu")
TABLE1 = specs_j.TABLE1_KINDS


def _specs(kind, n_bits=32):
    m, k = (10, 5) if n_bits == 32 else (8, 4)
    return (specs_j.paper_spec(kind, n_bits, m, k),
            specs_t.paper_spec(kind, n_bits, m, k))


def _stage_inputs(rng, rows, half, lim=None, inverse=False):
    """Four int32 planes (the full int32 range unless ``lim``) and the
    stage's Q1.14 twiddles, as the FFT computes them."""
    if lim is None:
        planes = [rng.integers(-(1 << 31), 1 << 31, (rows, half))
                  .astype(np.int32) for _ in range(4)]
    else:
        planes = [rng.integers(-lim, lim, (rows, half)).astype(np.int32)
                  for _ in range(4)]
    ang = (1.0 if inverse else -1.0) * 2.0 * np.pi * np.arange(half) / (
        2 * half)
    w_re = np.round(np.cos(ang) * (1 << 14)).astype(np.int32)
    w_im = np.round(np.sin(ang) * (1 << 14)).astype(np.int32)
    return planes, w_re, w_im


def _plain(planes, w_re, w_im, spec, inverse, fast=False):
    return bf_k.butterfly_plain(*(torch.as_tensor(p) for p in planes),
                                torch.as_tensor(w_re), torch.as_tensor(w_im),
                                spec, inverse=inverse, fast=fast)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n_bits", [32, 16])
@pytest.mark.parametrize("kind", ["haloc_axa", "loa"])
def test_butterfly_plain_matches_pallas(kind, n_bits, inverse):
    """Full-range int32 planes at the paper spec and at n16m8k4: the
    plain version equals butterfly_pallas (interpret) and the jax backend,
    including N < 32, where both return unsigned N-bit residues."""
    rng = np.random.default_rng(n_bits + inverse)
    sj, st = _specs(kind, n_bits)
    planes, w_re, w_im = _stage_inputs(rng, 64, 8, inverse=inverse)
    got = _plain(planes, w_re, w_im, st, inverse)
    for backend in ("pallas", "jax"):
        want = make_engine_j(sj, backend=backend).butterfly(
            *(jnp.asarray(p) for p in planes), jnp.asarray(w_re),
            jnp.asarray(w_im), inverse=inverse)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=backend)
    if n_bits < 32:
        assert all(int(g.min()) >= 0 and int(g.max()) < 1 << 16
                   for g in got)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", TABLE1 + ("eta",))
def test_butterfly_every_kind_matches_jax_and_ref(kind, inverse):
    """Every kind, both adder forms: full-range planes against the jax
    backend, and the FFT's +-2^24 range against ``ref_butterfly`` (which
    agrees with the kernel at N=32)."""
    rng = np.random.default_rng(len(kind) + 7 * inverse)
    sj, st = _specs(kind)
    planes, w_re, w_im = _stage_inputs(rng, 37, 16, inverse=inverse)
    want = make_engine_j(sj, backend="jax").butterfly(
        *(jnp.asarray(p) for p in planes), jnp.asarray(w_re),
        jnp.asarray(w_im), inverse=inverse)
    for fast in (False, True):
        got = _plain(planes, w_re, w_im, st, inverse, fast)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    planes, w_re, w_im = _stage_inputs(rng, 37, 16, lim=1 << 24,
                                       inverse=inverse)
    want = ref_butterfly(*planes, w_re, w_im, sj, inverse=inverse)
    got = make_engine_t(st, **CPU).butterfly(*planes, w_re, w_im,
                                             inverse=inverse)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_butterfly_halving_wraps_in_32_bits():
    """An inverse output of 0x7FFFFFFF halves with the +1 wrapping in
    int32 lanes, as butterfly_pallas and the jax backend do (the int64
    ``ref_butterfly`` gives +2^30 there)."""
    sj, st = _specs("accurate")
    a = np.array([[0x7FFFFFFF, -5, 7]], np.int32)
    zero = np.zeros_like(a)
    w_re = np.full(3, 1 << 14, np.int32)
    w_im = np.zeros(3, np.int32)
    planes = (a, zero, zero, zero)
    got = _plain(planes, w_re, w_im, st, True)
    want = make_engine_j(sj, backend="jax").butterfly(
        *(jnp.asarray(p) for p in planes), jnp.asarray(w_re),
        jnp.asarray(w_im), inverse=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].tolist() == [[-(1 << 30), -2, 4]]


def test_butterfly_routes_and_rules():
    _, st = _specs("haloc_axa")
    rng = np.random.default_rng(3)
    planes, w_re, w_im = _stage_inputs(rng, 5, 4)
    x = torch.as_tensor(np.concatenate(planes[:2], axis=1))
    # strided (rows, half) views, as the FFT hands them over
    views = (x[:, :4], x[:, 4:], torch.as_tensor(planes[2]),
             torch.as_tensor(planes[3]))
    want = _plain([v.contiguous().numpy() for v in views], w_re, w_im, st,
                  False)
    got = bf_k.butterfly(*views, torch.as_tensor(w_re),
                         torch.as_tensor(w_im), st)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        get_backend("cuda").butterfly(*views, torch.as_tensor(w_re),
                                      torch.as_tensor(w_im), st)


@pytest.mark.parametrize("kind", ["haloc_axa", "loawa", "accurate"])
def test_fft_fixed_matches_reference_n32(kind):
    rng = np.random.default_rng(2)
    sj, st = _specs(kind)
    cj = fft_j.FixedFFTConfig(spec=sj, frac_bits=6)
    ct = fft_t.FixedFFTConfig(spec=st, frac_bits=6, **CPU)

    def check(got, want):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(
                g.numpy().view(np.uint32).astype(np.uint64), w)

    x = rng.uniform(-255, 255, (4, 32))
    y = rng.uniform(-255, 255, (4, 32))
    re_j, im_j = fft_j.to_fixed(x, cj), fft_j.to_fixed(y, cj)
    re_t, im_t = fft_t.to_fixed(x, ct), fft_t.to_fixed(y, ct)
    check((re_t, im_t), (re_j, im_j))
    for inverse in (False, True):
        check(fft_t.fft_fixed(re_t, im_t, ct, inverse=inverse),
              fft_j.fft_fixed(re_j, im_j, cj, inverse=inverse))
    img = rng.uniform(0, 255, (2, 16, 16))
    re_j, im_j = fft_j.to_fixed(img, cj), fft_j.to_fixed(0 * img, cj)
    re_t, im_t = fft_t.to_fixed(img, ct), fft_t.to_fixed(0 * img, ct)
    f_j, f_t = fft_j.fft2_fixed(re_j, im_j, cj), fft_t.fft2_fixed(re_t, im_t,
                                                                  ct)
    check(f_t, f_j)
    b_j, b_t = fft_j.ifft2_fixed(*f_j, cj), fft_t.ifft2_fixed(*f_t, ct)
    check(b_t, b_j)
    np.testing.assert_array_equal(fft_t.from_fixed(b_t[0], ct).numpy(),
                                  fft_j.from_fixed(b_j[0], cj))


@pytest.mark.parametrize("kind", ["haloc_axa", "loa", "accurate"])
def test_fft_below_32_bits_takes_the_reference_route(kind):
    """At n16m8k4 each stage is the reference's exact products plus six
    engine adds (the butterfly's unsigned residues would differ)."""
    rng = np.random.default_rng(4)
    sj, st = _specs(kind, 16)
    cj = fft_j.FixedFFTConfig(spec=sj, frac_bits=2)
    ct = fft_t.FixedFFTConfig(spec=st, frac_bits=2, **CPU)
    x = rng.uniform(-6, 6, (3, 16))
    y = rng.uniform(-6, 6, (3, 16))
    re_j, im_j = fft_j.to_fixed(x, cj), fft_j.to_fixed(y, cj)
    re_t, im_t = fft_t.to_fixed(x, ct), fft_t.to_fixed(y, ct)
    for inverse in (False, True):
        got = fft_t.fft_fixed(re_t, im_t, ct, inverse=inverse)
        want = fft_j.fft_fixed(re_j, im_j, cj, inverse=inverse)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().astype(np.uint64), w)
    np.testing.assert_array_equal(fft_t.from_fixed(re_t, ct).numpy(),
                                  fft_j.from_fixed(re_j, cj))


def test_to_fixed_rounds_half_to_even_like_reference():
    for n_bits, frac in ((32, 6), (16, 3)):
        sj = specs_j.AdderSpec("accurate", n_bits)
        st = specs_t.AdderSpec("accurate", n_bits)
        cj = fft_j.FixedFFTConfig(spec=sj, frac_bits=frac)
        ct = fft_t.FixedFFTConfig(spec=st, frac_bits=frac, **CPU)
        x = (np.arange(-20, 20) + 0.5) / (1 << frac)
        np.testing.assert_array_equal(
            fft_t.to_fixed(x, ct).numpy().view(np.uint32)
            .astype(np.uint64), fft_j.to_fixed(x, cj))


@pytest.mark.parametrize("kind", TABLE1)
def test_reconstruct_matches_reference(kind):
    img = pipe_j.synthetic_image(64)
    np.testing.assert_array_equal(pipe_t.synthetic_image(64), img)
    sj, st = _specs(kind)
    for block in (8, 16, 0):
        want = pipe_j.reconstruct(img, sj, block=block, backend="numpy")
        got = pipe_t.reconstruct(img, st, block=block, **CPU)
        assert got.dtype == torch.uint8 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{kind} block={block}")


def test_evaluate_and_paper_ordering_match_reference():
    """Fig 5/6 on the port: the same PSNR/SSIM as the reference and the
    quality ordering ``tests/test_image.py`` asserts."""
    img = pipe_j.synthetic_image(128)
    kinds = ("loa", "oloca", "herloa", "m_herloa", "haloc_axa", "loawa")
    got = pipe_t.evaluate(img, [specs_t.paper_spec(k) for k in kinds],
                          **CPU)
    want = pipe_j.evaluate(img, [specs_j.paper_spec(k) for k in kinds])
    assert got == want
    s = {k: got[k]["ssim"] for k in kinds}
    assert s["herloa"] > s["haloc_axa"] > s["loa"]
    assert s["m_herloa"] > s["haloc_axa"]
    assert s["loa"] > s["loawa"]
    assert abs(s["loa"] - s["oloca"]) < 0.08
    assert s["haloc_axa"] > 0.7


def test_fft_workload_and_corpus_match_reference():
    batch = np.stack([pipe_j.synthetic_image(64, seed=s) for s in (1, 2)])
    assert "fft_reconstruct" in workload_names()
    assert "fft_reconstruct" not in workload_names(batched_only=True)
    assert not get_workload("fft_reconstruct").batched
    for kind in TABLE1:
        want = get_workload_j("fft_reconstruct").run(batch, kind=kind,
                                                     backend="numpy")
        got = get_workload("fft_reconstruct").run(batch, kind=kind, **CPU)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=kind)
    kinds = ("accurate", "haloc_axa", "loawa")
    # with include_fft=True, every workload the reference registers
    assert workload_names() == workload_names_j()
    want = run_corpus_j(kinds=kinds, workloads=workload_names_j(),
                        batch=batch, backend="jax")
    got = run_corpus(kinds=kinds, batch=batch, include_fft=True, **CPU)
    assert [(r.kind, r.workload) for r in got] == \
        [(r.kind, r.workload) for r in want]
    assert sum(r.workload == "fft_reconstruct" for r in got) == len(kinds)
    for g, w in zip(got, want):
        assert (g.psnr, g.ssim, g.band) == (w.psnr, w.ssim, w.band), \
            (g.kind, g.workload)
    assert all(r.workload != "fft_reconstruct"
               for r in run_corpus(kinds=("accurate",), batch=batch[:1],
                                   **CPU))


def test_default_reconstruct_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = pipe_t.synthetic_image(16)
    with pytest.raises(RuntimeError, match="backend='torch', device='cpu'"):
        pipe_t.reconstruct(img, specs_t.paper_spec("haloc_axa"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_workload("fft_reconstruct").run(img[None])
    with pytest.raises(ValueError, match="exceeds 32"):
        fft_t.FixedFFTConfig(spec=specs_t.AdderSpec("accurate", 40))
