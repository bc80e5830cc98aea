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


# ------------------------------------------- the one-launch FFT axis route --
#
# At N = 32 an axis of transforms runs ``kernels.butterfly.fft_axis``: on
# the CPU its plain version (bit reversal, then ``butterfly_plain`` stage
# by stage), on the card one kernel launch that reads the transforms where
# they lie.  The kernel runs only on the card (``tests/test_torch_cuda.py``
# and ``chip_smoke.py``); here a model of its addressing is held against
# the reshape/transpose path the FFT took before.


def _containers(rng, shape):
    """Full-range 32-bit container patterns: uint64 for the reference,
    int32 for the port."""
    u = rng.integers(0, 1 << 32, shape, dtype=np.uint64)
    return u, torch.as_tensor(u.astype(np.uint32).view(np.int32))


def _as_u64(t):
    return t.numpy().view(np.uint32).astype(np.uint64)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", specs_j.ALL_KINDS)
def test_axis_route_matches_jax_fft(kind, inverse):
    """The axis route's plain version, both forms, against the reference's
    ``fft_fixed`` on the jax backend at N = 32, n = 2 ... 64, full-range
    containers; ``fft_fixed`` on the port's torch backend takes it."""
    sj, st = _specs(kind)
    cj = fft_j.FixedFFTConfig(spec=sj, frac_bits=6, backend="jax")
    ct = fft_t.FixedFFTConfig(spec=st, frac_bits=6, **CPU)
    rng = np.random.default_rng(50 + inverse)
    for n in (2, 4, 8, 16, 32, 64):
        assert fft_t.fft_route(n, 32) == "axis"
        (re_j, re_t), (im_j, im_t) = (_containers(rng, (3, n))
                                      for _ in range(2))
        want = fft_j.fft_fixed(re_j, im_j, cj, inverse=inverse)
        layout = bf_k.last_axis_layout((3, n))
        for fast in (False, True):
            got = bf_k.fft_axis_plain(re_t, im_t, layout, st,
                                      inverse=inverse, fast=fast)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_as_u64(g), w, err_msg=str(n))
        for g, w in zip(fft_t.fft_fixed(re_t, im_t, ct, inverse=inverse),
                        want):
            np.testing.assert_array_equal(_as_u64(g), w, err_msg=str(n))


@pytest.mark.parametrize("kind", ["haloc_axa", "herloa", "eta", "accurate"])
def test_axis_route_fft2_and_reconstruct_match_jax(kind):
    """fft2/ifft2 (rows, then columns in place), and reconstruct on a
    48 x 64 image in 16 x 16 tiles read where they lie (three tiles down:
    a tile count that is not a power of two) and on a whole 32 x 64 one,
    against the reference's jax backend."""
    sj, st = _specs(kind)
    cj = fft_j.FixedFFTConfig(spec=sj, frac_bits=6, backend="jax")
    ct = fft_t.FixedFFTConfig(spec=st, frac_bits=6, **CPU)
    rng = np.random.default_rng(52)
    (re_j, re_t), (im_j, im_t) = (_containers(rng, (2, 16, 32))
                                  for _ in range(2))
    for fn in ("fft2_fixed", "ifft2_fixed"):
        want = getattr(fft_j, fn)(re_j, im_j, cj)
        got = getattr(fft_t, fn)(re_t, im_t, ct)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_as_u64(g), w, err_msg=fn)
    img = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    for block in (16, 0):
        if not block:
            img = img[:32]
        want = pipe_j.reconstruct(img, sj, block=block, backend="jax")
        got = pipe_t.reconstruct(img, st, block=block, **CPU)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(block))


def _bit_reverse(e, bits):
    r = torch.zeros_like(e)
    for b in range(bits):
        r |= ((e >> b) & 1) << (bits - 1 - b)
    return r


def _axis_kernel_model(re, im, layout, spec, inverse, fast):
    """``butterfly_axis_launch`` in Python: the grid of axis_plan, each
    thread slot's (t, e) and tensor offset (the multiply-high split of g
    into (outer, inner)), the bit-reversed load into the block's shared
    slots, each stage's pair q joining slots top = ((q >> s) << (s + 1)) |
    (q & (h - 1)) and top + h with twiddle h - 1 + j of the one table, and
    the natural-order store.  Returns the outputs and how often each
    element was stored."""
    plan = bf_k.axis_plan(layout)
    n, log_n, log_t = layout.n, plan.log_n, plan.log_per_block
    elems = n << log_t
    magic, shift = bf_k.divider(layout.n_inner)
    tw_re, tw_im = bf_k.axis_twiddles(n, inverse, torch.device("cpu"))
    flat = (re.reshape(-1), im.reshape(-1))
    out = (torch.zeros_like(flat[0]), torch.zeros_like(flat[1]))
    stored = torch.zeros(flat[0].numel(), dtype=torch.int64)
    idx = torch.arange(elems, dtype=torch.int64)
    if plan.t_fast:
        t, e = idx & ((1 << log_t) - 1), idx >> log_t
    else:
        t, e = idx >> log_n, idx & (n - 1)
    for block in range(plan.blocks):
        g = (block << log_t) + t
        ok = g < layout.transforms
        o = (((g * magic) >> 32) + g) >> shift
        i = g - o * layout.n_inner
        at = (o * layout.s_outer + i * layout.s_inner
              + e * layout.s_elem)[ok]
        slots = [torch.zeros(elems, dtype=torch.int32) for _ in range(2)]
        load = ((t << log_n) | _bit_reverse(e, log_n))[ok]
        for s_, f in zip(slots, flat):
            s_[load] = f[at]
        for s in range(log_n):
            h = 1 << s
            q = torch.arange(elems // 2)
            j = q & (h - 1)
            top = ((q >> s) << (s + 1)) | j
            bot = top + h
            res = bf_k.butterfly_plain(
                slots[0][top][None], slots[1][top][None],
                slots[0][bot][None], slots[1][bot][None],
                tw_re[h - 1 + j], tw_im[h - 1 + j], spec, inverse=inverse,
                fast=fast)
            slots[0][top], slots[1][top] = res[0][0], res[1][0]
            slots[0][bot], slots[1][bot] = res[2][0], res[3][0]
        store = ((t << log_n) | e)[ok]
        for o_, s_ in zip(out, slots):
            o_[at] = s_[store]
        stored[at] += 1
    return (out[0].reshape(re.shape), out[1].reshape(im.shape)), stored


def _transpose_path(re, im, spec, inverse, block):
    """The FFT's path before the axis kernel: (..., H, W) cut into block
    tiles by reshape and transpose, rows then transposed columns, each a
    per-stage ``butterfly_plain`` after a bit-reversal gather."""
    *lead, h, w = re.shape
    bh, bw = (block, block) if block else (h, w)

    def stage(*planes):
        return bf_k.butterfly_plain(*planes, spec, inverse=inverse)

    def tiles(x):
        return (x.reshape(-1, h // bh, bh, w // bw, bw).transpose(2, 3)
                .reshape(-1, bh, bw))

    def untile(x):
        return (x.reshape(-1, h // bh, w // bw, bh, bw).transpose(2, 3)
                .reshape(re.shape))

    x = [tiles(v) for v in (re, im)]
    x = [v.reshape(-1, bw) for v in bf_k.fft_stages(
        *(v.reshape(-1, bw) for v in x), inverse, stage)]
    x = [v.reshape(-1, bh, bw).transpose(-1, -2).reshape(-1, bh) for v in x]
    x = bf_k.fft_stages(*x, inverse, stage)
    return tuple(untile(v.reshape(-1, bw, bh).transpose(-1, -2)) for v in x)


@pytest.mark.parametrize("block", [16, 8, None])
@pytest.mark.parametrize("inverse", [False, True])
def test_axis_kernel_model_equals_the_transpose_path(block, inverse):
    """The model of the kernel's addressing, on the rows and then the
    columns (in place) of (2, 48, 64) planes, whole or in tiles read where
    they lie, equals the reshape/transpose path bit for bit; every element
    is stored exactly once per axis."""
    from repro_torch.image.fft import image_layouts
    st = specs_t.paper_spec("haloc_axa")
    rng = np.random.default_rng(53)
    shape = (2, 48, 64) if block else (2, 32, 64)
    re, im = (torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, shape)
                              .astype(np.int32)) for _ in range(2))
    rows, cols = image_layouts(shape, block)
    assert not bf_k.axis_plan(rows).t_fast and bf_k.axis_plan(cols).t_fast
    (y_re, y_im), stored = _axis_kernel_model(re, im, rows, st, inverse,
                                              fast=True)
    assert bool((stored == 1).all())
    (y_re, y_im), stored = _axis_kernel_model(y_re, y_im, cols, st, inverse,
                                              fast=False)
    assert bool((stored == 1).all())
    want = _transpose_path(re, im, st, inverse, block)
    assert torch.equal(y_re, want[0]) and torch.equal(y_im, want[1])
    got = fft_t.transform2d(re, im, fft_t.FixedFFTConfig(spec=st, **CPU),
                            inverse=inverse, block=block)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [2, 4, 16, 512, 4096])
def test_axis_kernel_model_on_the_last_axis(n):
    """The model on the last axis at n = 2 ... 4096 (one transform a block
    at 4096, 512 at n = 2), a ragged last block, against the plain
    version."""
    st = specs_t.paper_spec("loa")
    rng = np.random.default_rng(54)
    rows = max(3, 4100 // n)
    re, im = (torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, (rows, n))
                              .astype(np.int32)) for _ in range(2))
    layout = bf_k.last_axis_layout((rows, n))
    for inverse in (False, True):
        (y_re, y_im), stored = _axis_kernel_model(re, im, layout, st,
                                                  inverse, fast=False)
        assert bool((stored == 1).all())
        want = bf_k.fft_axis_plain(re, im, layout, st, inverse=inverse)
        assert torch.equal(y_re, want[0]) and torch.equal(y_im, want[1])


def test_divider_splits_every_index():
    """The kernel's multiply-high division equals // for every divisor it
    meets (1 ... 70, powers of two, odd and large ones) on seeded and
    corner numerators below 2^31."""
    rng = np.random.default_rng(55)
    g = np.concatenate([rng.integers(0, 2 ** 31, 20000, dtype=np.uint64),
                        np.array([0, 1, 2 ** 31 - 1, 2 ** 31 - 2],
                                 dtype=np.uint64)])
    for d in list(range(1, 71)) + [96, 127, 1000, 4096, 65535, 2 ** 20 + 3,
                                   2 ** 30, 2 ** 31 - 1]:
        magic, shift = bf_k.divider(d)
        assert 0 < magic < 2 ** 32 and 0 <= shift <= 31
        q = (((g * np.uint64(magic)) >> np.uint64(32)) + g) >> np.uint64(
            shift)
        np.testing.assert_array_equal(q, g // np.uint64(d), err_msg=str(d))


def test_fft_routes_and_plans():
    """fft_route: the six-add route below N = 32, the axis kernel up to
    the 4096 one block holds, the per-stage kernel past it; axis_plan:
    about 1024 elements a block, at least 8 neighbouring columns a block
    on the column axis, 32 KB of shared memory at most."""
    assert [fft_t.fft_route(n, 32) for n in (2, 16, 4096, 8192, 1 << 16)] \
        == ["axis"] * 3 + ["stages"] * 2
    assert {fft_t.fft_route(n, nb) for n in (2, 16, 8192)
            for nb in (8, 16, 31)} == {"adds"}
    from repro_torch.image.fft import image_layouts
    rows, cols = image_layouts((4, 512, 512), 16)
    assert rows == bf_k.AxisLayout(16, 4 * 512 * 32, 1, 16, 0, 1)
    assert cols == bf_k.AxisLayout(16, 4 * 32, 512, 16 * 512, 1, 512)
    assert bf_k.axis_plan(rows) == bf_k.AxisPlan(4, 6, False, 1024)
    assert bf_k.axis_plan(cols) == bf_k.AxisPlan(4, 6, True, 1024)
    rows, cols = image_layouts((512, 512))
    assert bf_k.axis_plan(rows) == bf_k.AxisPlan(9, 1, False, 256)
    assert bf_k.axis_plan(cols) == bf_k.AxisPlan(9, 3, True, 64)
    for n in (2, 64, 1024, 4096):
        for layout in (bf_k.last_axis_layout((5, n)),
                       image_layouts((n, 64))[1]):
            plan = bf_k.axis_plan(layout)
            elems = n << plan.log_per_block
            assert elems <= bf_k.AXIS_MAX_ELEMS and 8 * elems <= 32 * 1024
    with pytest.raises(ValueError, match="do not cover"):
        image_layouts((48, 40), 16)
    with pytest.raises(ValueError, match="power of two"):
        bf_k.check_layout(bf_k.AxisLayout(8192, 1, 1, 8192, 0, 1), 8192)
    with pytest.raises(ValueError, match="reaches element"):
        bf_k.check_layout(bf_k.AxisLayout(16, 3, 1, 16, 0, 1), 47)


def test_fft_takes_each_route(monkeypatch):
    """On the torch backend as on the card: N = 32 up to 4096 goes through
    Backend.fft_axis, past it through one engine.butterfly per stage, and
    N < 32 through neither; each equals the reference."""
    from repro_torch.ax.backends import TorchBackend
    from repro_torch.ax.engine import AxEngine
    calls = {"fft_axis": 0, "butterfly": 0}
    for name, cls in (("fft_axis", TorchBackend), ("butterfly", AxEngine)):
        orig = getattr(cls, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(cls, name, counted)
    rng = np.random.default_rng(56)
    for n_bits, n, expect in ((32, 64, (1, 0)), (32, 8192, (0, 13)),
                              (16, 64, (0, 0))):
        sj, st = _specs("haloc_axa", n_bits)
        cj = fft_j.FixedFFTConfig(spec=sj, frac_bits=2, backend="jax")
        ct = fft_t.FixedFFTConfig(spec=st, frac_bits=2, **CPU)
        x = rng.uniform(-30, 30, (2, n))
        calls.update(fft_axis=0, butterfly=0)
        got = fft_t.fft_fixed(fft_t.to_fixed(x, ct), fft_t.to_fixed(-x, ct),
                              ct)
        assert (calls["fft_axis"], calls["butterfly"]) == expect, n
        want = fft_j.fft_fixed(fft_j.to_fixed(x, cj), fft_j.to_fixed(-x, cj),
                               cj)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(
                g.numpy().view(np.uint32).astype(np.uint64) if n_bits == 32
                else g.numpy().astype(np.uint64), w)


def test_to_fixed_uint8_shortcut_equals_the_rounding_path():
    """A uint8 image's containers are x << f when 255 * 2^f fits a
    non-negative container; otherwise (N = 16, f = 8) the rounding path
    runs; both equal the reference's to_fixed, and from_fixed at N = 32
    reads int32 containers directly."""
    img = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for n_bits, frac in ((32, 6), (32, 23), (16, 0), (16, 7), (16, 8)):
        sj = specs_j.AdderSpec("accurate", n_bits)
        st = specs_t.AdderSpec("accurate", n_bits)
        cj = fft_j.FixedFFTConfig(spec=sj, frac_bits=frac)
        ct = fft_t.FixedFFTConfig(spec=st, frac_bits=frac, **CPU)
        got = fft_t.to_fixed(img, ct)
        np.testing.assert_array_equal(
            got.numpy().view(np.uint32).astype(np.uint64)
            & np.uint64((1 << n_bits) - 1), fft_j.to_fixed(img, cj))
        np.testing.assert_array_equal(fft_t.from_fixed(got, ct).numpy(),
                                      fft_j.from_fixed(fft_j.to_fixed(
                                          img, cj), cj))
