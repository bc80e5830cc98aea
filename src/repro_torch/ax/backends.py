"""Execution backends for the approximate-arithmetic engine (the port of
``repro.ax.backends``).

A backend is a named execution target for the registered adders:

- ``"torch"``  the plain PyTorch versions of the kernels, eager, on any
               device: int64 lanes holding the unsigned pattern.  The
               counterpart of the reference's ``"jax"`` backend, and what
               the CPU tests run.
- ``"cuda"``   the hand-written CUDA kernels of
               :mod:`repro_torch.kernels` on CUDA tensors only.  The
               counterpart of ``"pallas_tpu"``, and the default.

Orthogonal to the backend, every add-shaped primitive takes an execution
*strategy*: ``"reference"`` (the registered bit-level oracle),
``"fused"`` (the registered fused form, bit-identical) or ``"lut"`` (the
compiled ``2^m x 2^m`` low-part table of :mod:`repro_torch.ax.lut`: one
gather and one exact high add, bit-identical).  The ``"torch"`` backend
runs ``lut`` for every primitive; the ``"cuda"`` backend has a lut
kernel for the elementwise ``add`` only, as the reference's Pallas
backends do.  Exact kinds have no table and take the plain add.

Both backends also run one radix-2 FFT butterfly stage
(:meth:`Backend.butterfly`), the paper's Fig-5 datapath, and the MAC
primitives of :mod:`repro_torch.ax.mul`'s multipliers: the elementwise
:meth:`Backend.mul` (reference, fused and lut forms on both), the 2D MAC
:meth:`Backend.conv2d` and both :meth:`Backend.matmul` paths (the
exact-product int8 GEMM, and the MAC GEMM when a multiplier is given).
The ``"torch"`` backend follows the reference's ``"jax"`` backend,
every strategy included; the ``"cuda"`` backend's ``conv2d`` and
``matmul`` raise for the adder's lut strategy, as the reference's Pallas
backends do, and its exact-product GEMM takes int8 operands only.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple, Union

import torch

from repro_torch.ax.mul.registry import get_multiplier
from repro_torch.ax.mul.specs import MulSpec
from repro_torch.ax.registry import get_adder
from repro_torch.core.specs import AdderSpec

#: Legal execution strategies for the add-shaped primitives.
STRATEGIES = ("reference", "fused", "lut")

#: Placeholder accepted everywhere a strategy is: resolves to the
#: backend's preferred concrete strategy at engine construction.
AUTO_STRATEGY = "auto"


def check_strategy(strategy: str) -> str:
    if strategy not in STRATEGIES and strategy != AUTO_STRATEGY:
        raise ValueError(
            f"unknown strategy {strategy!r}; one of "
            f"{STRATEGIES + (AUTO_STRATEGY,)}")
    return strategy


def resolve_strategy(strategy, fast: bool) -> str:
    """The mapping from the back-compat ``fast`` flag to a strategy name:
    an explicit ``strategy`` wins, else ``fast`` picks fused."""
    if strategy is None:
        strategy = "fused" if fast else "reference"
    return check_strategy(strategy)


def _require_concrete(strategy: str) -> str:
    """Backend methods take concrete strategies only: ``"auto"`` is
    resolved by ``make_engine``, which knows the backend."""
    if strategy == AUTO_STRATEGY:
        raise ValueError(
            "strategy='auto' is resolved at engine construction "
            "(make_engine); Backend methods take one of "
            f"{STRATEGIES}")
    return strategy


def _fast(strategy: str) -> bool:
    """The ``fast`` flag the adder models and kernels take (lut is
    dispatched by :func:`_use_lut` first)."""
    return _require_concrete(strategy) == "fused"


def _use_lut(spec: AdderSpec, strategy: str) -> bool:
    """Whether this (spec, strategy) dispatches through the table (exact
    kinds have no approximate section: the plain add is their fast
    path)."""
    return _require_concrete(strategy) == "lut" \
        and not get_adder(spec.kind).is_exact


def _use_mul_lut(mul_spec: MulSpec, strategy: str) -> bool:
    """Multiplier-side twin of :func:`_use_lut`: the accurate kind's
    native multiply beats any gather."""
    return _require_concrete(strategy) == "lut" \
        and not get_multiplier(mul_spec.kind).is_exact


class FilterStage(NamedTuple):
    """One separable-filter pass of a :meth:`Backend.filter_chain`:
    replicate-padded taps at ``offsets`` along ``axis``, exact integer
    ``weights``, one weighted approximate accumulation, then an exact
    rounding right-``shift`` (the pass's normalization)."""

    axis: int
    offsets: Tuple[int, ...]
    weights: Tuple[int, ...]
    shift: int = 0


def edge_taps(q: torch.Tensor, axis: int, offsets):
    """Replicate-padded shifted views of a filter tap, as a list: the
    j-th view satisfies ``out[j][..., i] = q[..., clamp(i + offsets[j])]``
    along ``axis`` — replicate padding written as a clamped gather."""
    axis = axis % q.ndim
    n = q.shape[axis]
    base = torch.arange(n, device=q.device)
    return [q.index_select(axis, (base + o).clamp(0, n - 1))
            for o in offsets]


def conv_taps(q: torch.Tensor, kh: int, kw: int):
    """Replicate-padded shifted views for a (kh, kw) 2D kernel over the
    trailing (H, W) dims, in row-major tap order: view (dy, dx) at output
    (y, x) reads ``q[..., clamp(y + dy - kh//2), clamp(x + dx - kw//2)]``.
    THE 2D tap builder of the conv datapaths, like :func:`edge_taps` for
    the separable chains."""
    h, w = q.shape[-2], q.shape[-1]
    rows = torch.arange(h, device=q.device)
    cols = torch.arange(w, device=q.device)
    views = []
    for dy in range(kh):
        r = q.index_select(-2, (rows + dy - kh // 2).clamp(0, h - 1))
        for dx in range(kw):
            views.append(r.index_select(-1,
                                        (cols + dx - kw // 2).clamp(0, w - 1)))
    return views


def check_conv_kernel(kernel) -> Tuple[int, int, Tuple[int, ...]]:
    """Validate a static conv kernel: rectangular tuple-of-tuples of ints,
    odd dims.  Returns (kh, kw, row-major flat weights)."""
    kh = len(kernel)
    if kh == 0 or kh % 2 == 0:
        raise ValueError(f"kernel height must be odd and nonzero, got {kh}")
    kw = len(kernel[0])
    if kw == 0 or kw % 2 == 0:
        raise ValueError(f"kernel width must be odd and nonzero, got {kw}")
    if any(len(row) != kw for row in kernel):
        raise ValueError("kernel rows must have equal length")
    return kh, kw, tuple(int(w) for row in kernel for w in row)


def broadcast_operands(a: torch.Tensor, b: torch.Tensor):
    """Two elementwise operands broadcast to one shape and made
    contiguous, as the kernels take them (the ``"torch"`` backend's and
    the reference's broadcasting; shapes that do not broadcast raise)."""
    return tuple(t.contiguous() for t in torch.broadcast_tensors(a, b))


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """Operand lanes as the reference's ``jax`` backend takes them: a
    signed tensor as int32 read as its unsigned pattern, an unsigned one
    as it is; int64 either way."""
    if x.dtype.is_signed:
        from repro_torch.kernels.approx_add import u32_lanes
        return u32_lanes(x.to(torch.int32))
    return x.to(torch.int64)


def _like(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The product in the operand's dtype, as the reference's ``_like``:
    int32 (the low 32 bits) for signed operands, else ``dtype``."""
    from repro_torch.kernels.approx_add import to_int32
    return to_int32(p) if dtype.is_signed else p.to(dtype)


def run_stages(q: torch.Tensor, spec: AdderSpec, stages,
               fold: Callable) -> torch.Tensor:
    """THE per-stage filter chain on signed int32 containers: for each
    stage, stack its edge taps, mask them to N bits, ``fold(taps,
    weights)`` them (one weighted approximate accumulation), sign-extend
    and apply the stage's rounding shift."""
    mask = (1 << spec.n_bits) - 1
    sign = 1 << (spec.n_bits - 1)
    for st in stages:
        taps = torch.stack(edge_taps(q, st.axis, st.offsets))
        s = fold(taps & mask, st.weights)
        s = (s ^ sign) - sign
        if st.shift:
            s = (s + (1 << (st.shift - 1))) >> st.shift
        q = s
    return q


class Backend:
    """Abstract execution engine for approximate-arithmetic primitives.

    Array-valued methods take int32 *container* tensors: N-bit unsigned
    patterns (or, for :meth:`filter_chain`, signed values)."""

    name = "abstract"

    def available(self) -> bool:
        return True

    def preferred_strategy(self, spec: AdderSpec) -> str:
        """What ``strategy="auto"`` resolves to: the fused forms."""
        return "fused"

    def add(self, a, b, spec: AdderSpec, *, strategy: str = "reference"):
        """Elementwise approximate add reduced mod 2^N (int32 container)."""
        raise NotImplementedError

    def accumulate(self, terms, spec: AdderSpec, *, weights=None,
                   strategy: str = "reference"):
        """Weighted K-term fold through the approximate adder, mod 2^N,
        in one dispatch; ``weights`` are K static ints applied as exact
        multiplies before the K-1 approximate adds."""
        raise NotImplementedError

    def accumulate_signed(self, terms, spec: AdderSpec, n_bits: int, *,
                          weights=None, shift: int = 0,
                          strategy: str = "reference"):
        """Signed fixed-point fold of K signed terms of one shape (a
        sequence of tensors) held in ``n_bits``-bit containers: each
        masked to its container, one weighted :meth:`accumulate`, sign
        extension from ``n_bits``, then the exact rounding right-``shift``
        (its add wrapping in int32)."""
        raise NotImplementedError

    def filter_chain(self, q, spec: AdderSpec, stages, *,
                     strategy: str = "reference"):
        """Chained separable-filter passes on SIGNED int32 containers;
        by default one :meth:`accumulate` dispatch per stage."""
        _require_concrete(strategy)
        return run_stages(q, spec, stages,
                          lambda taps, ws: self.accumulate(
                              taps, spec, weights=ws, strategy=strategy))

    def butterfly(self, a_re, a_im, b_re, b_im, w_re, w_im, spec: AdderSpec,
                  *, inverse: bool = False):
        """One radix-2 FFT butterfly stage (exact Q1.14 twiddle
        multiplies, approximate adds/subs mod 2^N, halving when
        ``inverse``) on int32 (rows, half) planes and (half,) twiddles;
        returns (top_re, top_im, bot_re, bot_im)."""
        raise NotImplementedError

    def fft_axis(self, re, im, layout, spec: AdderSpec, *,
                 inverse: bool = False, out=None):
        """Every radix-2 DIT stage of the length-n transforms that
        ``layout`` (a :class:`repro_torch.kernels.butterfly.AxisLayout`)
        finds in contiguous int32 containers ``re``/``im``: the butterfly
        stages of :meth:`butterfly` chained, bit-reversed load, natural
        order out, into ``out`` (new tensors unless given)."""
        raise NotImplementedError

    def mul(self, a, b, mul_spec: MulSpec, *, strategy: str = "reference"):
        """Elementwise approximate multiply on unsigned N-bit operand
        patterns; returns the FULL product (int32 for signed operands,
        else the operands' dtype)."""
        raise NotImplementedError

    def conv2d(self, q, spec: AdderSpec, mul_spec: MulSpec, kernel, *,
               shift: int = 0, strategy: str = "reference"):
        """2D MAC convolution on SIGNED values, ``|q| < 2^w``: per-tap
        products through the approximate multiplier (sign-magnitude,
        static integer weights), the taps folded through the approximate
        adder mod 2^N in row-major order, sign extension, then an exact
        rounding right-``shift``; replicate edges.  int32 out."""
        raise NotImplementedError

    def matmul(self, a, b, spec: AdderSpec, *, block=(128, 128, 128),
               strategy: str = "reference",
               mul_spec: "MulSpec | None" = None):
        """(M, K) @ (K, N) -> int32 with K tiles of ``block[2]``.  With
        ``mul_spec=None`` (or an exact kind): exact per-tile int8 dots
        and approximate inter-tile folds.  With an approximate
        ``mul_spec``: every product through the multiplier (the signed
        table), exact sums in the tile, approximate folds between
        tiles.  ``block[0]``/``block[1]`` do not change the result."""
        raise NotImplementedError

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"<ax backend {self.name!r}>"


class TorchBackend(Backend):
    """The kernels' plain versions, eager, on any device."""

    name = "torch"

    def add(self, a, b, spec, *, strategy="reference"):
        if _use_lut(spec, strategy):
            from repro_torch.kernels.lut_add import lut_add_plain
            return lut_add_plain(a, b, spec)
        from repro_torch.kernels.approx_add import approx_add_plain
        return approx_add_plain(a, b, spec, _fast(strategy))

    def _lut_add(self, spec, strategy, device):
        """The lut strategy's lane-level add (its table gather), or None
        for the registered adder."""
        if not _use_lut(spec, strategy):
            return None
        from repro_torch.ax.lut import device_table
        from repro_torch.kernels.lut_add import lut_gather_add
        table = device_table(spec, device)
        return lambda a, b: lut_gather_add(a, b, table, spec)

    def accumulate(self, terms, spec, *, weights=None, strategy="reference"):
        from repro_torch.kernels.accumulate import accumulate_plain
        return accumulate_plain(terms, spec, weights, _fast(strategy),
                                add=self._lut_add(spec, strategy,
                                                  terms.device))

    def accumulate_signed(self, terms, spec, n_bits, *, weights=None,
                          shift=0, strategy="reference"):
        from repro_torch.kernels.accumulate import accumulate_signed_plain
        terms = tuple(terms)
        return accumulate_signed_plain(
            terms, spec, n_bits, weights, shift, _fast(strategy),
            add=self._lut_add(spec, strategy, terms[0].device))

    def butterfly(self, a_re, a_im, b_re, b_im, w_re, w_im, spec, *,
                  inverse=False):
        from repro_torch.kernels.butterfly import butterfly_plain
        return butterfly_plain(a_re, a_im, b_re, b_im, w_re, w_im, spec,
                               inverse=inverse)

    def fft_axis(self, re, im, layout, spec, *, inverse=False, out=None):
        from repro_torch.kernels.butterfly import fft_axis_plain
        return fft_axis_plain(re, im, layout, spec, inverse=inverse,
                              out=out)

    def mul(self, a, b, mul_spec, *, strategy="reference"):
        from repro_torch.kernels.mul import mul_lanes
        p = mul_lanes(_lanes(a), _lanes(b), mul_spec,
                      _require_concrete(strategy))
        return _like(p, a.dtype)

    def _fold(self, spec, strategy):
        """The inter-term fold on int32 containers, in ``strategy``."""
        _require_concrete(strategy)
        return lambda x, y: self.add(x, y, spec, strategy=strategy)

    def conv2d(self, q, spec, mul_spec, kernel, *, shift=0,
               strategy="reference"):
        from repro_torch.kernels.conv2d_mac import conv2d_mac_plain
        return conv2d_mac_plain(q, spec, mul_spec, kernel, shift,
                                add=self._fold(spec, strategy))

    def matmul(self, a, b, spec, *, block=(128, 128, 128),
               strategy="reference", mul_spec=None):
        add = self._fold(spec, strategy)
        if mul_spec is not None and not mul_spec.is_exact:
            from repro_torch.kernels.mac_matmul import mac_matmul_plain
            return mac_matmul_plain(a, b, spec, mul_spec, block[2], add=add)
        from repro_torch.kernels.approx_matmul import approx_matmul_plain
        return approx_matmul_plain(a, b, spec, block[2], add=add)


class CudaBackend(Backend):
    """The hand-written CUDA kernels; CUDA tensors only."""

    name = "cuda"

    def available(self) -> bool:
        return torch.cuda.is_available()

    @staticmethod
    def _require_cuda(what: str, *tensors) -> None:
        for t in tensors:
            if t.device.type != "cuda":
                raise ValueError(
                    f"the 'cuda' backend's {what} takes CUDA tensors; got "
                    f"one on {t.device} (use backend='torch' for the CPU)")

    def _kernel_fast(self, spec, strategy, what) -> bool:
        """The accumulation kernels fold the registered impls; the lut
        strategy has kernels for the elementwise add and mul only."""
        if _use_lut(spec, strategy):
            raise NotImplementedError(
                f"the lut strategy is implemented for the elementwise add "
                f"and mul only, not for {what} on the {self.name!r} "
                f"backend; use strategy='fused' (or the 'torch' backend for "
                f"lut)")
        return _fast(strategy)

    def add(self, a, b, spec, *, strategy="reference"):
        self._require_cuda("add", a, b)
        a, b = broadcast_operands(a, b)
        if _use_lut(spec, strategy):
            from repro_torch.kernels.lut_add import lut_add
            return lut_add(a, b, spec)
        from repro_torch.kernels.approx_add import approx_add
        return approx_add(a, b, spec, fast=_fast(strategy))

    def accumulate(self, terms, spec, *, weights=None, strategy="reference"):
        from repro_torch.kernels.accumulate import accumulate
        fast = self._kernel_fast(spec, strategy, "accumulate")
        self._require_cuda("accumulate", terms)
        return accumulate(terms.contiguous(), spec, weights=weights,
                          fast=fast)

    def accumulate_signed(self, terms, spec, n_bits, *, weights=None,
                          shift=0, strategy="reference"):
        """One launch: the kernel reads every term where it lies."""
        from repro_torch.kernels.accumulate import accumulate_signed
        fast = self._kernel_fast(spec, strategy, "accumulate_signed")
        terms = tuple(terms)
        self._require_cuda("accumulate_signed", *terms)
        return accumulate_signed(terms, spec, n_bits, weights=weights,
                                 shift=shift, fast=fast)

    def filter_chain(self, q, spec, stages, *, strategy="reference"):
        from repro_torch.kernels.conv_chain import filter_chain
        fast = self._kernel_fast(spec, strategy, "filter_chain")
        self._require_cuda("filter_chain", q)
        return filter_chain(q.contiguous(), spec, tuple(stages), fast=fast)

    def butterfly(self, a_re, a_im, b_re, b_im, w_re, w_im, spec, *,
                  inverse=False):
        """The kernel runs the registered fused form of the adder
        (bit-identical to the reference form)."""
        from repro_torch.kernels.butterfly import butterfly
        self._require_cuda("butterfly", a_re, a_im, b_re, b_im, w_re, w_im)
        return butterfly(a_re, a_im, b_re, b_im, w_re.contiguous(),
                         w_im.contiguous(), spec, inverse=inverse, fast=True)

    def fft_axis(self, re, im, layout, spec, *, inverse=False, out=None):
        """One launch for the whole axis, on the fused form (as
        :meth:`butterfly`)."""
        from repro_torch.kernels.butterfly import fft_axis
        self._require_cuda("fft_axis", re, im, *(out or ()))
        return fft_axis(re, im, layout, spec, inverse=inverse, fast=True,
                        out=out)

    def mul(self, a, b, mul_spec, *, strategy="reference"):
        """The kernel takes int32; other integer operands are converted
        and the product returned as :func:`_like` says."""
        from repro_torch.ax.mul.lut import MAX_MUL_LUT_BITS, \
            mul_lut_supported
        from repro_torch.kernels.mul import mul
        self._require_cuda("mul", a, b)
        if _use_mul_lut(mul_spec, strategy) \
                and not mul_lut_supported(mul_spec):
            raise NotImplementedError(
                f"no compilable product table for {mul_spec.short_name} "
                f"(n_bits > {MAX_MUL_LUT_BITS}); use strategy='fused'")
        p = mul(*broadcast_operands(a.to(torch.int32), b.to(torch.int32)),
                mul_spec, strategy=strategy)
        return p if a.dtype.is_signed else p.to(a.dtype)

    def conv2d(self, q, spec, mul_spec, kernel, *, shift=0,
               strategy="reference"):
        """``|q| < 2^w`` is checked on the caller's dtype, before the
        kernel's int32 (an int64 value past 2^31 must not wrap into
        range)."""
        from repro_torch.kernels.conv2d_mac import (check_conv_input,
                                                    launch_conv2d_mac)
        fast = self._kernel_fast(spec, strategy, "conv2d")
        self._require_cuda("conv2d", q)
        check_conv_input(q, mul_spec, shift)
        return launch_conv2d_mac(q.to(torch.int32).contiguous(), spec,
                                 mul_spec, kernel, shift=shift, fast=fast)

    def matmul(self, a, b, spec, *, block=(128, 128, 128),
               strategy="reference", mul_spec=None):
        """The MAC GEMM takes the operands as int32; the exact-product
        GEMM takes int8 only (``approx_matmul`` raises ``TypeError`` for
        any other dtype, as ``approx_matmul_pallas`` refuses them)."""
        fast = self._kernel_fast(spec, strategy, "matmul")
        self._require_cuda("matmul", a, b)
        if mul_spec is not None and not mul_spec.is_exact:
            from repro_torch.kernels.mac_matmul import mac_matmul
            return mac_matmul(a.to(torch.int32).contiguous(),
                              b.to(torch.int32).contiguous(), spec,
                              mul_spec, bk=block[2], fast=fast)
        from repro_torch.kernels.approx_matmul import approx_matmul
        return approx_matmul(a.contiguous(), b.contiguous(), spec,
                             bk=block[2], fast=fast)


# --------------------------------------------------------------- registry --

_BACKENDS: Dict[str, Backend] = {}

#: The backend ``backend=None`` resolves to: the kernels, on the card.
DEFAULT_BACKEND = "cuda"


def register_backend(backend: Backend) -> Backend:
    """Register a backend instance under ``backend.name``."""
    if backend.name in _BACKENDS:
        raise ValueError(f"backend {backend.name!r} already registered")
    _BACKENDS[backend.name] = backend
    return backend


def get_backend(backend: Union[str, Backend, None] = None) -> Backend:
    """Resolve a backend by name; ``None`` is :data:`DEFAULT_BACKEND`."""
    if backend is None:
        backend = DEFAULT_BACKEND
    if isinstance(backend, Backend):
        return backend
    try:
        return _BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; registered: "
            f"{sorted(_BACKENDS)}") from None


def available_backends() -> Dict[str, bool]:
    """name -> availability on this host."""
    return {name: be.available() for name, be in sorted(_BACKENDS.items())}


register_backend(TorchBackend())
register_backend(CudaBackend())
