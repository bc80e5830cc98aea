"""The spec-first execution handle (the port of ``repro.ax.engine``): one
object per (adder, format, backend, strategy, device) that every
approximate-arithmetic call site consumes.

    from repro_torch.ax import make_engine

    ax = make_engine("haloc_axa", fmt=FixedPointFormat(16, 8))  # on the card
    s = ax.add_signed(qx, qy)          # fixed-point containers
    c = ax.add(a, b)                   # raw N-bit containers, mod 2^N

    mac = make_engine("haloc_axa", fmt=FixedPointFormat(16, 0),
                      mul="truncated")                     # a MAC engine
    y = mac.conv2d(q, ((1, 3, 1), (3, 5, 3), (1, 3, 1)))  # 2D MAC conv
    z = mac.matmul(a8, b8)             # MAC GEMM, K tiles of 128

Engines are frozen, hashable and cached.  ``backend=None`` is the
``"cuda"`` backend on ``torch.device("cuda")``; with no CUDA device that
default raises and names the CPU spelling, ``backend="torch",
device="cpu"``.  Array arguments may be tensors or numpy arrays; they
are moved to the engine's device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import torch

from repro_torch.ax.backends import (Backend, check_strategy, get_backend,
                                     resolve_strategy)
from repro_torch.ax.lut import lut_supported
from repro_torch.ax.mul import (MAX_MUL_LUT_BITS, MacSpec, MulSpec,
                                default_mul_spec, get_multiplier,
                                mul_lut_supported)
from repro_torch.ax.registry import get_adder
from repro_torch.core.specs import AdderSpec
from repro_torch.numerics.fixed_point import (FixedPointFormat,
                                              container_to_signed,
                                              signed_to_container)


@dataclasses.dataclass(frozen=True)
class AxEngine:
    """Approximate-arithmetic execution handle.

    Attributes:
      spec: the adder (validated against the adder registry).
      fmt: fixed-point format for the signed entry points; ``None`` for
        raw-container use.
      backend: resolved execution backend.
      strategy: ``"reference"``, ``"fused"`` or ``"lut"`` (all
        bit-identical).
      device: where the engine's tensors live.
      mul_spec: the approximate multiplier, or ``None`` for an adder-only
        engine.  With a multiplier the engine is a MAC engine: ``mul`` and
        ``mul_signed`` run the multiplier alone, and ``conv2d`` and
        ``matmul`` route every product through it (with the adder on the
        accumulations).
    """

    spec: AdderSpec
    fmt: Optional[FixedPointFormat]
    backend: Backend
    strategy: str
    device: torch.device
    mul_spec: Optional[MulSpec] = None

    def tensor(self, x) -> torch.Tensor:
        """``x`` (tensor or array) as a tensor on the engine's device."""
        return torch.as_tensor(x, device=self.device)

    # ------------------------------------------------------ raw containers

    def add(self, a, b):
        """Elementwise approximate add mod 2^N on int32 N-bit containers."""
        return self.backend.add(self.tensor(a), self.tensor(b), self.spec,
                                strategy=self.strategy)

    def accumulate(self, terms, weights=None):
        """Weighted fold of K stacked container terms mod 2^N in one
        backend dispatch.  ``weights`` are K static ints, multiplied
        exactly before the K-1 approximate adds."""
        return self.backend.accumulate(self.tensor(terms), self.spec,
                                       weights=weights,
                                       strategy=self.strategy)

    def filter_chain(self, q, stages):
        """Chained separable-filter passes on signed containers: each
        :class:`FilterStage` taps the previous stage's output (replicate
        edges), folds the taps through one weighted approximate
        accumulation and applies its exact rounding shift.  One kernel
        launch on the ``"cuda"`` backend."""
        self._require_fmt("filter_chain")
        return self.backend.filter_chain(self.tensor(q), self.spec,
                                         tuple(stages),
                                         strategy=self.strategy)

    def butterfly(self, a_re, a_im, b_re, b_im, w_re, w_im,
                  inverse: bool = False):
        """One radix-2 FFT butterfly stage through the approximate adder:
        int32 (rows, half) planes, int32 (half,) Q1.14 twiddles; returns
        (top_re, top_im, bot_re, bot_im).  One kernel launch on the
        ``"cuda"`` backend."""
        t = self.tensor
        return self.backend.butterfly(t(a_re), t(a_im), t(b_re), t(b_im),
                                      t(w_re), t(w_im), self.spec,
                                      inverse=inverse)

    # --------------------------------------------------------- multipliers

    def mul(self, a, b):
        """Elementwise approximate multiply on unsigned N-bit container
        operands (N = ``mul_spec.n_bits``); returns the full approximate
        product (up to 2N+1 bits for logarithmic kinds).  One kernel
        launch on the ``"cuda"`` backend."""
        ms = self._require_mul("mul")
        return self.backend.mul(self.tensor(a), self.tensor(b), ms,
                                strategy=self.strategy)

    def mul_signed(self, qa, qb):
        """Sign-magnitude signed multiply on signed integer tensors with
        ``|q| <= 2^(N-1)``: ``sign(qa)*sign(qb)*approx(|qa|, |qb|)``, the
        product convention of the MAC datapaths."""
        ms = self._require_mul("mul_signed")
        qa, qb = self.tensor(qa), self.tensor(qb)
        p = self.backend.mul(qa.abs(), qb.abs(), ms, strategy=self.strategy)
        return torch.where((qa < 0) != (qb < 0), -p, p)

    def conv2d(self, q, kernel, shift: int = 0):
        """2D MAC convolution on signed containers: every tap product runs
        the approximate multiplier, the tap sums run the approximate adder
        (row-major fold, replicate edges), and ``shift`` applies an exact
        rounding right-shift.  ``kernel`` is a tuple-of-tuples of static
        integer weights with odd dimensions; ``|q| < 2^w`` (w = the
        multiplier's operand width) or ``ValueError``.  One kernel launch
        on the ``"cuda"`` backend."""
        self._require_fmt("conv2d")
        ms = self._require_mul("conv2d")
        return self.backend.conv2d(self.tensor(q), self.spec, ms, kernel,
                                   shift=shift, strategy=self.strategy)

    def matmul(self, a, b, block=(128, 128, 128)):
        """int8 GEMM with approximate inter-K-tile accumulation
        (``block[2]`` is the K tile, and part of the result).  On a MAC
        engine (``mul_spec`` set and not exact) every product also runs
        the approximate multiplier.  One kernel launch on the ``"cuda"``
        backend."""
        return self.backend.matmul(self.tensor(a), self.tensor(b), self.spec,
                                   block=tuple(block), strategy=self.strategy,
                                   mul_spec=self.mul_spec)

    # --------------------------------------------------------- fixed point

    def add_signed(self, qx, qy):
        """Two's-complement fixed-point add (signed int32 containers)."""
        fmt = self._require_fmt("add_signed")
        a = signed_to_container(self.tensor(qx), fmt)
        b = signed_to_container(self.tensor(qy), fmt)
        return container_to_signed(self.add(a, b), fmt)

    def accumulate_signed(self, qs, weights=None, shift: int = 0):
        """Signed fixed-point weighted accumulation: ``sum_i w_i * q_i``
        with exact tap multiplies, approximate adds, and an exact final
        rounding right-shift.  ``qs`` stacks K signed int32 containers on
        axis 0, or is a sequence of K of one shape; on the ``"cuda"``
        backend one kernel launch reads each where it lies (a sequence
        is never stacked)."""
        fmt = self._require_fmt("accumulate_signed")
        if isinstance(qs, (list, tuple)):
            terms = tuple(self.tensor(q) for q in qs)
        else:
            terms = self.tensor(qs).unbind(0)
        return self.backend.accumulate_signed(terms, self.spec, fmt.n_bits,
                                              weights=weights, shift=shift,
                                              strategy=self.strategy)

    def scaled_add(self, qx, qy, wx: int = 1, wy: int = 1, shift: int = 0):
        """Two-term weighted fixed-point add, ``(wx*qx + wy*qy) >> shift``
        with a single approximate add (one kernel launch on the
        ``"cuda"`` backend)."""
        return self.accumulate_signed((qx, qy), (wx, wy), shift=shift)

    # -------------------------------------------------------------- misc

    def replace(self, **kw) -> "AxEngine":
        """A new engine with some fields swapped (``backend`` may be a name
        string; ``fast`` maps onto ``strategy``; ``mul`` accepts a
        :class:`MulSpec`, a kind name, or ``None`` like
        :func:`make_engine`; ``device`` is checked against the backend as
        there)."""
        if "backend" in kw:
            kw["backend"] = get_backend(kw["backend"])
        if "backend" in kw or "device" in kw:
            kw["device"] = resolve_device(kw.get("backend", self.backend),
                                          kw.get("device", self.device))
        if "mul" in kw:
            kw["mul_spec"] = _normalize_mul(kw.pop("mul"))
        if "fast" in kw:
            kw["strategy"] = resolve_strategy(kw.get("strategy"),
                                              kw.pop("fast"))
        if "strategy" in kw:
            check_strategy(kw["strategy"])
            if kw["strategy"] == "auto":
                kw["strategy"] = kw.get("backend", self.backend) \
                    .preferred_strategy(kw.get("spec", self.spec))
        return dataclasses.replace(self, **kw)

    def _require_fmt(self, what: str) -> FixedPointFormat:
        if self.fmt is None:
            raise ValueError(
                f"AxEngine.{what} needs a fixed-point format; pass "
                f"fmt=FixedPointFormat(...) to make_engine")
        return self.fmt

    def _require_mul(self, what: str) -> MulSpec:
        if self.mul_spec is None:
            raise ValueError(
                f"AxEngine.{what} needs a multiplier; pass mul=... (a "
                f"MulSpec or kind name) or a MacSpec to make_engine")
        return self.mul_spec


def _default_spec(kind: str, n_bits: int) -> AdderSpec:
    """Scale the paper's 32-bit (m=10, k=5) partition to an ``n_bits``
    datapath: m = n/2, k = m/2 (the paper's Fig-4 example is exactly the
    N=16/m=8/k=4 instance of this rule)."""
    try:
        entry = get_adder(kind)
    except KeyError:
        raise ValueError(f"unknown adder kind {kind!r}") from None
    if entry.is_exact:
        return AdderSpec(kind=kind, n_bits=n_bits)
    if n_bits == 32:
        m, k = 10, 5
    else:
        m = max(2, n_bits // 2)
        k = m // 2
    return AdderSpec(kind=kind, n_bits=n_bits, lsm_bits=m,
                     const_bits=k if entry.const_section else 0)


def _normalize_mul(mul: Union[MulSpec, str, None]) -> Optional[MulSpec]:
    """``mul=`` coercion: a spec passes through, a kind name gets the
    kind's default knobs at 8 operand bits (the image-processing width),
    ``None`` means adder-only."""
    if mul is None or isinstance(mul, MulSpec):
        return mul
    if isinstance(mul, str):
        try:
            get_multiplier(mul)
        except KeyError:
            raise ValueError(f"unknown multiplier kind {mul!r}") from None
        return default_mul_spec(mul, n_bits=8)
    raise TypeError(f"mul must be a MulSpec, kind name or None; "
                    f"got {type(mul).__name__}")


def resolve_device(backend: Backend, device=None) -> torch.device:
    """The engine's device: ``None`` means the card.  Raises when the card
    is asked for and absent, naming the explicit CPU spelling, and when
    the ``"cuda"`` backend is given a non-CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available, and repro_torch runs on the "
                "card by default; to run on the CPU ask for it: "
                "backend='torch', device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif backend.name == "cuda":
        raise ValueError(
            f"the 'cuda' backend runs the CUDA kernels and needs a CUDA "
            f"device; got device={str(dev)!r} (use backend='torch' there)")
    return dev


@functools.lru_cache(maxsize=None)
def _make_engine_cached(spec: AdderSpec, fmt: Optional[FixedPointFormat],
                        backend: Backend, strategy: str,
                        device: torch.device,
                        mul_spec: Optional[MulSpec]) -> AxEngine:
    return AxEngine(spec=spec, fmt=fmt, backend=backend, strategy=strategy,
                    device=device, mul_spec=mul_spec)


def make_engine(spec: Union[AdderSpec, MacSpec, str],
                fmt: Optional[FixedPointFormat] = None,
                backend: Union[str, Backend, None] = None,
                fast: bool = False,
                strategy: Optional[str] = None,
                device: Union[str, torch.device, None] = None,
                fault=None,
                mul: Union[MulSpec, str, None] = None) -> AxEngine:
    """Build (or fetch the cached) execution engine.

    Args:
      spec: an :class:`AdderSpec`, a :class:`MacSpec` (bundling adder and
        multiplier; then ``mul`` must be left ``None``), or a registered
        adder kind name (a bare name gets the paper's (m, k) partition
        scaled to the format width; N=32 when no ``fmt`` is given).
      fmt: fixed-point format for the signed entry points; must match
        ``spec.n_bits`` for non-exact adders.
      backend: ``"cuda"`` (the kernels; the default), ``"torch"`` (their
        plain versions, any device) or a :class:`Backend`.
      fast: back-compat alias for ``strategy="fused"``.
      strategy: ``"reference" | "fused" | "lut"`` (all bit-identical),
        or ``"auto"`` for the backend's preferred one (fused).  ``"lut"``
        needs ``lsm_bits <= MAX_LUT_LSM_BITS``; on the ``"cuda"`` backend
        it covers the elementwise ``add`` only.
      device: where the engine's tensors live; ``None`` is the card.
      fault: hardware fault injection is not ported yet; anything but
        ``None`` raises ``NotImplementedError``.
      mul: optional approximate multiplier: a :class:`MulSpec`, a
        registered multiplier kind name (default knobs at 8 bits), or
        ``None`` for an adder-only engine.  With a multiplier the engine
        exposes ``mul``/``mul_signed``/``conv2d`` and its ``matmul``
        becomes a full approximate MAC.
    """
    if fault is not None:
        raise NotImplementedError(
            "fault injection (repro.resilience) is not ported yet; "
            "pass fault=None")
    strategy = resolve_strategy(strategy, fast)
    if isinstance(spec, MacSpec):
        if mul is not None:
            raise ValueError("pass either a MacSpec or mul=..., not both")
        spec, mul = spec.adder, spec.mul
    if isinstance(spec, str):
        spec = _default_spec(spec, fmt.n_bits if fmt is not None else 32)
    mul_spec = _normalize_mul(mul)
    if (fmt is not None and not get_adder(spec.kind).is_exact
            and spec.n_bits != fmt.n_bits):
        raise ValueError(
            f"adder width N={spec.n_bits} must match fixed-point "
            f"container n_bits={fmt.n_bits}")
    if strategy == "lut" and not lut_supported(spec):
        raise ValueError(
            f"no compilable LUT for {spec.short_name} (lsm_bits too "
            f"wide); use strategy='reference' or 'fused'")
    if (strategy == "lut" and mul_spec is not None
            and not mul_lut_supported(mul_spec)):
        raise ValueError(
            f"no compilable LUT for {mul_spec.short_name} (n_bits > "
            f"{MAX_MUL_LUT_BITS}); use strategy='reference' or 'fused'")
    resolved = get_backend(backend)
    dev = resolve_device(resolved, device)
    if strategy == "auto":
        strategy = resolved.preferred_strategy(spec)
    return _make_engine_cached(spec, fmt, resolved, strategy, dev, mul_spec)
