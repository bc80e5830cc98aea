"""The spec-first execution handle (the port of ``repro.ax.engine``): one
object per (adder, format, backend, strategy, device) that every
approximate-arithmetic call site consumes.

    from repro_torch.ax import make_engine

    ax = make_engine("haloc_axa", fmt=FixedPointFormat(16, 8))  # on the card
    s = ax.add_signed(qx, qy)          # fixed-point containers
    c = ax.add(a, b)                   # raw N-bit containers, mod 2^N

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

from repro_torch.ax.backends import Backend, get_backend, resolve_strategy
from repro_torch.ax.lut import lut_supported
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
    """

    spec: AdderSpec
    fmt: Optional[FixedPointFormat]
    backend: Backend
    strategy: str
    device: torch.device

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
        axis 0."""
        fmt = self._require_fmt("accumulate_signed")
        u = signed_to_container(self.tensor(qs), fmt)
        s = container_to_signed(self.accumulate(u, weights), fmt)
        if shift:
            s = (s + (1 << (shift - 1))) >> shift
        return s

    def scaled_add(self, qx, qy, wx: int = 1, wy: int = 1, shift: int = 0):
        """Two-term weighted fixed-point add, ``(wx*qx + wy*qy) >> shift``
        with a single approximate add."""
        return self.accumulate_signed(
            torch.stack([self.tensor(qx), self.tensor(qy)]), (wx, wy),
            shift=shift)

    def _require_fmt(self, what: str) -> FixedPointFormat:
        if self.fmt is None:
            raise ValueError(
                f"AxEngine.{what} needs a fixed-point format; pass "
                f"fmt=FixedPointFormat(...) to make_engine")
        return self.fmt


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
                        device: torch.device) -> AxEngine:
    return AxEngine(spec=spec, fmt=fmt, backend=backend, strategy=strategy,
                    device=device)


def make_engine(spec: Union[AdderSpec, str],
                fmt: Optional[FixedPointFormat] = None,
                backend: Union[str, Backend, None] = None,
                fast: bool = False,
                strategy: Optional[str] = None,
                device: Union[str, torch.device, None] = None,
                fault=None) -> AxEngine:
    """Build (or fetch the cached) execution engine.

    Args:
      spec: an :class:`AdderSpec` or a registered adder kind name (a bare
        name gets the paper's (m, k) partition scaled to the format width;
        N=32 when no ``fmt`` is given).
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
    """
    if fault is not None:
        raise NotImplementedError(
            "fault injection (repro.resilience) is not ported yet; "
            "pass fault=None")
    strategy = resolve_strategy(strategy, fast)
    if isinstance(spec, str):
        spec = _default_spec(spec, fmt.n_bits if fmt is not None else 32)
    if (fmt is not None and not get_adder(spec.kind).is_exact
            and spec.n_bits != fmt.n_bits):
        raise ValueError(
            f"adder width N={spec.n_bits} must match fixed-point "
            f"container n_bits={fmt.n_bits}")
    if strategy == "lut" and not lut_supported(spec):
        raise ValueError(
            f"no compilable LUT for {spec.short_name} (lsm_bits too "
            f"wide); use strategy='reference' or 'fused'")
    resolved = get_backend(backend)
    dev = resolve_device(resolved, device)
    if strategy == "auto":
        strategy = resolved.preferred_strategy(spec)
    return _make_engine_cached(spec, fmt, resolved, strategy, dev)
