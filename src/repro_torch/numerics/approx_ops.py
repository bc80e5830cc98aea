"""Model-facing configuration for the paper's approximate arithmetic (the
port of ``repro.numerics.approx_ops``).

``ApproxNumericsConfig`` is the knob carried by every model config
(``--adder haloc_axa`` on the serving launcher).  It is a thin wrapper
over a :class:`repro_torch.ax.AxEngine`: the config names the
adder, format, backend and device; the engine executes.  Model layers
call ``cfg.residual_add(x, y)`` and never touch the spec, format or
backend.

The engine runs where :func:`repro_torch.ax.make_engine` runs it: the
``"cuda"`` backend (the ``approx_add`` or ``lut_add`` kernel) on the
card by default, which raises without one; ask for the plain versions
on the CPU with ``backend="torch", device="cpu"``.  The device is
resolved when the engine is first asked for, so a config can be built
(and the model configs imported) on a host without a card.

The module-level functions (:func:`approx_add_signed`,
:func:`approx_residual_add`, :func:`approx_sum`) are the pre-engine
entry points, kept as deprecation shims that delegate to an engine.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.ax.engine import make_engine
from repro_torch.ax.registry import get_adder
from repro_torch.core.specs import ACCURATE, AdderSpec
from repro_torch.numerics.fixed_point import FixedPointFormat

Device = Union[str, torch.device, None]


def _engine(spec: AdderSpec, fmt: FixedPointFormat, backend, fast: bool,
            device: Device = None):
    return make_engine(spec, fmt=fmt, backend=backend, fast=fast,
                       device=device)


@dataclasses.dataclass(frozen=True)
class ApproxNumericsConfig:
    """How the paper's adder is deployed inside a model.

    where:   "off" | "residual" (residual-stream adds) | "residual+logits"
             (accepted; no layer reads it past validation, as in the
             reference).
    fmt:     fixed-point format of the approximate dataflow.
    spec:    the adder (paper default: HALOC-AxA at a 16-bit datapath uses
             m=8, k=4 — the paper's own Fig-4 scaling of N=32,m=10,k=5).
    backend: ``"cuda"`` (the kernels) or ``"torch"`` (their plain
             versions, any device).
    device:  where the engine runs; ``None`` is the card.
    """

    spec: AdderSpec = AdderSpec(kind=ACCURATE)
    fmt: FixedPointFormat = FixedPointFormat(16, 8)
    where: str = "off"
    # algebraically-fused emulation (bit-identical; fewer operations).
    fast: bool = False
    backend: str = "cuda"
    device: Device = None

    def __post_init__(self):
        if self.where not in ("off", "residual", "residual+logits"):
            raise ValueError(f"bad approx 'where': {self.where!r}")
        if self.spec.kind != ACCURATE and self.spec.n_bits != self.fmt.n_bits:
            raise ValueError(
                f"adder width N={self.spec.n_bits} must match fixed-point "
                f"container n_bits={self.fmt.n_bits}"
            )

    @property
    def enabled(self) -> bool:
        return self.where != "off" and self.spec.kind != ACCURATE

    @property
    def engine(self):
        """The cached :class:`repro_torch.ax.AxEngine` this config names."""
        return _engine(self.spec, self.fmt, self.backend, self.fast,
                       self.device)

    def residual_add(self, x, y):
        """Residual-stream add; the exact float add when the config is
        off."""
        if not self.enabled:
            return x + y
        return self.engine.residual_add(x, y)


def make_numerics(adder: str = "accurate", where: str = "off",
                  n_bits: int = 16, frac_bits: int = 8,
                  lsm_bits: Optional[int] = None,
                  const_bits: Optional[int] = None,
                  fast: bool = False,
                  backend: str = "cuda",
                  device: Device = None) -> ApproxNumericsConfig:
    """Convenience constructor used by model configs and CLI flags.

    Defaults scale the paper's 32-bit (m=10, k=5) partition to the 16-bit
    activation datapath: m=8, k=4 (the paper's own Fig-4 example uses
    exactly this N=16/m=8/k=4 split).
    """
    if adder == ACCURATE or where == "off":
        return ApproxNumericsConfig(where="off", backend=backend,
                                    device=device)
    try:
        const_section = get_adder(adder).const_section
    except KeyError:
        raise ValueError(f"unknown adder kind {adder!r}") from None
    m = lsm_bits if lsm_bits is not None else max(2, n_bits // 2)
    k = const_bits if const_bits is not None else m // 2
    spec = AdderSpec(kind=adder, n_bits=n_bits, lsm_bits=m,
                     const_bits=k if const_section else 0)
    return ApproxNumericsConfig(
        spec=spec, fmt=FixedPointFormat(n_bits, frac_bits), where=where,
        fast=fast, backend=backend, device=device)


# ------------------------------------------------- deprecated entry points --

def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"repro_torch.numerics.approx_ops.{old} is deprecated; use {new} "
        f"(see MIGRATION.md)", DeprecationWarning, stacklevel=3)


def _where(x):
    """(backend, device) of the engine a shim runs on: the operand's own
    device, the kernels on a CUDA tensor, the plain versions elsewhere
    (a numpy array is the CPU's)."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
    return ("cuda" if dev.type == "cuda" else "torch"), dev


def approx_add_signed(qx, qy, spec: AdderSpec, fmt: FixedPointFormat,
                      fast: bool = False):
    """Deprecated shim for ``make_engine(spec, fmt=fmt).add_signed``.

    Two's-complement fixed-point add via the approximate adder: inputs
    and outputs are signed int32 containers holding Q-format values, and
    overflow wraps modulo 2^N — exactly like the hardware adder.
    Preserves the old array-type contract: numpy in -> numpy out.
    """
    _deprecated("approx_add_signed", "AxEngine.add_signed")
    backend, dev = _where(qx)
    out = _engine(spec, fmt, backend, fast, dev).add_signed(qx, qy)
    return out.numpy() if isinstance(qx, np.ndarray) else out


def approx_residual_add(x, y, cfg: ApproxNumericsConfig):
    """Deprecated shim for ``cfg.residual_add`` /
    ``AxEngine.residual_add``."""
    _deprecated("approx_residual_add", "ApproxNumericsConfig.residual_add")
    return cfg.residual_add(x, y)


def approx_sum(q, spec: AdderSpec, fmt: FixedPointFormat, axis: int = -1):
    """Deprecated shim for ``make_engine(spec, fmt=fmt).sum``.

    Tree reduction of signed fixed-point values with approximate adds
    (log-depth tree, matching a reduction-tree ASIC accumulator).
    """
    _deprecated("approx_sum", "AxEngine.sum")
    backend, dev = _where(q)
    return _engine(spec, fmt, backend, False, dev).sum(q, axis=axis)


def effective_lsb_bias(spec: AdderSpec) -> float:
    """Expected bias contributed by the constant-1 section (analysis aid).

    For OLOCA/M-HERLOA/HALOC-AxA the low k sum bits read 1 regardless of
    the operands, so E[S_low - (A+B)_low] = (2^k - 1) - 2 * (2^k - 1)/2 = 0
    in expectation for uniform operands, but the worst case is +/-(2^k - 1).
    Exposed for the numerics documentation/tests.
    """
    k = spec.effective_const_bits
    return float((1 << k) - 1) / 2.0 if k else 0.0
