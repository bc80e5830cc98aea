"""DEPRECATED public wrappers around the kernels (the port of
``repro.kernels.ops``).

The reference kept these shims from before its spec-first engine: each
warns ``DeprecationWarning`` once a call and delegates to a backend.
Here they delegate to the port's engine, on the card by default
(``backend="cuda"``: the ``approx_add``, ``approx_matmul`` and
``butterfly`` kernels); ask for the CPU with ``backend="torch",
device="cpu"`` (the reference's ``interpret`` flag has no meaning here).
Use

    from repro_torch.ax import make_engine
    ax = make_engine(spec)                  # or backend="torch", device="cpu"
    ax.add(a, b); ax.matmul(a, b); ax.butterfly(...)

instead (see MIGRATION.md).
"""

from __future__ import annotations

import warnings

from repro_torch.core.specs import AdderSpec


def _engine(spec: AdderSpec, backend: str, device):
    from repro_torch.ax import make_engine
    return make_engine(spec, backend=backend, device=device)


def _deprecated(old: str) -> None:
    warnings.warn(
        f"repro_torch.kernels.ops.{old} is deprecated; use "
        f"repro_torch.ax.make_engine(spec, backend='cuda'/'torch') "
        f"(see MIGRATION.md)", DeprecationWarning, stacklevel=3)


def approx_add(a, b, spec: AdderSpec, *, backend: str = "cuda",
               device=None):
    """Deprecated shim: elementwise approximate add of two int32 tensors."""
    _deprecated("approx_add")
    return _engine(spec, backend, device).add(a, b)


def approx_matmul(a, b, spec: AdderSpec, block=(128, 128, 128), *,
                  backend: str = "cuda", device=None):
    """Deprecated shim: int8 (M,K) @ int8 (K,N) -> int32 approximate GEMM."""
    _deprecated("approx_matmul")
    return _engine(spec, backend, device).matmul(a, b, block=tuple(block))


def butterfly(a_re, a_im, b_re, b_im, w_re, w_im, spec: AdderSpec,
              inverse: bool = False, *, backend: str = "cuda", device=None):
    """Deprecated shim: one radix-2 butterfly stage (int32 planes)."""
    _deprecated("butterfly")
    return _engine(spec, backend, device).butterfly(
        a_re, a_im, b_re, b_im, w_re, w_im, inverse=inverse)
