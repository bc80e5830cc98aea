"""Approximate multiplier family of the port: registry, specs, product
tables and the MAC composition types (the port of ``repro.ax.mul``).

Mirrors the adder stack one level down: ``repro_torch.ax.mul`` is to
multipliers what ``repro_torch.ax`` (registry/lut) is to adders.  See
:mod:`repro_torch.ax.mul.impls` for the builtin kinds.
"""

from repro_torch.ax.mul.impls import approx_mul  # noqa: F401
from repro_torch.ax.mul.lut import (  # noqa: F401
    MAX_MUL_LUT_BITS,
    compile_mul_lut,
    device_mul_table,
    device_signed_table,
    device_tap_tables,
    mul_lut_index,
    mul_lut_supported,
    signed_mul_table,
    tap_tables,
)
from repro_torch.ax.mul.registry import (  # noqa: F401
    MulImpl,
    get_multiplier,
    register_multiplier,
    registered_multipliers,
    unregister_multiplier,
)
from repro_torch.ax.mul.specs import (  # noqa: F401
    MAX_MUL_BITS,
    MacSpec,
    MulSpec,
    default_mul_spec,
)

__all__ = [
    "MAX_MUL_BITS",
    "MAX_MUL_LUT_BITS",
    "MacSpec",
    "MulImpl",
    "MulSpec",
    "approx_mul",
    "compile_mul_lut",
    "default_mul_spec",
    "device_mul_table",
    "device_signed_table",
    "device_tap_tables",
    "get_multiplier",
    "mul_lut_index",
    "mul_lut_supported",
    "register_multiplier",
    "registered_multipliers",
    "signed_mul_table",
    "tap_tables",
    "unregister_multiplier",
]
