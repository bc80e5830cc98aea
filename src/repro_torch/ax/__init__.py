"""``repro_torch.ax`` — the port's approximate-arithmetic engine: the
adder registry, the multiplier family (:mod:`repro_torch.ax.mul`), the
``"torch"`` and ``"cuda"`` backends, and the spec-first
:func:`make_engine` handle."""

from repro_torch.ax.backends import (  # noqa: F401
    AUTO_STRATEGY,
    DEFAULT_BACKEND,
    STRATEGIES,
    Backend,
    FilterStage,
    available_backends,
    get_backend,
    register_backend,
)
from repro_torch.ax.engine import AxEngine, make_engine  # noqa: F401
from repro_torch.ax.mul import (  # noqa: F401
    MacSpec,
    MulImpl,
    MulSpec,
    default_mul_spec,
    get_multiplier,
    register_multiplier,
    registered_multipliers,
    unregister_multiplier,
)
from repro_torch.ax.registry import (  # noqa: F401
    AdderImpl,
    const_kinds,
    get_adder,
    register_adder,
    registered_kinds,
    table1_kinds,
    unregister_adder,
)
