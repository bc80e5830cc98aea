"""``repro_torch.ax`` — the port's approximate-arithmetic engine: the
adder registry, the multiplier family (:mod:`repro_torch.ax.mul`), the
``"torch"`` and ``"cuda"`` backends, the spec-first :func:`make_engine`
handle, the compiled low-part tables (:mod:`repro_torch.ax.lut`) and the
exact error analytics (:mod:`repro_torch.ax.analytics`)."""

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
from repro_torch.ax.lut import (  # noqa: F401
    MAX_LUT_LSM_BITS,
    compile_lut,
    error_delta_table,
    lut_supported,
)
from repro_torch.ax.mul import (  # noqa: F401
    MAX_MUL_BITS,
    MAX_MUL_LUT_BITS,
    MacSpec,
    MulImpl,
    MulSpec,
    approx_mul,
    compile_mul_lut,
    default_mul_spec,
    get_multiplier,
    mul_lut_supported,
    register_multiplier,
    registered_multipliers,
    signed_mul_table,
    tap_tables,
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
from repro_torch.ax.analytics import (  # noqa: F401
    MAX_COMPOSE_BITS,
    MAX_MUL_COMPOSE_BITS,
    ErrorMoments,
    analytics_supported,
    design_space,
    exact_error_metrics,
    exact_error_metrics_sweep,
    exact_error_moments,
    exact_mul_error_metrics,
    exact_mul_error_metrics_sweep,
    mul_analytics_supported,
    mul_design_space,
)
