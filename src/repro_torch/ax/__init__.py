"""``repro_torch.ax`` — the port's approximate-arithmetic engine: the
adder registry, the ``"torch"`` and ``"cuda"`` backends, and the
spec-first :func:`make_engine` handle."""

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
from repro_torch.ax.registry import (  # noqa: F401
    AdderImpl,
    const_kinds,
    get_adder,
    register_adder,
    registered_kinds,
    table1_kinds,
    unregister_adder,
)
