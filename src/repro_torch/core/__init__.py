"""The paper's adder family: specs and bit-exact behavioural models
(the port's own copies of ``repro.core.specs`` and ``repro.core.adders``)."""

from repro_torch.core.specs import (  # noqa: F401
    ACCURATE,
    ETA,
    HALOC_AXA,
    HERLOA,
    LOA,
    LOAWA,
    M_HERLOA,
    OLOCA,
    AdderSpec,
    paper_spec,
    table1_specs,
)
from repro_torch.core.adders import (  # noqa: F401
    approx_add,
    approx_add_mod,
    lsm_error_bound,
)

_REGISTRY_DERIVED = ("ALL_KINDS", "TABLE1_KINDS", "CONST_KINDS")


def __getattr__(name: str):
    if name in _REGISTRY_DERIVED:
        from repro_torch.core import specs
        return getattr(specs, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
