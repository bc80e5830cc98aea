"""``repro_torch.resilience`` — fault injection, self-healing degradation
and the campaign harness (the port of ``repro.resilience``).

- :mod:`repro_torch.resilience.faults`: :class:`FaultSpec` and the
  injectors (compiled-LUT corruption via the non-cached build, output-bus
  masks, seeded counter-based transient flips).
- :mod:`repro_torch.resilience.degrade`: :class:`DegradePolicy` — drift
  trips walk the exact Pareto frontier toward the exact adder.
- :mod:`repro_torch.resilience.harness`: the fault-campaign sweep, the
  recovery cell and the integrity detection campaign (imported from the
  module, as in the reference).

Attribute access is lazy (PEP 562): ``repro_torch.ax.engine`` imports
``repro_torch.resilience.faults`` (a leaf module), while ``degrade`` and
``harness`` import the imgproc stack on top of the engine — eager
re-exports here would close that cycle.
"""

from __future__ import annotations

_EXPORTS = {
    "FaultSpec": "faults", "FAULT_KINDS": "faults",
    "apply_fault": "faults", "corrupt_lut": "faults",
    "faulted_delta_table": "faults", "faulted_mean_abs_error": "faults",
    "transient_flip_mask": "faults", "validate_fault": "faults",
    "DegradePolicy": "degrade", "pareto_ladder": "degrade",
    "CampaignCell": "harness", "run_campaign": "harness",
    "recovery_cell": "harness", "default_campaign_faults": "harness",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def __dir__():
    return __all__
