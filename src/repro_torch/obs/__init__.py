"""Observability of the port: for now the named cache-stats facade
(:mod:`repro_torch.obs.caches`)."""

from repro_torch.obs.caches import cache_stats, register_lru  # noqa: F401

__all__ = ["cache_stats", "register_lru"]
