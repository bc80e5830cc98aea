"""Crash-safe persistent compile cache for LUT artifacts (the port of
``repro.integrity.store``).

Compiling the wide tables (an m=12 adder table is 32 MiB of reference-
implementation evaluation; a 10-bit signed MAC table is a 1M-entry
build) is pure compute — a warm serving process should never redo it
after a restart.  :class:`PersistentCache` stores compiled tables on
disk with the reference checkpointer's discipline (shared helpers in
:mod:`repro_torch.ioutil`):

- every entry is an ``.npy`` file published by atomic tmp-write +
  rename, so an unclean shutdown can never leave a half-written entry
  under its final name;
- a ``manifest.json`` (also atomically replaced) records a SHA-256 per
  entry, hashed over the on-disk bytes; a load re-hashes and treats ANY
  mismatch — truncation, bit rot, a manifest/file tear from a crash
  between the two writes — as a miss: the entry is deleted and the
  table silently recompiled.  A corrupted entry is **never served**.
- entry keys hash the canonical spec repr together with the torch, CUDA
  and format versions, so an upgrade naturally cold-misses instead of
  serving stale artifacts.

Activation is OFF by default: nothing touches the disk unless
:func:`activate` is called or the :data:`CACHE_ENV` environment
variable names a directory.  The variable is the port's own
(``REPRO_TORCH_CACHE_DIR``, beside ``REPRO_TORCH_BUILD_DIR``), so one
setting never activates both packages' caches.  The table compilers consult
:func:`cache_get`/:func:`cache_put`, which are no-ops while inactive.
"""

from __future__ import annotations

import io
import json
import os
from typing import Dict, Optional

import numpy as np

from repro_torch.ioutil import atomic_write_bytes, sha256_bytes
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _obs

__all__ = ["CACHE_ENV", "PersistentCache", "activate", "deactivate",
           "active_cache", "cache_get", "cache_put"]

#: Environment variable that activates the persistent cache: set it to
#: a directory path before the first table compile.
CACHE_ENV = "REPRO_TORCH_CACHE_DIR"

#: Bumped when the on-disk entry format changes (keys include it, so a
#: format change cold-misses instead of misreading old entries).
_FORMAT_VERSION = 1


def _version_salt() -> str:
    import torch
    return (f"torch={torch.__version__}|cuda={torch.version.cuda}"
            f"|fmt={_FORMAT_VERSION}")


class PersistentCache:
    """SHA-256-manifested, atomically-published array cache.

    Args:
      directory: cache root (created on first use).
      salt: extra key material (tests use it to simulate version skew).
    """

    def __init__(self, directory: str, *, salt: str = ""):
        self.dir = directory
        self.salt = salt
        self.hits = 0
        self.misses = 0
        self.corrupt = 0
        os.makedirs(directory, exist_ok=True)

    # -------------------------------------------------------- manifest --

    @property
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "manifest.json")

    def _read_manifest(self) -> Dict[str, Dict]:
        try:
            with open(self._manifest_path) as f:
                manifest = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {}
        return manifest if isinstance(manifest, dict) else {}

    def _write_manifest(self, manifest: Dict[str, Dict]) -> None:
        atomic_write_bytes(self._manifest_path,
                           json.dumps(manifest, indent=1).encode())

    # ------------------------------------------------------------ keys --

    def key(self, namespace: str, key_obj) -> str:
        """Content-addressed entry name: a SHA-256 over the namespace,
        the canonical key repr, and the version salt."""
        material = f"{namespace}|{key_obj!r}|{_version_salt()}|{self.salt}"
        return sha256_bytes(material.encode())

    def _entry_path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.npy")

    # ------------------------------------------------------------- api --

    def get(self, namespace: str, key_obj) -> Optional[np.ndarray]:
        """The cached table, or ``None`` on miss OR on any integrity
        failure (the corrupted entry is dropped so the recompiled
        replacement can be re-published)."""
        key = self.key(namespace, key_obj)
        path = self._entry_path(key)
        meta = self._read_manifest().get(key)
        if meta is None or not os.path.exists(path):
            self.misses += 1
            if _obs._ENABLED:
                _metrics.counter("integrity.cache_misses").inc()
            return None
        with open(path, "rb") as f:
            raw = f.read()
        if sha256_bytes(raw) != meta.get("sha256"):
            self._drop(key)
            return None
        try:
            table = np.load(io.BytesIO(raw), allow_pickle=False)
        except Exception:
            self._drop(key)
            return None
        table.flags.writeable = False
        self.hits += 1
        if _obs._ENABLED:
            _metrics.counter("integrity.cache_hits").inc()
        return table

    def put(self, namespace: str, key_obj, table: np.ndarray) -> str:
        """Publish ``table`` atomically; returns the entry path."""
        key = self.key(namespace, key_obj)
        path = self._entry_path(key)
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(table), allow_pickle=False)
        raw = buf.getvalue()
        atomic_write_bytes(path, raw)
        manifest = self._read_manifest()
        manifest[key] = {
            "file": os.path.basename(path),
            "sha256": sha256_bytes(raw),
            "namespace": namespace,
            "key": repr(key_obj),
            "version": _version_salt() + self.salt,
        }
        self._write_manifest(manifest)
        return path

    def get_or_build(self, namespace: str, key_obj, build) -> np.ndarray:
        """Load-or-compile: a verified hit is returned as-is; a miss
        (or corrupt entry) runs ``build()`` and publishes the result."""
        table = self.get(namespace, key_obj)
        if table is not None:
            return table
        table = build()
        self.put(namespace, key_obj, table)
        return table

    def _drop(self, key: str) -> None:
        """A detected-corrupt entry: count it, delete it, forget it."""
        self.corrupt += 1
        self.misses += 1
        if _obs._ENABLED:
            _metrics.counter("integrity.cache_corrupt").inc()
        try:
            os.remove(self._entry_path(key))
        except OSError:
            pass
        manifest = self._read_manifest()
        if manifest.pop(key, None) is not None:
            self._write_manifest(manifest)

    def __repr__(self) -> str:
        return (f"PersistentCache({self.dir!r}, hits={self.hits}, "
                f"misses={self.misses}, corrupt={self.corrupt})")


# -------------------------------------------------- module activation --

_ACTIVE: Optional[PersistentCache] = None
_ENV_CHECKED = False


def activate(directory: Optional[str] = None) -> PersistentCache:
    """Turn the persistent cache on for this process (``directory``
    defaults to the :data:`CACHE_ENV` value, which must then be set)."""
    global _ACTIVE, _ENV_CHECKED
    if directory is None:
        directory = os.environ.get(CACHE_ENV)
        if not directory:
            raise ValueError(
                f"activate() needs a directory (or set ${CACHE_ENV})")
    _ACTIVE = PersistentCache(directory)
    _ENV_CHECKED = True
    return _ACTIVE


def deactivate() -> None:
    """Back to the default: compiles stay in-process only."""
    global _ACTIVE, _ENV_CHECKED
    _ACTIVE = None
    _ENV_CHECKED = True


def active_cache() -> Optional[PersistentCache]:
    """The process-wide cache, or ``None`` when off (the default).
    The environment activation path is checked once, lazily."""
    global _ACTIVE, _ENV_CHECKED
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        directory = os.environ.get(CACHE_ENV)
        if directory:
            _ACTIVE = PersistentCache(directory)
    return _ACTIVE


def cache_get(namespace: str, key_obj) -> Optional[np.ndarray]:
    """No-op returning ``None`` unless a cache is active."""
    cache = active_cache()
    return None if cache is None else cache.get(namespace, key_obj)


def cache_put(namespace: str, key_obj, table: np.ndarray) -> None:
    """No-op unless a cache is active."""
    cache = active_cache()
    if cache is not None:
        cache.put(namespace, key_obj, table)
