"""Shared durable-I/O primitives: SHA-256 digests + atomic publishes
(the port's copy of ``repro.ioutil``).

The compile cache (:mod:`repro_torch.integrity.store`) persists binary
artifacts with an integrity manifest, with the discipline the
reference's checkpointer shares:

- **Hash the bytes on disk**, not the in-memory object: the digest
  covers exactly what a later reader will see, including serialization
  headers, so any truncation or bit rot fails the compare.
- **Write to a temporary name, then rename**: ``os.rename``/
  ``os.replace`` within a directory is atomic on POSIX, so a reader
  never observes a half-written file — after a crash the final name
  either holds the complete old content or the complete new content.
"""

from __future__ import annotations

import hashlib
import os
import shutil


def sha256_bytes(data: bytes) -> str:
    """Hex SHA-256 of ``data``."""
    return hashlib.sha256(data).hexdigest()


def sha256_file(path: str) -> str:
    """Hex SHA-256 of the file's current on-disk bytes."""
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Publish ``data`` at ``path`` atomically (tmp write + replace).

    The temporary lives in the target's directory so the final
    ``os.replace`` never crosses a filesystem boundary; ``fsync``
    before the rename orders the data ahead of the publish."""
    d = os.path.dirname(path) or "."
    tmp = os.path.join(d, f".tmp_{os.getpid()}_{os.path.basename(path)}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_replace_dir(tmp: str, final: str) -> None:
    """Atomically publish a fully-written staging directory at
    ``final`` (removing any previous version first) — the
    checkpointer's publish step."""
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
