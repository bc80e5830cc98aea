"""Checkpointing: atomic, integrity-checked, async-capable (the port of
``repro.checkpoint.checkpointer``, over the port's ``ioutil``).

- save(): the tree's leaves in jax's order (dict keys sorted, lists in
  order: :mod:`repro_torch.tree`), one device-to-host copy per leaf,
  each written with ``numpy.save`` (a bf16 leaf as its 16-bit pattern,
  its dtype named in the manifest); a SHA-256 per leaf file and a JSON
  manifest; written to a temporary directory, then published with an
  atomic rename; optionally on a background thread (async_save) so the
  train loop does not wait on the disk.  The host copy is taken before
  the call returns, so the caller may go on updating the state's tensors
  in place.
- restore(): verifies every hash (``IOError`` on a mismatch) and loads
  the leaves into the structure of ``like`` on the device given; with
  ``shardings`` (a tree of specs) and ``mesh`` it places each onto the
  current mesh (this rank's shard in a DTensor), which may differ from
  the saving job's: the reference's resharding restore.
- a sharded state (DTensor leaves) is saved as full leaves, as the
  reference's ``device_get`` gives them: every rank gathers each leaf
  (the call is collective) and rank 0 alone writes.
- keep policy: the newest ``keep`` checkpoints are retained.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.ioutil import atomic_replace_dir, sha256_bytes, sha256_file
from repro_torch.models.transformer import resolve_device
from repro_torch.sharding import rules as R
from repro_torch.tree import leaves, unflatten


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _to_host(t) -> np.ndarray:
    """A host copy of ``t`` (a copy on the CPU too: the caller may
    update ``t`` in place while an async save writes)."""
    t = R.full_tensor(torch.as_tensor(t)).detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy()


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def _writer(flat) -> bool:
    """Whether this process writes a state: rank 0 of a sharded state's
    process group, any process for a plain one."""
    if not any(R.is_dtensor(t) for t in flat):
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save --
    def save(self, step: int, state: Any, wait: bool = True):
        """Serialize ``state`` at ``step``.  Set wait=False for async.
        A sharded state: every rank calls it (the leaves are gathered),
        rank 0 writes."""
        self.wait()  # one in-flight async save at a time
        flat = leaves(state)
        dtypes = [str(torch.as_tensor(t).dtype).replace("torch.", "")
                  for t in flat]
        host = [_to_host(t) for t in flat]
        if not _writer(flat):
            return

        def _do():
            tmp = os.path.join(self.dir, f".tmp_step_{step}_{os.getpid()}")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "time": time.time(), "leaves": []}
            for i, (arr, dtype) in enumerate(zip(host, dtypes)):
                path = os.path.join(tmp, _leaf_name(i))
                np.save(path, arr, allow_pickle=False)
                manifest["leaves"].append(
                    {"file": _leaf_name(i), "sha256": sha256_file(path),
                     "shape": list(arr.shape), "dtype": dtype})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            atomic_replace_dir(tmp, final)  # atomic publish
            self._gc()

        if wait:
            _do()
        else:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()

    def async_save(self, step: int, state: Any):
        self.save(step, state, wait=False)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ---------------------------------------------------------- restore --
    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return max(steps) if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                device=None, shardings: Any = None, mesh=None) -> Any:
        """The checkpoint at ``step`` (the newest when ``None``) in the
        structure of ``like`` (any tree of that structure, e.g. one on the
        meta device), its tensors on ``device`` (``None``: the card; the
        mesh's device with one).  ``shardings``: a tree of specs (a
        ``None`` spec: a plain tensor), placed onto ``mesh``
        (:func:`repro_torch.sharding.rules.place`); every rank reads
        every leaf and keeps its shard."""
        dev = R.mesh_device(mesh) if mesh is not None \
            else resolve_device(device)
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_like = leaves(like)
        if len(manifest["leaves"]) != len(leaves_like):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves; "
                f"expected {len(leaves_like)}")
        out = []
        for meta in manifest["leaves"]:
            path = os.path.join(d, meta["file"])
            with open(path, "rb") as f:
                raw = f.read()
            if sha256_bytes(raw) != meta["sha256"]:
                raise IOError(f"integrity failure in {path}")
            arr = np.load(io.BytesIO(raw), allow_pickle=False)
            out.append(_from_host(arr, meta["dtype"], dev))
        tree = unflatten(like, out)
        if shardings is not None:
            tree = R.place(tree, shardings, mesh)
        return tree

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_"))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
