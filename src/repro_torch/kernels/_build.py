"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -D... -o <build>/lib<name>-<hash>.so <name>.cu

and loaded with ``ctypes``.  ``<hash>`` covers the source, the shared
headers and the flags, so an edited source is rebuilt and a stale library
is never loaded.  :func:`build_all` starts one ``nvcc`` per source at
once.

The ``-D`` flags carry the tables the kernels and their wrappers share,
so each is stated once, here: the adder kinds' ids (:data:`DEVICE_KINDS`,
the cases of ``approx_add`` in ``adders.cuh``), the multiplier kinds'
ids (:data:`MUL_DEVICE_KINDS`, the cases of ``approx_mul`` in
``muls.cuh``) and the sizes of the parameter structs (:data:`MAX_TERMS`,
:data:`MAX_STAGES`, :data:`MAX_TAPS`).

``<build>`` is ``$REPRO_TORCH_BUILD_DIR`` when that is set, else
``build/repro_torch/`` at the root of the source checkout the package
lies in (listed in ``.gitignore``); an installed copy of the package
needs ``REPRO_TORCH_BUILD_DIR``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0, so a refused launch (too many
threads, too much shared memory) is never silent.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Tuple

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
SOURCES = ("approx_add", "accumulate", "conv_chain", "lut_add", "butterfly",
           "mul", "mac_matmul", "conv2d_mac", "approx_matmul")
HEADERS = ("adders.cuh", "muls.cuh")

#: Kind -> id of its device function in ``csrc/adders.cuh``.
DEVICE_KINDS = {
    "accurate": 0, "loa": 1, "loawa": 2, "oloca": 3, "herloa": 4,
    "m_herloa": 5, "haloc_axa": 6, "eta": 7,
}
#: Multiplier kind -> id of its device function in ``csrc/muls.cuh``.
MUL_DEVICE_KINDS = {
    "accurate": 0, "truncated": 1, "broken_array": 2, "mitchell": 3,
}
#: Most terms one accumulate launch folds (its struct's weight array).
MAX_TERMS = 16
#: Most stages of one filter chain, and most taps of one stage.
MAX_STAGES, MAX_TAPS = 4, 9

DEFINES = tuple(f"-DKIND_{kind.upper()}={kid}"
                for kind, kid in DEVICE_KINDS.items()) + tuple(
    f"-DMUL_KIND_{kind.upper()}={kid}"
    for kind, kid in MUL_DEVICE_KINDS.items()) + (
    f"-DMAX_TERMS={MAX_TERMS}", f"-DMAX_STAGES={MAX_STAGES}",
    f"-DMAX_TAPS={MAX_TAPS}")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v") + DEFINES

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: nvcc's diagnostics (``-Xptxas -v``: registers, shared memory, spills)
#: from the builds of this process, by source name.
BUILD_LOGS: Dict[str, str] = {}
#: Wall seconds of each source's nvcc in :func:`build_all`, by name.
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError(
            "nvcc not found (on PATH or under /usr/local/cuda/bin): the "
            "CUDA kernels of repro_torch are built from source on first use")
    return path


def build_dir() -> pathlib.Path:
    """Where the libraries go: ``$REPRO_TORCH_BUILD_DIR``, else
    ``build/repro_torch`` in the source checkout holding the package."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    root = PACKAGE.parent.parent
    if PACKAGE.parent.name != "src" or not (root / "pyproject.toml").is_file():
        raise RuntimeError(
            f"repro_torch at {PACKAGE} is not in the src/ of a source "
            f"checkout; set REPRO_TORCH_BUILD_DIR to a directory for its "
            f"built CUDA kernels")
    return root / "build" / "repro_torch"


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for part in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / part).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (target, tmp, process) or None."""
    target = _lib_path(name)
    if target.exists():
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, started) -> None:
    target, tmp, proc = started
    out, _ = proc.communicate()
    BUILD_LOGS[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    # Atomic publish: a concurrent builder of the same hash writes the
    # same bytes, so whichever rename lands last is correct.
    os.replace(tmp, target)


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Compile every source that has no current library, one ``nvcc``
    each, all started together; returns the wall seconds taken and
    records each source's in :data:`BUILD_SECONDS`."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}

    def finish(name):
        _finish(name, started[name])
        BUILD_SECONDS[name] = time.perf_counter() - t0

    todo = [n for n, st in started.items() if st is not None]
    with ThreadPoolExecutor(max_workers=max(len(todo), 1)) as pool:
        for fut in [pool.submit(finish, n) for n in todo]:
            fut.result()
    return time.perf_counter() - t0


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_kernels(log: str) -> List[Tuple[str, int, int, int]]:
    """Each kernel of an ``-Xptxas -v`` log as (mangled name, registers,
    stack frame bytes, spill bytes stored and loaded)."""
    out, name, frame = [], None, (0, 0, 0)
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            name, frame = m.group(1), (0, 0, 0)
            continue
        m = _PTXAS_FRAME.search(line)
        if m and name:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = _PTXAS_REGS.search(line)
        if m and name:
            out.append((name, int(m.group(1)), frame[0],
                        frame[1] + frame[2]))
            name = None
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            st = _start(name)
            if st is not None:
                _finish(name, st)
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def bind(name: str, symbol: str, argtypes: Tuple) -> ctypes._CFuncPtr:
    """``symbol`` of ``csrc/<name>.cu`` with its argument types set (every
    pointer and the stream as ``c_void_p``) and an int return."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
