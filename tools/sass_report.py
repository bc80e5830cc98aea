#!/usr/bin/env python3
"""What nvcc made of the port's CUDA kernels: registers and spills, and
the SASS of each kernel's innermost loops.

    python3 tools/sass_report.py [--csrc DIR] [--out DIR] [--dump DIR]
        [--match REGEX] [NAME ...]

Compiles ``DIR/<NAME>.cu`` (default: ``src/repro_torch/csrc``; NAME
defaults to ``conv_chain approx_matmul``) with the flags of
``repro_torch.kernels._build`` (``-Xptxas -v`` included) into ``--out``,
disassembles the library with ``cuobjdump -sass``, and prints for every
kernel whose (demangled) name matches ``--match``: its registers and
spill bytes as ptxas reports them, its instruction count, and every
innermost loop (a backward branch whose body holds no other backward
branch) with its length and the count of the instructions that matter
here: tensor-core products (``IMMA``/``HMMA``), ``dp4a`` (``IDP``),
shared loads and stores, global stores, local memory (``LDL``/``STL``,
i.e. spills or arrays indexed at run time), indirect branches (``BRX``,
a runtime switch) and ``MUFU.RCP`` (the reciprocal at the heart of an
integer division).  Point ``--csrc`` at another checkout's sources to
compare two versions; ``--dump DIR`` also writes each matched kernel's
SASS to ``DIR``.  Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit); no
GPU.
"""

import argparse
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

#: Opcode prefixes counted in each loop.
WATCH = ("IMMA", "HMMA", "IDP", "LDS", "STS", "LDSM", "LDGSTS", "STG",
         "LDL", "STL", "BRX", "MUFU.RCP")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def _tool(name):
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not pathlib.Path(path).exists():
        sys.exit(f"sass_report: {name} not found")
    return path


def _demangle(names):
    cxxfilt = shutil.which("c++filt")
    if not cxxfilt or not names:
        return dict(zip(names, names))
    res = subprocess.run([cxxfilt], input="\n".join(names),
                         capture_output=True, text=True)
    return dict(zip(names, res.stdout.splitlines()))


def _functions(sass):
    """{mangled name: [(offset, opcode, operands)]} from cuobjdump -sass."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def _count(insns):
    out = {}
    for _, op, _ in insns:
        for w in WATCH:
            if op == w or op.startswith(w + "."):
                out[w] = out.get(w, 0) + 1
    return out


def _innermost_loops(insns):
    """(start, end, body) for each backward branch with no backward branch
    strictly inside its body."""
    loops = []
    for i, (off, op, args) in enumerate(insns):
        if not op.startswith("BRA"):
            continue
        m = _TARGET.search(args)
        if not m or int(m.group(1), 16) >= off:
            continue
        tgt = int(m.group(1), 16)
        body = [x for x in insns if tgt <= x[0] <= off]
        loops.append((tgt, off, body))
    inner = []
    for tgt, off, body in loops:
        if not any(t2 >= tgt and o2 < off and (t2, o2) != (tgt, off)
                   for t2, o2, _ in loops):
            inner.append((tgt, off, body))
    return inner


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*",
                    default=["conv_chain", "approx_matmul"])
    ap.add_argument("--csrc", default=str(_build.CSRC))
    ap.add_argument("--out", default=str(ROOT / "build" / "sass_report"))
    ap.add_argument("--dump", default=None,
                    help="write each matched kernel's SASS here")
    ap.add_argument("--match", default=".",
                    help="regex on the demangled kernel name")
    args = ap.parse_args()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    nvcc, cuobjdump = _tool("nvcc"), _tool("cuobjdump")
    tag = re.sub(r"\W+", "_", str(pathlib.Path(args.csrc).resolve()))[-40:]
    for name in args.names:
        lib = out / f"lib{name}-{tag}.so"
        res = subprocess.run(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib),
             str(pathlib.Path(args.csrc) / f"{name}.cu")],
            capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{res.stdout}{res.stderr}")
        ptxas = {}
        fn = None
        for line in (res.stdout + res.stderr).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            if fn and ("registers" in line or "spill" in line):
                ptxas.setdefault(fn, []).append(line.split("ptxas info")[-1]
                                                .strip(" :"))
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True, check=True)
        funcs = _functions(sass.stdout)
        blocks = re.split(r"(?=\n\s*Function : )", sass.stdout)
        names = _demangle(sorted(funcs))
        print(f"== {name}.cu from {args.csrc}")
        for mangled in sorted(funcs, key=lambda n: names[n]):
            pretty = names[mangled]
            if not re.search(args.match, pretty):
                continue
            insns = funcs[mangled]
            print(f"-- {pretty}")
            if args.dump:
                dump = pathlib.Path(args.dump)
                dump.mkdir(parents=True, exist_ok=True)
                text = next(b for b in blocks if f"Function : {mangled}\n"
                            in b + "\n")
                (dump / f"{name}-{tag[-12:]}-{mangled[:120]}.sass"
                 ).write_text(text)
            for line in ptxas.get(mangled, []):
                print(f"   ptxas: {line}")
            print(f"   {len(insns)} instructions; {_count(insns)}")
            for tgt, off, body in _innermost_loops(insns):
                print(f"   inner loop 0x{tgt:04x}-0x{off:04x}: {len(body)} "
                      f"instructions; {_count(body)}")


if __name__ == "__main__":
    main()
