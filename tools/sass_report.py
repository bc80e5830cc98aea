#!/usr/bin/env python3
"""What nvcc made of the port's CUDA kernels: registers and spills, and
the SASS of each kernel's innermost loops.

    python3 tools/sass_report.py [--csrc DIR] [--out DIR] [--dump DIR]
        [--match REGEX] [NAME ...]

Compiles ``DIR/<NAME>.cu`` (default: ``src/repro_torch/csrc``; NAME
defaults to the four kernels on the compile-time adder: ``accumulate
conv_chain conv2d_mac approx_matmul``) with the flags of
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
integer division).  A kernel whose unrolled work follows a barrier in a
loop (``conv2d_mac``'s tile loop) also gets that stretch, from the last
``BAR`` in the loop to its back branch.  Per unit of work: the
``accumulate`` kernel's innermost loop per element (its VEC outputs a
thread, from the template arguments), ``conv2d_mac``'s stretch per pixel
(ROWS a thread) and its shared loads per tap; their versions on the
runtime adder (before the templates) get the shortest loop holding one
term's or tap's load.  Point ``--csrc`` at
another checkout's sources to compare two versions; ``--dump DIR`` also
writes each matched kernel's SASS to ``DIR``.  Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit); no GPU.
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
WATCH = ("IMMA", "HMMA", "IDP", "LDS", "STS", "LDSM", "LDGSTS", "LDG", "STG",
         "LDL", "STL", "BRX", "MUFU.RCP", "BAR")
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


def _after_last_barrier(insns):
    """The stretch from the last BAR of the outermost loop holding one to
    that loop's back branch (a loop whose barrier-separated phases end in
    unrolled work), or None."""
    best = None
    for i, (off, op, args) in enumerate(insns):
        m = _TARGET.search(args)
        if not op.startswith("BRA") or not m or int(m.group(1), 16) >= off:
            continue
        body = [x for x in insns if int(m.group(1), 16) <= x[0] <= off]
        bars = [j for j, x in enumerate(body) if x[1].startswith("BAR")]
        if bars and (best is None or len(body) > best[0]):
            best = (len(body), body[bars[-1] + 1:])
    return None if best is None else best[1]


def _smallest_loop_with(insns, ops, without=("STS",)):
    """The shortest loop (backward branch to its target) whose body holds
    one of ``ops`` and none of ``without``, or None: a kernel's per-tap or
    per-term loop when its adder's own loops (a runtime switch) sit
    inside it (a staging loop, with its STS, is not it)."""
    best = None
    for off, op, args in insns:
        m = _TARGET.search(args)
        if not op.startswith("BRA") or not m or int(m.group(1), 16) >= off:
            continue
        body = [x for x in insns if int(m.group(1), 16) <= x[0] <= off]
        kinds = {x[1].split(".")[0] for x in body}
        if kinds & set(ops) and not kinds & set(without) and (
                best is None or len(body) < len(best)):
            best = body
    return best


def _template_ints(pretty, kernel):
    """The integer template arguments after the adder of ``kernel<...>``
    in a demangled name."""
    m = re.search(re.escape(kernel) + r"<.*?Adder<\d+, \w+>((?:, \w+)*)>",
                  pretty)
    if not m:
        return []
    return [int(a) for a in m.group(1).split(", ")[1:] if a.isdigit()]


def _units(name, pretty, insns, csrc):
    """Per element or pixel counts of the kernels this tool knows."""
    out = []
    if "accumulate_kernel<" in pretty:
        kt_vec = _template_ints(pretty, "accumulate_kernel")
        loops = [b for _, _, b in _innermost_loops(insns)
                 if _count(b).get("STG")]
        if kt_vec and loops:
            vec = kt_vec[-1]
            body = loops[-1]
            out.append(f"per element (K instance {kt_vec[0]}, {vec} a "
                       f"thread): {len(body) / vec:.1f} instructions, "
                       f"{ {k: v / vec for k, v in _count(body).items()} }")
    if "conv2d_mac_kernel<" in pretty:
        kh_kw = _template_ints(pretty, "conv2d_mac_kernel")
        hot = _after_last_barrier(insns)
        src = (pathlib.Path(csrc) / f"{name}.cu").read_text()
        rows = re.search(r"constexpr int ROWS = (\d+);", src)
        if kh_kw and kh_kw[0] and hot and rows:
            rows, taps = int(rows.group(1)), kh_kw[0] * kh_kw[1]
            c = _count(hot)
            out.append(f"after the tile loop's last barrier: {len(hot)} "
                       f"instructions for {rows} pixels a thread = "
                       f"{len(hot) / rows:.1f} a pixel; LDS a tap "
                       f"{c.get('LDS', 0) / (rows * taps):.2f}, BRX "
                       f"{c.get('BRX', 0)}, STL {c.get('STL', 0)}, LDL "
                       f"{c.get('LDL', 0)}")
    if re.search(r"\b(accumulate_vec4|accumulate_scalar|"
                 r"conv2d_mac_kernel<(true|false)>)", pretty):
        loop = _smallest_loop_with(insns, ("LDS", "LDG"))
        if loop:
            out.append(f"loop of one term or tap (the runtime adder's "
                       f"switch inside, every kind's path): {len(loop)} "
                       f"instructions; {_count(loop)}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*",
                    default=["accumulate", "conv_chain", "conv2d_mac",
                             "approx_matmul"])
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
        ptxas = {k[0]: k[1:] for k in _build.ptxas_kernels(res.stdout
                                                            + res.stderr)}
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
            if mangled in ptxas:
                regs, stack, spill = ptxas[mangled]
                print(f"   ptxas: {regs} registers, {stack} bytes stack "
                      f"frame, {spill} bytes spilled")
            print(f"   {len(insns)} instructions; {_count(insns)}")
            for tgt, off, body in _innermost_loops(insns):
                print(f"   inner loop 0x{tgt:04x}-0x{off:04x}: {len(body)} "
                      f"instructions; {_count(body)}")
            for line in _units(name, pretty, insns, args.csrc):
                print(f"   {line}")


if __name__ == "__main__":
    main()
