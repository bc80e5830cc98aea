"""Read the x86 ``rsqrtss`` approximation that XLA:CPU's fp32 ``rsqrt``
starts from, as the table ``repro_torch.models.layers`` holds.

XLA:CPU compiles ``jax.lax.rsqrt`` (the reference's ``rms_norm``) as the
hardware estimate ``vrsqrtps`` refined by two Newton steps, each two
multiplies and two FMAs (its LLVM IR and machine code, jax 0.9.0,
x86-64).  The estimate is a table: for a positive normal input it
depends only on the exponent's parity and the top 10 mantissa bits, and
the exponent scales it exactly.  This script calls the instruction
(``rsqrtss``, the same estimate) through a 5-byte function in an
executable page, checks those two properties on random inputs, and
prints the 2 x 1024 estimates for inputs in [1, 2) and [2, 4) as the hex
string ``layers.RSQRT_ESTIMATES``: each in [0.5, 1) with its low 11
mantissa bits zero, so three hex digits (the mantissa's top 12 bits).

    python tools/rsqrt_table.py            # x86-64 only

The estimate differs between processor families; the port's CPU path
follows the one XLA:CPU ran on when the reference's figures were read.
"""

from __future__ import annotations

import ctypes
import mmap
import random
import struct

# rsqrtss xmm0, xmm0; ret
CODE = bytes([0xF3, 0x0F, 0x52, 0xC0, 0xC3])


def estimate_fn():
    page = mmap.mmap(-1, mmap.PAGESIZE, prot=mmap.PROT_READ
                     | mmap.PROT_WRITE | mmap.PROT_EXEC)
    page.write(CODE)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(page))
    fn = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_float)(addr)
    return fn, page


def bits(x: float) -> int:
    return struct.unpack("<I", struct.pack("<f", x))[0]


def from_bits(b: int) -> float:
    return struct.unpack("<f", struct.pack("<I", b))[0]


def main():
    fn, page = estimate_fn()
    table = [[bits(fn(from_bits((e << 23) | (i << 13)))) for i in range(1024)]
             for e in (127, 128)]
    rng = random.Random(0)
    for _ in range(100_000):
        e, m = rng.randrange(1, 254), rng.randrange(1 << 23)
        par = (e - 127) & 1
        want = table[par][m >> 13] - (((e - 127 - par) // 2) << 23)
        got = bits(fn(from_bits((e << 23) | m)))
        if got != want:
            raise SystemExit(f"not a table of 10 bits: e={e} m={m:#x} "
                             f"{got:#x} != {want:#x}")
    flat = [b for row in table for b in row]
    if any(b >> 23 != 126 or b & 0x7FF for b in flat):
        raise SystemExit("an estimate outside [0.5, 1) or with more bits")
    text = "".join(f"{(b >> 11) & 0xFFF:03x}" for b in flat)
    for i in range(0, len(text), 72):
        print(f'    "{text[i:i + 72]}"')
    del fn
    page.close()


if __name__ == "__main__":
    main()
