"""The compile-time adders of ``csrc/adders.cuh`` (``Adder<KIND, FUSED>``,
built by ``with_adder`` with hoisted masks) against the runtime
``approx_add_mod`` of the same header, bit for bit.

The header is plain C++ apart from CUDA's function qualifiers, so the
host's C++ compiler builds it here with a stub ``cuda_runtime.h``: every
kind, both forms, every valid (m, k), exhaustive at N=8 and on seeded
random pairs (plus the all-ones and zero corners) at N=16, 31 and 32,
where m = 32 exercises the "shift by 32 gives 0" rule through the masks.
The kernels that use the functors (``conv_chain.cu``, ``approx_matmul.cu``)
are held against their plain versions on the card.  Skips when no C++
compiler is found.
"""

import os
import shutil
import subprocess

import pytest

from repro_torch.kernels import _build

STUB = """#pragma once
#define __device__
#define __host__
#define __forceinline__ inline
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
"""

CHECK = r"""
#include <cstdio>
#include <cstdlib>
#include <random>
#include "adders.cuh"
using namespace repro_torch;

static long long fails = 0, checks = 0;

struct Cmp {
  uint32_t a, b, want;
  template <class A> int operator()(const A& add) {
    ++checks;
    if (add(a, b) != want) ++fails;
    return 0;
  }
};

static bool valid(int kind, int m, int k) {
  if (kind == KIND_HERLOA || kind == KIND_M_HERLOA || kind == KIND_HALOC_AXA) {
    if (m < 2) return false;
    if ((kind == KIND_M_HERLOA || kind == KIND_HALOC_AXA) && k > m - 2)
      return false;
  }
  return k <= m;
}

int main(int argc, char** argv) {
  const int n = atoi(argv[1]);
  std::mt19937_64 rng(n);
  const uint32_t nm = n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
  for (int kind = 0; kind < N_KINDS; ++kind)
    for (int m = 1; m <= n; ++m)
      for (int k = 0; k <= m; ++k) {
        if (!valid(kind, m, k)) continue;
        for (int fast = 0; fast < 2; ++fast) {
          const AdderParams p = make_adder(kind, n, m, k, fast);
          auto run = [&](uint32_t a, uint32_t b) {
            Cmp c{a, b, approx_add_mod(a, b, p)};
            if (with_adder(p, c) != 0) ++fails;
          };
          if (n <= 8) {
            for (uint32_t a = 0; a <= nm; ++a)
              for (uint32_t b = 0; b <= nm; ++b) run(a, b);
          } else {
            for (int i = 0; i < 2000; ++i) run(rng() & nm, rng() & nm);
            run(nm, nm);
            run(0, 0);
            run(nm, 1);
          }
        }
      }
  printf("%lld %lld\n", checks, fails);
  return fails != 0;
}
"""


@pytest.fixture(scope="module")
def checker(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    d = tmp_path_factory.mktemp("adders_cuh")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "check.cpp").write_text(CHECK)
    exe = d / "check"
    defines = [f for f in _build.DEFINES if f.startswith("-DKIND_")
               or f.startswith("-DMAX_")]
    defines.append(f"-DN_KINDS={len(_build.DEVICE_KINDS)}")
    subprocess.run([cxx, "-std=c++17", "-O2", f"-I{d}",
                    f"-I{_build.CSRC}", *defines, "-o", str(exe),
                    str(d / "check.cpp")], check=True, capture_output=True)
    return exe


@pytest.mark.parametrize("n_bits", [8, 16, 31, 32])
def test_compile_time_adders_equal_runtime_adder(checker, n_bits):
    assert sorted(_build.DEVICE_KINDS.values()) == list(
        range(len(_build.DEVICE_KINDS)))
    res = subprocess.run([str(checker), str(n_bits)], capture_output=True,
                         text=True, env=dict(os.environ))
    checks, fails = map(int, res.stdout.split())
    assert res.returncode == 0 and fails == 0, (checks, fails)
    assert checks > 0
