"""Shared neural-net layers: norms, RoPE, attention paths, MLPs (the port
of ``repro.models.layers``), with the derivatives jax gives them.

Conventions (the reference's)
-----------------------------
- Parameters are plain nested dicts of tensors; compute is bf16 with
  fp32 softmax/norm internals.  ``dense`` casts its weight to the
  activation's dtype on every call, so weights held in bf16 give the
  same result as fp32 ones.
- Attention uses materialized GQA (KV heads repeated to Q heads at use
  time, interleaved as ``jnp.repeat`` does).
- Three attention paths:
    * plain     — scores materialized; small Sq*Skv or decode.
    * chunked   — online softmax over KV chunks (memory-bounded path for
                  long prefill); KV is padded to the chunk with position
                  -1 (masked).
    * local     — sliding-window attention via the two-block trick:
                  O(S * 2W), used by windowed layers at prefill.
- Masks are computed from ABSOLUTE positions (qpos/kvpos tensors), which
  makes ring-buffer decode caches and padding uniform everywhere.

Every function here differentiates as the reference's does under
``jax.grad``: the emulations of XLA:CPU's arithmetic (the ordered
products, ``exp``, ``log1p``, ``tanh``, the fused multiply-adds) are
``torch.autograd.Function``s whose backward is jax's derivative rule,
and the chunked attention carries the reference's flash VJP (recompute
the probabilities per KV chunk from the saved log-sum-exp).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

NEG_INF = -1e30


# ------------------------------------------------------------------ dense
#
# XLA:CPU takes a bf16 product as convert, an fp32 ``dot``, convert.  Each
# product of two bf16 values is exact in fp32, so the fp32 result depends
# only on the order in which the dot adds the K products.  That order
# depends on the shape (M, K, N) of each 2-D slice of the dot and on how
# its operands lie in memory: the library takes another micro-kernel for
# few rows, for one row or column (a matrix-vector product), for an
# operand whose contracting dim is not the one the kernel expects, and
# another accumulator layout for each width of the last column tile.
# ``tools/xla_dot_order.py`` sweeps it (jax 0.9.0, x86-64 with AVX-512).
# With c chains meaning that chain j adds the products k = j, j + c, ...
# below the last multiple of c from zero in turn, the chains summed as
# ((c0 + c1) + (c2 + c3)) + ..., and the last K mod c products summed on
# their own from zero and added last:
#
# - lhs [M, K] and rhs [K, N] (each contracting dim where a row-major
#   product has it):
#   - M > 50: by the width r = (N - 1) % 64 + 1 of the last 64-column
#     tile: one chain for r > 48; two for 24 < r <= 32, and for
#     16 < r <= 24 past one tile; within one tile (N <= 64) for
#     16 < r <= 24 two when K mod 4 is 1 or 2, else four, and for
#     32 < r <= 48 one at K = 9, else four; four otherwise.  Past one
#     tile, with t = (N - 1) // 64 full tiles and K >= 5 not a multiple
#     of 4, the library takes another order (:func:`_other_order`);
#   - 1 < M <= 50: four chains for N <= 16 (one for N = 16 at K = 9, 10,
#     13 or 17); else one chain over each K block of floor(32768 / N)
#     products, the blocks' sums added in turn;
#   - M == 1: one chain;
# - rhs held as [N, K] (``rhs_t``), M > 1: the chains of M > 50;
# - lhs held as [K, M] (``lhs_t``): one chain;
# - N == 1 with lhs [M, K], or M == 1 with rhs held as [N, K] (a
#   matrix-vector product): eight chains.
#
# Outside the sweep's grid the product is torch's fp32 GEMM, rounded once
# (ROADMAP Queue C 1): K > XLA_ORDER_MAX_K (XLA_ORDER_WIDE_K for the
# M > 50 chains of the swept sizes); 1 < M <= 50 with K >= 128 and
# N > 508, where the library splits N between threads; and the products
# of the M > 50 chains that :func:`_other_order` picks out (one chain or
# two in place of four, one in place of two, by K and t).  The callers
# below hold their operands as the reference's compiled steps hold them
# (``lhs_t``/``rhs_t``; the products' orientation is XLA's).

#: The largest K the sweep covered; for the chains of more than 50 rows
#: (lhs [M, K], rhs held either way, 1 < N) it covered K up to
#: XLA_ORDER_WIDE_K (the smoke configs' backward products over tokens and
#: over the vocabulary) at M up to XLA_ORDER_WIDE_MN and N up to twice
#: that.
XLA_ORDER_MAX_K = 256
XLA_ORDER_WIDE_K = 512
XLA_ORDER_WIDE_MN = 512


def _other_order(r: int, t: int, k: int) -> bool:
    """Whether a product of the M > 50 chains past one column tile (last
    tile r columns wide, t full tiles) takes an order other than its
    width's.  Read from ``tools/xla_dot_order.py --check`` at K = 3-73
    and t = 1-12 (N <= 832) and at 350 random shapes up to K = 130 and
    N = 1300: where these bounds hold the library never takes the
    width's order, elsewhere it always does."""
    m = k % 4
    if r > 48 or m == 0 or k < 5:
        return False
    if 16 < r <= 32:
        return m % 2 == 1 and k <= 2 * t + 1
    if r <= 16:
        return k <= 8 * t + 2 if m in (1, 2) else 3 * k <= 4 * t + 1
    return k <= (4 - m) * (4 * t + 3)


def _chains_by_width(n: int, k: int):
    """The chains of the M > 50 class (None: another order)."""
    r = (n - 1) % 64 + 1
    if n > 64 and _other_order(r, (n - 1) // 64, k):
        return None
    if r > 48:
        return 1
    if 24 < r <= 32:
        return 2
    if 16 < r <= 24:
        return 2 if n > 64 or k % 4 in (1, 2) else 4
    if 32 < r and n <= 64 and k == 9:
        return 1
    return 4


def xla_cpu_dot_order(m: int, k: int, n: int, *, lhs_t: bool = False,
                      rhs_t: bool = False):
    """(chains, K block) of XLA:CPU's fp32 dot of one (m, k) @ (k, n)
    slice held as the flags say, or None outside the swept grid."""
    wide = 50 < m <= XLA_ORDER_WIDE_MN and 1 < n <= 2 * XLA_ORDER_WIDE_MN \
        and not lhs_t
    if k > (XLA_ORDER_WIDE_K if wide else XLA_ORDER_MAX_K):
        return None
    if (n == 1 and m > 1 and not lhs_t) or (m == 1 and n > 1 and rhs_t):
        return 8, k
    if m == 1 or lhs_t:
        return 1, k
    if rhs_t or m > 50:
        chains = _chains_by_width(n, k)
        return None if chains is None else (chains, k)
    if n <= 16:
        return (1 if n == 16 and k in (9, 10, 13, 17) else 4), k
    if k >= 128 and n > 508:
        return None
    return 1, max(1, 32768 // n)


def _chains(a: Tensor, b: Tensor, lo: int, hi: int, c: int,
            fused: bool = False) -> Tensor:
    """sum_k a[..., :, k] b[..., k, :] over [lo, hi) in ``c`` chains (in
    place: the same roundings, without a new tensor a product); ``fused``:
    each product and add one FMA rounding (operands whose products fp32
    does not hold exactly)."""
    body = hi - (hi - lo) % c
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-2] + (1,)) + (
        b.shape[-1],)
    prod = torch.empty(shape, dtype=torch.float32, device=a.device)

    def chain(start, stop, step):
        acc = torch.zeros(shape, dtype=torch.float32, device=a.device)
        for j in range(start, stop, step):
            if fused:
                acc = _fma32(a[..., :, j:j + 1].expand(shape),
                             b[..., j:j + 1, :].expand(shape), acc)
                continue
            torch.mul(a[..., :, j:j + 1], b[..., j:j + 1, :], out=prod)
            acc.add_(prod)
        return acc

    accs = [chain(j0, body, c) for j0 in range(lo, lo + c)]
    while len(accs) > 1:
        accs = [accs[i].add_(accs[i + 1]) for i in range(0, len(accs), 2)]
    return accs[0].add_(chain(body, hi, 1)) if body < hi else accs[0]


def _ordered_dot(a: Tensor, b: Tensor, lhs_t: bool, rhs_t: bool, *,
                 fused: bool = False, order=None) -> Tensor:
    """``a @ b`` in fp32 in XLA:CPU's order (``order``, else
    :func:`xla_cpu_dot_order`'s); ``fused``: FMA chains (:func:`_chains`)."""
    a, b = a.float(), b.float()
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if order is None:
        order = xla_cpu_dot_order(m, k, n, lhs_t=lhs_t, rhs_t=rhs_t)
    if order is None:
        return a @ b
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    per = max(1, CPU_CHUNK // (m * n))
    if math.prod(lead) <= per:
        return _ordered_slices(a, b, order, fused)
    # a few slices at a time, so that their accumulators stay in the cache
    # (each output is its own sum: the same roundings in any grouping)
    a = a.expand(*lead, m, k).reshape(-1, m, k)
    b = b.expand(*lead, k, n).reshape(-1, k, n)
    return torch.cat([_ordered_slices(x, y, order, fused) for x, y in
                      zip(a.split(per), b.split(per))]).reshape(*lead, m, n)


def _ordered_slices(a: Tensor, b: Tensor, order, fused: bool) -> Tensor:
    chains, block = order
    k = a.shape[-1]
    out = None
    for lo in range(0, k, block):
        part = _chains(a, b, lo, min(k, lo + block), chains, fused)
        out = part if out is None else out + part
    return out


def _t(x: Tensor) -> Tensor:
    return x.transpose(-1, -2)


#: The backward of an ordered product ``out = a @ b`` in the layouts the
#: reference's compiled train step gives it (``tools/xla_dot_order.py
#: --hlo``), by the product's role: (a's gradient, b's gradient) from
#: (a, b, g).  A dense layer (``x @ w``): ``g @ w^T`` with w held as it
#: lies, [N, K] (``rhs_t``), and ``x^T @ g`` with x^T materialized.  The
#: attention scores (``q @ k^T``): dq = ``g @ k`` as k lies, dk =
#: ``g^T @ q`` with g held as it lies, [K, M] (``lhs_t``).  The attention
#: mix (``v^T @ p^T``, p held as [q, k]): ``g @ p`` and ``v @ g``.
_BACKWARD = {
    "dense": (lambda a, b, g: _ordered_dot(g, _t(b), False, True),
              lambda a, b, g: _ordered_dot(_t(a), g, False, False)),
    "scores": (lambda a, b, g: _ordered_dot(g, _t(b), False, False),
               lambda a, b, g: _t(_ordered_dot(_t(g), a, True, False))),
    "mix": (lambda a, b, g: _ordered_dot(g, _t(b), False, False),
            lambda a, b, g: _ordered_dot(_t(a), g, False, False)),
}


class _CpuDot(torch.autograd.Function):
    """The ordered product with the two transposed products as its
    backward (:data:`_BACKWARD`).  Each gradient is summed over broadcast
    dims and cast to its input's dtype by autograd, as jax rounds a bf16
    product's cotangent."""

    @staticmethod
    def forward(ctx, a, b, lhs_t, rhs_t, role):
        ctx.save_for_backward(a, b)
        ctx.role = role
        return _ordered_dot(a, b, lhs_t, rhs_t)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        rule_a, rule_b = _BACKWARD[ctx.role]
        ga = rule_a(a, b, g).sum_to_size(a.shape) \
            if ctx.needs_input_grad[0] else None
        gb = rule_b(a, b, g).sum_to_size(b.shape) \
            if ctx.needs_input_grad[1] else None
        return ga, gb, None, None, None


def cpu_dot_f32(a: Tensor, b: Tensor, *, lhs_t: bool = False,
                rhs_t: bool = False, role: str = "dense") -> Tensor:
    """``a @ b`` in fp32 (batched over leading dims, which broadcast) in
    XLA:CPU's order of summation for bf16-valued operands held as the
    flags say (the table above); outside the swept grid torch's fp32
    GEMM.  Differentiable, its backward the ``role``'s
    (:data:`_BACKWARD`)."""
    return _CpuDot.apply(a, b, lhs_t, rhs_t, role)


def matmul(a: Tensor, b: Tensor, *, lhs_t: bool = False,
           rhs_t: bool = False, role: str = "dense") -> Tensor:
    """``a @ b`` (batched) in a's dtype, as XLA computes the reference's
    products: a bf16 product on the CPU through :func:`cpu_dot_f32`
    (``lhs_t``/``rhs_t``: how the reference's compiled step holds the
    operands; ``role``: its backward's layouts), rounded once; on the
    card cuBLAS's bf16 product with fp32 accumulation."""
    b = b.to(a.dtype)
    if a.device.type == "cpu" and a.dtype == torch.bfloat16:
        return cpu_dot_f32(a, b, lhs_t=lhs_t, rhs_t=rhs_t,
                           role=role).to(a.dtype)
    return a @ b


def dense(p, x: Tensor) -> Tensor:
    """``x @ w (+ b)`` in x's dtype; the leading dims of x are the rows
    of one product, as XLA reshapes them (:func:`matmul`)."""
    w = p["w"].to(x.dtype)
    y = matmul(x.reshape(-1, x.shape[-1]), w).reshape(
        *x.shape[:-1], w.shape[-1])
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def dense_sum32(p, x: Tensor) -> Tensor:
    """:func:`dense` as an approximate residual add reads it: the product
    rounded to x's dtype, plus the bias in x's dtype, summed in fp32 and
    left unrounded (XLA fuses the bias add into the add's quantize and
    keeps the sum in fp32)."""
    y = dense({"w": p["w"]}, x)
    return y.float() + p["b"].to(x.dtype).float() if "b" in p else y


def dense_column(p, x: Tensor, tp=None) -> Tensor:
    """A column-parallel :func:`dense` under tensor parallelism (``tp``,
    a :class:`repro_torch.sharding.rules.TensorParallel`): ``p`` holds
    this rank's shard of the output dim (w's columns, the bias's
    entries), x is read whole by every rank (its cotangent summed over
    "model"); without ``tp`` :func:`dense`."""
    return dense(p, x if tp is None else tp.input(x))


def dense_row(p, x: Tensor, tp=None, *, sum32: bool = False) -> Tensor:
    """A row-parallel :func:`dense` under tensor parallelism: x is this
    rank's shard of the input dim and ``p["w"]`` its rows; the partial
    product, rounded to x's dtype, is summed over "model" in that dtype
    (fp32, rounded once), then the bias, replicated, is added once.  The
    reference's GSPMD-partitioned step sums the same bf16 partials
    (``all-reduce`` of the dot's converted output).  ``sum32``: the bias
    sum left in fp32 (:func:`dense_sum32`); without ``tp`` :func:`dense`
    or :func:`dense_sum32`."""
    if tp is None:
        return dense_sum32(p, x) if sum32 else dense(p, x)
    y = tp.sum(dense({"w": p["w"]}, x))
    if "b" not in p:
        return y
    if sum32:
        return y.float() + p["b"].to(x.dtype).float()
    return y + p["b"].to(x.dtype)


#: XLA:CPU sums a row longer than this in windows of this many, each
#: window one sequential sum, then the windows' sums in turn (again in
#: windows past this many); a row that is no multiple of it is padded
#: with zeros, half the padding (rounded down) in front.
XLA_REDUCE_WINDOW = 32


def _sequential_sum(x: Tensor) -> Tensor:
    acc = x[..., 0].clone()
    for j in range(1, x.shape[-1]):
        acc.add_(x[..., j])
    return acc


def _window_pad(n: int):
    pad = (-n) % XLA_REDUCE_WINDOW
    return pad // 2, pad - pad // 2


class _RowSumCPU(torch.autograd.Function):
    """The sum over the last axis in XLA:CPU's order (windows of
    XLA_REDUCE_WINDOW); its gradient the cotangent broadcast over that
    axis, the sum's derivative (what autograd gives through the windows'
    column selects, without a zero tensor of x's size for each)."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        w = XLA_REDUCE_WINDOW
        while x.shape[-1] > w:
            x = F.pad(x, _window_pad(x.shape[-1]))
            x = _sequential_sum(x.reshape(*x.shape[:-1], -1, w))
        return _sequential_sum(x)

    @staticmethod
    def backward(ctx, g):
        return g[..., None].expand(ctx.shape)


def row_sum(x: Tensor) -> Tensor:
    """The fp32 sum over the last axis: on the CPU in XLA:CPU's order
    (:class:`_RowSumCPU`), on the card torch's own."""
    if x.device.type != "cpu":
        return x.sum(dim=-1)
    return _RowSumCPU.apply(x)


def _windows(x: Tensor) -> Tensor:
    """(..., D) -> (windows..., n, D): each leading dim longer than
    XLA_REDUCE_WINDOW cut into windows of it (the shorter ones whole), a
    window's rows in row-major order."""
    w = XLA_REDUCE_WINDOW
    lead = x.shape[:-1]
    win = [min(n, w) for n in lead]
    x = F.pad(x, [0, 0] + [p for n in reversed(lead) for p in
                            (_window_pad(n) if n > w else (0, 0))])
    nd = len(lead)
    x = x.reshape([v for n, k in zip(x.shape[:-1], win)
                   for v in (n // k, k)] + [x.shape[-1]])
    x = x.permute(*range(0, 2 * nd, 2), *range(1, 2 * nd, 2), 2 * nd)
    return x.reshape(*x.shape[:nd], -1, x.shape[-1])


def _sequential_sum_bf16(x: Tensor) -> Tensor:
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for j in range(x.shape[-1]):
        acc = (acc + x[..., j]).to(torch.bfloat16).float()
    return acc


def bf16_sum(x: Tensor) -> Tensor:
    """The sum of every element of ``x`` (bf16 values) as XLA:CPU reduces
    a bf16 tensor: its accumulator bf16, every add rounded to it; each
    dim longer than XLA_REDUCE_WINDOW cut into windows of that many (the
    shorter ones whole), each window summed in row-major order from
    zero, and the windows' sums again until no dim is longer.  Returns
    an fp32 scalar holding a bf16 value.  On the card torch's own sum
    (fp32 accumulation) of the bf16 values."""
    x = x.float()
    if x.device.type != "cpu":
        return x.sum().to(torch.bfloat16).float()
    x = x[..., None]
    while x.dim() > 1 and max(x.shape[:-1]) > XLA_REDUCE_WINDOW:
        x = _sequential_sum_bf16(_windows(x).transpose(-1, -2))
    return _sequential_sum_bf16(x.reshape(-1))


@functools.lru_cache(maxsize=None)
def _rsqrt_estimates() -> Tensor:
    from repro_torch.models.rsqrt_table import RSQRT_ESTIMATES as s
    top = torch.tensor([int(s[i:i + 3], 16) for i in range(0, len(s), 3)],
                       dtype=torch.int32)
    return (126 << 23) | (top << 11)


def xla_rsqrt32(x: Tensor) -> Tensor:
    """XLA:CPU's fp32 ``rsqrt`` (its machine code, jax 0.9.0, x86-64):
    the hardware estimate (:mod:`repro_torch.models.rsqrt_table`) refined
    by two Newton steps, each ``y + (-y / 2) fma(x y, y, -1)`` with the
    two multiply-adds fused; a positive normal input only (XLA keeps the
    estimate for the others: torch's ``rsqrt`` stands for it here).  Not
    the correctly rounded value: it misses it in the last bit for about
    one input in eight."""
    x = x.float()
    b = x.view(torch.int32)
    e = (b >> 23) & 0xFF
    par = (e - 127) & 1
    y = (_rsqrt_estimates().to(x.device)[par * 1024
                                         + ((b & 0x7FFFFF) >> 13)]
         - (((e - 127 - par) // 2) << 23)).view(torch.float32)
    for _ in range(2):
        y = fma32(y * -0.5, fma32(x * y, y, -1.0), y)
    return torch.where((x > 0) & (e < 255) & (e > 0), y, torch.rsqrt(x))


#: The fp32 lanes of the vector XLA:CPU's LLVM reduces a norm scale's
#: gradient in (AVX).
XLA_LANES = 8


def _lane_sum_of_products(a: Tensor, b: Tensor) -> Tensor:
    """The fp32 sum of a * b (B, S, ..., D) over its leading dims as the
    loop LLVM vectorizes over S: for each b in turn, a vector of
    XLA_LANES lanes holding the running sum in lane 0 (-0 in the others)
    takes one FMA for each XLA_LANES consecutive S rows, the dims after
    S innermost; then its lanes are summed (the upper half onto the
    lower, then the upper quarter, then lane 1 onto lane 0), and the
    last S % XLA_LANES rows follow one FMA a row."""
    n, s, d = a.shape[0], a.shape[1], a.shape[-1]
    a, b = a.reshape(n, s, -1, d), b.reshape(n, s, -1, d)
    full = s - s % XLA_LANES
    acc = torch.zeros(d, dtype=torch.float32, device=a.device)
    for i in range(n):
        v = torch.full((XLA_LANES, d), -0.0, dtype=torch.float32,
                       device=a.device)
        v[0] = acc
        for k in range(0, full, XLA_LANES):
            for h in range(a.shape[2]):
                v = fma32(a[i, k:k + XLA_LANES, h], b[i, k:k + XLA_LANES, h],
                          v)
        while v.shape[0] > 1:
            v = v[:v.shape[0] // 2] + v[v.shape[0] // 2:]
        acc = v[0]
        for k in range(full, s):
            for h in range(a.shape[2]):
                acc = fma32(a[i, k, h], b[i, k, h], acc)
    return acc


def _sum_leading_of_products(a: Tensor, b: Tensor) -> Tensor:
    """The fp32 sum of a * b (..., D) over every leading dim, as XLA:CPU
    reduces a norm scale's gradient inside the compiled step (its inputs
    runtime values): for (B, S, D) and (B, S, H, D) with 24 <= S <= 32
    (and every leading dim at most XLA_REDUCE_WINDOW) LLVM vectorizes the
    loop over S (:func:`_lane_sum_of_products`; read from the machine
    code of the qwen3-4b smoke step's final, block and q/k norms at S =
    32, and matched at every S from 24 to 32 with H from 1 to 8); with
    every other leading dim at most XLA_REDUCE_WINDOW long it fuses the
    product into the reduction, one FMA a row in row-major order; past
    that it rounds the products, sums each window of XLA_REDUCE_WINDOW
    rows (the shorter dims whole) in row-major order and then the
    windows' sums, again in windows until no dim is longer.  (Matched for
    (rows, D), for (B, S, D) with S <= 22 or 24 <= S, and for (B, S, H,
    D) with 24 <= S; not followed: S = 23, and S < 24 with a heads dim,
    where LLVM vectorizes some shapes and not others.)"""
    if a.dim() == 1:
        a, b = a[None], b[None]
    if a.dim() >= 3 and 3 * XLA_LANES <= a.shape[1] \
            and max(a.shape[:-1]) <= XLA_REDUCE_WINDOW:
        return _lane_sum_of_products(a, b)
    if max(a.shape[:-1]) <= XLA_REDUCE_WINDOW:
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        acc = torch.zeros(a.shape[-1], dtype=torch.float32)
        for j in range(a.shape[0]):
            acc = fma32(a[j], b[j], acc)
        return acc
    x = a * b
    while x.dim() > 1 and max(x.shape[:-1]) > XLA_REDUCE_WINDOW:
        x = _sequential_sum(_windows(x).transpose(-1, -2))
    return _sequential_sum(x.reshape(-1, x.shape[-1]).transpose(0, 1))


class _RmsNormCPU(torch.autograd.Function):
    """The norm's value as XLA:CPU computes the reference's (the mean as
    the sum times the fp32 reciprocal of the width, XLA's ``rsqrt``:
    :func:`xla_rsqrt32`) and its backward as XLA computes jax's (read
    from the compiled VJP): with gs = g * scale, xc = x * c, c = (sum(x
    gs) * (inv / (var + eps) * -0.5)) / width, the input's gradient
    fma(gs, inv, xc) + xc; the scale's the sum over rows of (x inv) g,
    one FMA a row."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        xf = x.float()
        var = row_sum(xf * xf)[..., None] * np.float32(1 / xf.shape[-1])
        inv = xla_rsqrt32(var + eps)
        ctx.save_for_backward(xf, scale, var, inv)
        ctx.eps = eps
        return xf * inv * scale

    @staticmethod
    def backward(ctx, g):
        xf, scale, var, inv = ctx.saved_tensors
        gs = g * scale
        r = row_sum(xf * gs)[..., None]
        c = (r * ((inv / (var + ctx.eps)) * -0.5)) * np.float32(
            1 / xf.shape[-1])
        xc = xf * c
        gscale = _sum_leading_of_products(xf * inv, g) \
            if ctx.needs_input_grad[1] else None
        return fma32(gs, inv, xc) + xc, gscale, None


def rms_norm(p, x: Tensor, eps: float = 1e-6) -> Tensor:
    """The reference's RMS norm in x's dtype; on the CPU as XLA:CPU
    computes it and its gradient (:class:`_RmsNormCPU`), on the card
    torch's ops (the rsqrt correctly rounded, through fp64)."""
    if x.device.type == "cpu":
        return _RmsNormCPU.apply(x, p["scale"], eps).to(x.dtype)
    xf = x.to(torch.float32)
    var = (row_sum(xf * xf) / xf.shape[-1])[..., None]
    inv = torch.rsqrt((var + eps).to(torch.float64)).to(torch.float32)
    return (xf * inv * p["scale"]).to(x.dtype)


# ------------------------------------------------------------------- RoPE
#
# The tables are the C library's float ``cosf``/``sinf`` of the fp32
# angles, computed on the host and copied to the device.  Those are the
# functions XLA:CPU calls for the reference's ``jnp.cos``/``jnp.sin``, so
# the tables equal the reference's bit for bit; torch's own ``cos`` on the
# CPU or the card differs from them in the last bit of some entries,
# which the approximate residual adds (a quantize to Q8.8 and an
# adder whose output moves by up to 2^m units for a one-unit change of an
# operand) can turn into a visible change of the logits.

@functools.lru_cache(maxsize=None)
def _libm():
    import ctypes
    import ctypes.util
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name in ("cosf", "sinf"):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return lib


def _inv_freq(dim: int, base: float) -> np.ndarray:
    return (1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
            ).astype(np.float32)


def _host_tables(pos: np.ndarray, dim: int, base: float):
    ang = pos.astype(np.float32)[..., None] * _inv_freq(dim, base)
    flat = ang.ravel().tolist()
    lib = _libm()
    cos = np.array([lib.cosf(a) for a in flat], np.float32)
    sin = np.array([lib.sinf(a) for a in flat], np.float32)
    return cos.reshape(ang.shape), sin.reshape(ang.shape)


#: Positions a cached table block holds.
ROPE_BLOCK = 1024


@functools.lru_cache(maxsize=64)
def _block_tables(block: int, dim: int, base: float, device: torch.device):
    """The tables of positions ``[block * ROPE_BLOCK, (block + 1) *
    ROPE_BLOCK)``, on ``device``: computed and copied there once, so a
    decode step reads its row on the device without a host round trip."""
    pos = np.arange(block * ROPE_BLOCK, (block + 1) * ROPE_BLOCK)
    return tuple(torch.from_numpy(t).to(device)
                 for t in _host_tables(pos, dim, base))


def rope_tables(positions, dim: int, base: float, device=None):
    """cos/sin tables for ``positions`` -> (..., dim/2), fp32.

    ``positions`` is a tensor (any leading shape; the tables go to its
    device, and a CUDA tensor is read back to the host first) or a
    ``range`` (rows of the cached blocks on ``device``, the CPU if
    ``None``)."""
    if isinstance(positions, range):
        dev = torch.device("cpu" if device is None else device)
        first = positions.start // ROPE_BLOCK
        last = (max(positions.stop, positions.start + 1) - 1) // ROPE_BLOCK
        parts = [_block_tables(b, dim, float(base), dev)
                 for b in range(first, last + 1)]
        lo = positions.start - first * ROPE_BLOCK
        hi = lo + len(positions)
        return tuple(torch.cat(t)[lo:hi] if len(t) > 1 else t[0][lo:hi]
                     for t in zip(*parts))
    cos, sin = _host_tables(positions.detach().cpu().numpy(), dim,
                            float(base))
    return (torch.from_numpy(cos).to(positions.device),
            torch.from_numpy(sin).to(positions.device))


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x: (B, S, H, D); cos/sin: (B?, S, D/2) or (S, D/2)."""
    while cos.ndim < x.ndim - 1:
        cos, sin = cos[None], sin[None]
    cos = cos[..., None, :]  # broadcast over heads -> (..., S, 1, D/2)
    sin = sin[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    # XLA:CPU contracts the first product of each half into an FMA
    out = torch.cat([fma32(x1, cos, -(x2 * sin)), fma32(x2, cos, x1 * sin)],
                    dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention

def _repeat_kv(k: Tensor, num_q_heads: int) -> Tensor:
    reps = num_q_heads // k.shape[2]
    return torch.repeat_interleave(k, reps, dim=2) if reps > 1 else k


def _mask_bias(qpos: Tensor, kvpos: Tensor, *, causal: bool,
               window: int) -> Tensor:
    """(..., Sq, Skv) additive fp32 bias from absolute positions.

    kvpos < 0 marks invalid (unwritten or padded) cache slots.
    """
    q = qpos[..., :, None].to(torch.int32)
    k = kvpos[..., None, :].to(torch.int32)
    ok = k >= 0
    if causal:
        ok = ok & (k <= q)
    if window > 0:
        ok = ok & (k > q - window)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _scores(q: Tensor, k: Tensor) -> Tensor:
    """(b, h, q, k) fp32 scores of the working-dtype product (rounded to
    it first, as ``jnp.einsum("bqhd,bkhd->bhqk")`` does)."""
    return matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1),
                  role="scores").to(torch.float32)


def _mix(p: Tensor, v: Tensor) -> Tensor:
    """``jnp.einsum("bhqk,bkhd->bhqd", p, v)`` (b, h, q, d) in v's dtype,
    taken as XLA takes it: (v^T p^T)^T, with p held as [q, k]."""
    vt = v.permute(0, 2, 3, 1)                      # (b, h, d, k)
    return matmul(vt, p.to(v.dtype).transpose(2, 3), rhs_t=True,
                  role="mix").transpose(2, 3)


def plain_attention(q, k, v, qpos, kvpos, *, causal=True, window=0):
    """q: (B,Sq,H,D); k,v: (B,Skv,Hkv,D); qpos: (B,Sq) or (Sq,);
    kvpos: (B,Skv) or (Skv,)."""
    h = q.shape[2]
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    scale = q.shape[-1] ** -0.5
    s = _scores(q, k) * scale
    bias = _mask_bias(qpos, kvpos, causal=causal, window=window)
    bias = bias[None, None] if bias.ndim == 2 else bias[:, None]
    p = softmax32(s + bias)
    return _mix(p, v).transpose(1, 2)


def _flash_fwd(q, k, v, qpos, kvpos, causal, window, chunk):
    """Online-softmax forward over KV chunks (a loop in place of the
    reference's scan), its exps, sums and the two running updates (FMAs)
    as XLA:CPU computes them.  Returns (out (b,h,sq,dv) fp32, lse
    (b,h,sq); on the CPU the lse's log is XLA's, :func:`xla_log32`)."""
    b, sq, h, d = q.shape
    dv = v.shape[-1]
    skv = k.shape[1]
    scale = d ** -0.5
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, chunk):
        kci, vci = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = _scores(q, kci) * scale
        s = s + _mask_bias(qpos, kvpos[:, c0:c0 + chunk], causal=causal,
                           window=window)[:, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = exp32(s - m_new[..., None])
        corr = exp32(m - m_new)
        l = fma32(l, corr, row_sum(p))
        # this product XLA takes as written: p [q, k] @ v [k, d]
        if q.device.type == "cpu" and q.dtype == torch.bfloat16:
            pv = _flash_dot(p.to(vci.dtype), vci.transpose(1, 2),
                            fused=False).to(vci.dtype)
        else:
            pv = matmul(p.to(vci.dtype), vci.transpose(1, 2))
        acc = fma32(acc, corr[..., None], pv.to(torch.float32))
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    log = xla_log32 if q.device.type == "cpu" else torch.log
    return acc / l_safe[..., None], m + log(l_safe)


class _FlashAttention(torch.autograd.Function):
    """The reference's flash attention with its custom VJP
    (``_flash_vjp_fwd``/``_flash_vjp_bwd``): the forward saves q, k, v,
    the output (b, sq, h, dv) in q's dtype and the log-sum-exp, nothing
    per chunk; the backward recomputes each KV chunk's probabilities
    from the log-sum-exp, with delta = rowsum(dO * O), and sums dq over
    the chunks in fp32.  q, k, v: (b, s, h, d), the heads already
    repeated; qpos (b, sq), kvpos (b, skv), skv a multiple of ``chunk``."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kvpos, causal, window, chunk):
        out, lse = _flash_fwd(q, k, v, qpos, kvpos, causal, window, chunk)
        outq = out.transpose(1, 2).to(q.dtype)
        ctx.save_for_backward(q, k, v, qpos, kvpos, outq, lse)
        ctx.args = (causal, window, chunk)
        return outq

    @staticmethod
    def backward(ctx, g):
        q, k, v, qpos, kvpos, out, lse = ctx.saved_tensors
        causal, window, chunk = ctx.args
        scale = q.shape[-1] ** -0.5
        cpu = q.device.type == "cpu"
        g = g.float().transpose(1, 2)                   # (b, h, sq, dv)
        go = g * out.float().transpose(1, 2)
        # delta = rowsum(dO * O): on the CPU XLA's dot of one chain (the
        # bf16-valued products are exact in fp32)
        delta = _sequential_sum(go) if cpu else go.sum(dim=-1)  # (b,h,sq)
        qf = q.float().transpose(1, 2)                  # (b, h, sq, d)
        dq = torch.zeros_like(qf)
        dks, dvs = [], []
        for c0 in range(0, k.shape[1], chunk):
            kci, vci = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
            s = _scores(q, kci) * scale
            s = s + _mask_bias(qpos, kvpos[:, c0:c0 + chunk], causal=causal,
                               window=window)[:, None]
            p = exp32(s - lse[..., None])                # (b, h, sq, c)
            kf = kci.float().transpose(1, 2)             # (b, h, c, d)
            vt = vci.float().permute(0, 2, 3, 1)         # (b, h, dv, c)
            if not cpu:
                dvs.append(p.transpose(2, 3) @ g)        # (b, h, c, dv)
                dp = g @ vt                              # (b, h, sq, c)
                ds = p * (dp - delta[..., None]) * scale
                dq = dq + ds @ kf
                dks.append(ds.transpose(2, 3) @ qf)      # (b, h, c, d)
                continue
            # the products as the reference's compiled VJP holds them:
            # dv^T = g^T p, dp = g v^T, dq^T = k^T ds^T (ds held as [q, c]),
            # dk^T = q^T ds; those with an fp32 operand as FMA chains
            dvs.append(_t(_flash_dot(_t(g), p)))
            dp = _ordered_dot(g, vt, False, False)
            ds = p * (dp - delta[..., None]) * scale
            # (ds^T materialized as [c, q] past XLA_ORDER_MAX_K rows)
            dq = dq + _t(_flash_dot(_t(kf), _t(ds),
                                    rhs_t=chunk <= XLA_ORDER_MAX_K))
            dks.append(_t(_flash_dot(_t(qf), ds)))
        dk = torch.cat(dks, dim=2).transpose(1, 2)
        dv = torch.cat(dvs, dim=2).transpose(1, 2)
        return (dq.transpose(1, 2).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None, None)


def _flash_dot(a: Tensor, b: Tensor, *, rhs_t: bool = False,
               fused: bool = True) -> Tensor:
    """A flash product on the CPU in XLA:CPU's order (``fused``: each
    product fused into its add, for an fp32 operand).  Past the swept grid
    (K > XLA_ORDER_MAX_K, or M > XLA_ORDER_WIDE_MN: a long sequence's
    chunks) the orders read from the jitted VJP of a 1040-token sequence
    (chunk 1024, 8 XLA threads): M > 50, the chains by width over the
    whole K ((1040, 1024) @ (1024, 16)); 1 < M <= 50, N > 508 and K >=
    128, one chain over each K block of the largest power of two at most
    K / 2 (at most 512: the library splits K between threads), the
    blocks' sums added in turn, and the last N % 64 columns one chain over
    K ((16, 1040) @ (1040, 1024), (16, 1024) @ (1024, 1040); 200, 256, 600
    and 2100 deep too).  Elsewhere torch's GEMM."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    order = xla_cpu_dot_order(m, k, n, rhs_t=rhs_t)
    if order is None and m > 50 and not rhs_t:
        chains = _chains_by_width(n, k)
        order = None if chains is None else (chains, k)
    elif order is None and 1 < m <= 50 and n > 508 and k >= 128 \
            and not rhs_t:
        # the last N % 64 columns one chain over the whole K
        tail = n % 64
        block = 1, min(512, 1 << ((k // 2).bit_length() - 1))
        head = _ordered_dot(a, b[..., :n - tail], False, False, fused=fused,
                            order=block)
        if not tail:
            return head
        return torch.cat([head, _ordered_dot(
            a, b[..., n - tail:], False, False, fused=fused, order=(1, k))],
            dim=-1)
    return _ordered_dot(a, b, False, rhs_t, fused=fused, order=order)


def chunked_attention(q, k, v, qpos, kvpos, *, causal=True, window=0,
                      chunk=1024):
    """Flash attention (online softmax over KV chunks) with the
    reference's memory-optimal VJP (:class:`_FlashAttention`)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if kvpos.ndim == 1:
        kvpos = kvpos[None]
    if skv % chunk:
        pad = chunk - skv % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kvpos = F.pad(kvpos, (0, pad), value=-1)
        skv += pad
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    if qpos.ndim == 1:
        qpos = qpos[None]
    kvpos = kvpos.expand(b, skv)
    qpos = qpos.expand(b, sq)
    return _FlashAttention.apply(q, k, v, qpos, kvpos, causal, window, chunk)


def local_attention(q, k, v, *, window: int):
    """Causal sliding-window attention for full sequences (prefill).

    Two-block trick: pad S to multiples of W=window; queries in block i
    attend keys in blocks {i-1, i} with position masking, giving
    O(S * 2W) instead of O(S^2).  Blocks run one after the other, which
    bounds the live fp32 scores to one block's worth.
    """
    b, s, h, d = q.shape
    w = window
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    pad = (-s) % w
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    n = (s + pad) // w
    qb = q.reshape(b, n, w, h, d)
    kb = k.reshape(b, n, w, h, d)
    vb = v.reshape(b, n, w, h, d)
    # previous block (block -1 is zeros with invalid positions)
    k_prev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    v_prev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([k_prev, kb], dim=2)  # (b, n, 2w, h, d)
    v2 = torch.cat([v_prev, vb], dim=2)
    scale = d ** -0.5
    dev = q.device
    ar_n = torch.arange(n, device=dev)
    qpos = ar_n[:, None] * w + torch.arange(w, device=dev)[None, :]
    kvpos = (ar_n[:, None] - 1) * w + torch.arange(2 * w, device=dev)[None]
    kvpos = torch.where((kvpos >= 0) & (kvpos < s), kvpos,
                        torch.full_like(kvpos, -1))
    bias = _mask_bias(qpos, kvpos, causal=True, window=w)  # (n, w, 2w)
    out = []
    for i in range(n):
        sco = _scores(qb[:, i], k2[:, i]) * scale + bias[i][None, None]
        p = softmax32(sco)
        out.append(_mix(p, v2[:, i]).transpose(1, 2))
    return torch.stack(out, dim=1).reshape(b, s + pad, h, d)[:, :s]


def attention_any(q, k, v, qpos, kvpos, *, causal=True, window=0,
                  kv_chunk=1024, plain_limit=1024 * 1024):
    """Route to the right attention path.

    - windowed full-sequence longer than the window: blocked local
      attention, O(S * 2W);
    - decode (sq == 1) and small problems: plain (scores materialized);
    - everything else: online-softmax chunked attention (memory-bounded).
    """
    sq, skv = q.shape[1], k.shape[1]
    if window > 0 and causal and sq == skv and sq > window:
        return local_attention(q, k, v, window=window)
    if sq * skv <= plain_limit or sq == 1:
        return plain_attention(q, k, v, qpos, kvpos, causal=causal,
                               window=window)
    return chunked_attention(q, k, v, qpos, kvpos, causal=causal,
                             window=window, chunk=kv_chunk)


# ------------------------------------------------------------------- MLPs
#
# ``jax.nn.silu`` and ``jax.nn.gelu`` are chains of elementwise ops that
# XLA rounds to the working dtype after each op (its logistic is
# 1 / (1 + exp(-x))).  The two functions below are those chains, op for
# op, so that bf16 activations round where the reference's do; a fused
# ``F.silu``/``F.gelu`` rounds once and differs in the last bit of many
# bf16 outputs.

class _Silu(torch.autograd.Function):
    """``jax.nn.silu`` as XLA computes it and its gradient in x's dtype,
    every op rounded (read from the compiled VJP): with s the sigmoid,
    ``g s + (x g) (s (1 - s))``."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        g = g.to(x.dtype)
        return g * s + (x * g) * (s * (1 - s))


def silu(x: Tensor) -> Tensor:
    return _Silu.apply(x)


def gelu_tanh(x: Tensor) -> Tensor:
    """``jax.nn.gelu`` (its default tanh approximation), the constants
    rounded to x's dtype as the reference's are."""
    c0, c1 = torch.tensor([0.044715, np.sqrt(2 / np.pi)],
                          dtype=x.dtype).tolist()
    inner = (x + (x * x * x) * c0) * c1
    return x * ((torch.tanh(inner) + 1) * 0.5)


def swiglu(p, x: Tensor, tp=None) -> Tensor:
    """The SwiGLU MLP; under tensor parallelism (``tp``) ``wi``/``wg``
    column-parallel and ``wo`` row-parallel (:func:`dense_column`,
    :func:`dense_row`): each rank's d_ff shard, one sum over "model"."""
    h = silu(dense_column(p["wg"], x, tp)) * dense_column(p["wi"], x, tp)
    return dense_row(p["wo"], h, tp)


def gelu_mlp(p, x: Tensor, *, sum32: bool = False, tp=None) -> Tensor:
    """The GELU MLP; ``sum32``: its output projection's bias sum kept in
    fp32 unrounded (:func:`dense_sum32`), as an approximate residual add
    reads it; ``tp`` as :func:`swiglu`'s (``wo.b`` added once, after
    the sum)."""
    return dense_row(p["wo"], gelu_tanh(dense_column(p["wi"], x, tp)), tp,
                     sum32=sum32)


# ------------------------------------------------- fp32 elementwise math
#
# The recurrent mixers keep their gates, decays and states in fp32 and
# round them to bf16 later, so a one-ulp difference of an fp32 ``exp``
# flips a bf16 value now and then, and the approximate residual adds
# amplify it.  On the CPU the functions below compute what XLA:CPU's
# compiled code computes for the reference (read from its LLVM IR and
# machine code, jax 0.9.0, x86-64): its own polynomial ``exp`` and
# ``log1p`` (not the C library's, not correctly rounded), every
# multiply-add that LLVM contracts into a fused multiply-add done as one
# (:func:`fma32`), and results below the smallest normal flushed to zero
# (XLA:CPU runs with FTZ/DAZ set).  On the card ``exp32``, ``log1p32``,
# ``sqrt32`` and ``fma32`` take one torch kernel each: the emulation
# (:func:`xla_exp32`, :func:`xla_log1p32`, which run on any device) takes
# a few hundred launches a call, and the card's GEMMs do not round as
# XLA:CPU's anyway (ROADMAP Queue C 3).

def _hex(*values):
    return tuple(float.fromhex(v) for v in values)


EXP_CLAMP = _hex("-0x1.5f3334p+6", "0x1.633334p+6")     # -87.8, 88.8
LOG2E = float.fromhex("0x1.715476p+0")
LN2_HI, LN2_LO = _hex("0x1.63p-1", "-0x1.bd0106p-13")
EXP_POLY = _hex("0x1.a0d2cep-13", "0x1.6e879cp-10", "0x1.111210p-7",
                "0x1.555382p-5", "0x1.555554p-3")
SQRT_HALF = float.fromhex("0x1.6a09e6p-1")
LOG_POLY = (_hex("0x1.204376p-4", "-0x1.d7a370p-4", "0x1.de4a34p-4"),
            _hex("-0x1.fcba9ep-4", "0x1.23d37ep-3", "-0x1.555ca0p-3"),
            _hex("0x1.999d58p-3", "-0x1.fffff8p-3", "0x1.555554p-2"))
LOG1P_NUM = _hex("0x1.7bc096p-15", "0x1.fe818ap-2", "0x1.a509f4p+2",
                 "0x1.de9738p+4", "0x1.e798ecp+5", "0x1.c8e75ap+5",
                 "0x1.40a202p+4")
LOG1P_DEN = _hex("0x1.e2035ap+3", "0x1.4c30b6p+6", "0x1.bb865ap+7",
                 "0x1.351946p+8", "0x1.b0db14p+7", "0x1.e0f304p+5")
LOG1P_SMALL = float.fromhex("0x1.a8279ap-2")           # sqrt(2) - 1
MIN_NORMAL = float.fromhex("0x1p-126")


#: Elements a CPU emulation takes at a time: its fp64 temporaries then
#: stay in the cache (7x faster on a (4, 128, 151936) logit tensor).
CPU_CHUNK = 1 << 18


def _by_chunks(fn, x: Tensor) -> Tensor:
    """Elementwise ``fn(x)``, on the CPU CPU_CHUNK elements at a time."""
    if x.device.type != "cpu" or x.numel() <= CPU_CHUNK:
        return fn(x)
    flat = x.reshape(-1)
    return torch.cat([fn(c) for c in flat.split(CPU_CHUNK)]).reshape(
        x.shape)


class _Unary(torch.autograd.Function):
    """``fn(x)`` (an elementwise emulation torch cannot differentiate: it
    reads bits, floors, or selects between branches) with the backward
    jax gives the function it emulates: ``vjp(g, x, out)``, op for op."""

    @staticmethod
    def forward(ctx, x, fn, vjp):
        out = _by_chunks(fn, x)
        ctx.save_for_backward(x, out)
        ctx.vjp = vjp
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return ctx.vjp(g, x, out), None, None


def _with_vjp(fn, vjp):
    """``fn`` (fp32) as a function whose backward is ``vjp(g, x, out)``."""
    def wrapped(x: Tensor) -> Tensor:
        return _Unary.apply(x.float(), fn, vjp)
    wrapped.__doc__ = fn.__doc__
    return wrapped


class _Fma(torch.autograd.Function):
    """:func:`_fma32` with the derivatives of ``a * b + c``."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        ctx.shapes = (a.shape, b.shape, c.shape)
        return _fma32(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        sa, sb, sc = ctx.shapes
        return ((g * b).sum_to_size(sa), (g * a).sum_to_size(sb),
                g.sum_to_size(sc))


def fma32(a, b, c) -> Tensor:
    """fp32 ``a * b + c`` rounded once, as an FMA instruction rounds it
    (:func:`_fma32`); differentiable in each tensor operand."""
    if all(isinstance(t, Tensor) and t.device.type != "cpu"
           for t in (a, b, c)):
        return torch.addcmul(c.float(), a.float(), b.float())
    devs = [t.device for t in (a, b, c) if isinstance(t, Tensor)]
    dev = next((d for d in devs if d.type != "cpu"), devs[0])
    a, b, c = (torch.as_tensor(t, dtype=torch.float32, device=dev)
               for t in (a, b, c))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, b, c)):
        return _Fma.apply(a, b, c)
    return _fma32(a, b, c)


def _fma32(a, b, c) -> Tensor:
    """fp32 ``a * b + c`` rounded once, as an FMA instruction rounds it.

    The product of two fp32 values is exact in fp64, and the fp64 sum is
    rounded once to fp32; that double rounding can miss only where the
    fp64 sum lies exactly halfway between two fp32 values, and there the
    fp64 add's own error (an exact two-sum) says which way the exact sum
    lies.  Three tensors on the card take one ``torch.addcmul`` kernel
    instead (the exact route is about 15 kernels, 0.4 ms on an SSD
    layer's (4, 64, 128, 64) state)."""
    s = torch.addcmul(c.double(), a.double(), b.double())
    r = s.float()
    # a halfway case has the 29 fp64 mantissa bits below fp32's 24 equal
    # to 1 followed by zeros; where r is not a normal fp32 value (but for
    # an exact zero) fewer bits are kept: both are checked one by one
    # (they are rare)
    near = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    small = r.abs() < MIN_NORMAL
    if bool(small.any()):
        near |= small & (s != 0)
    if not bool(near.any()):
        return r
    a, b, c = torch.broadcast_tensors(a, b, c)
    idx = near.nonzero(as_tuple=True)
    r = r.clone()
    r[idx] = _fma32_exact(a[idx], b[idx], c[idx])
    return r


def _fma32_exact(a, b, c) -> Tensor:
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.float()
    d = s - r.double()
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(d > 0, inf, -inf))
    off_mid = ((d != 0) & (other.double() - s == -d) & (err != 0)
               & ((err > 0) == (d > 0)))
    return torch.where(off_mid, other, r)


def _fma32_host(a: float, b: float, c: float) -> np.float32:
    """:func:`_fma32` of three host scalars."""
    return np.float32(_fma32(*(torch.tensor([float(np.float32(t))],
                                            dtype=torch.float32)
                               for t in (a, b, c))).item())


def ftz(x: Tensor) -> Tensor:
    """Results below the smallest normal fp32 flushed to (signed) zero."""
    return torch.where(x.abs() < MIN_NORMAL, x * 0.0, x)


def _xla_exp32(x: Tensor) -> Tensor:
    """XLA:CPU's fp32 ``exp``: 2^n times a degree-7 polynomial of the
    reduced argument, every multiply-add one FMA; its derivative jax's,
    ``g * out``."""
    x = x.float().clamp(*EXP_CLAMP)
    n = torch.floor(fma32(x, LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma32(-n, LN2_HI, x)
    r = fma32(-n, LN2_LO, r)
    p = fma32(r, EXP_POLY[0], EXP_POLY[1])
    for c in EXP_POLY[2:] + (0.5,):
        p = fma32(p, r, c)
    y = fma32(p, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return ftz(y * scale)


xla_exp32 = _with_vjp(_xla_exp32, lambda g, x, out: g * out)


def _log1p_small(x: Tensor) -> Tensor:
    """log1p for |x| < sqrt(2) - 1: x - x^2/2 + x^3 P(x)/Q(x)."""
    x2 = x * x
    zero = x * 0.0
    num, den = zero + LOG1P_NUM[0], zero + 1.0
    for c in LOG1P_NUM[1:]:
        num = fma32(num, x, c)
    for c in LOG1P_DEN:
        den = fma32(den, x, c)
    return x + fma32(x2, -0.5, (x * x2) * (num / den))


def _log1p_large(x: Tensor) -> Tensor:
    """log(1 + x) through the exponent and a mantissa polynomial."""
    v = x + 1.0
    bits = torch.clamp_min(v, MIN_NORMAL).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < SQRT_HALF
    t = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.float()
    t2 = t * t
    t3 = t2 * t
    a, b, c = (fma32(fma32(t, p[0], p[1]), t, p[2]) for p in LOG_POLY)
    b = fma32(a, t3, b)
    c = fma32(b, t3, c)
    g = fma32(t2, -0.5, t) + fma32(c, t3, e * LN2_LO)
    out = fma32(e, LN2_HI, g)
    nan = torch.full_like(v, float("nan"))
    out = torch.where((v <= 0) | torch.isnan(v), nan, out)
    out = torch.where(v == 0, -torch.ones_like(v) * float("inf"), out)
    return torch.where(v == float("inf"), v, out)


def _xla_log1p32(x: Tensor) -> Tensor:
    """XLA:CPU's fp32 ``log1p``; its derivative jax's, ``g / (1 + x)``
    (the large branch reads the mantissa's bits, through which torch
    would give none)."""
    x = x.float()
    return torch.where(x.abs() < LOG1P_SMALL, _log1p_small(x),
                       _log1p_large(x))


xla_log1p32 = _with_vjp(_xla_log1p32, lambda g, x, out: g / (x + 1))


#: XLA:CPU's fp32 ``log`` (Cephes' ``logf``; the constants read from its
#: machine code, jax 0.9.0, x86-64): x = m 2^e, m in [sqrt(1/2),
#: sqrt(2)), and log(x) = t - t^2 / 2 + t^3 P(t) + e (LOG_HI + LOG_LO)
#: with t = m - 1.
LOG_SQRTHF = float.fromhex("0x1.6a09e6p-1")
LOG_P = _hex("0x1.204376p-4", "-0x1.d7a37p-4", "0x1.de4a34p-4",
             "-0x1.fcba9ep-4", "0x1.23d37ep-3", "-0x1.555cap-3",
             "0x1.999d5ap-3", "-0x1.fffff8p-3", "0x1.555554p-2")
LOG_HI, LOG_LO = 0.693359375, float.fromhex("-0x1.bd0106p-13")


def xla_log32(x: Tensor) -> Tensor:
    """XLA:CPU's fp32 ``log`` of a positive normal input (the flash
    forward's log-sum-exp): the mantissa's bits, its polynomial in three
    interleaved Horner chains, every multiply that feeds one add an FMA
    (LLVM contracts them); elsewhere (0, subnormal, inf, nan) torch's.
    Equal to the flash forward's fused ``log``; a lone jitted ``jnp.log``
    differs from it in the last bit of about 3 inputs in 10^4.  Not
    differentiable (the log-sum-exp is saved, not differentiated)."""
    x = x.float()
    b = x.view(torch.int32)
    mant = ((b & 0x807FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    e = ((b >> 23) - 127).float() + 1.0
    low = mant < LOG_SQRTHF
    e = e - low.float()
    t = (mant - 1.0) + torch.where(low, mant, torch.zeros_like(mant))
    z = t * t
    t3 = z * t
    y1 = fma32(fma32(t, LOG_P[0], LOG_P[1]), t, LOG_P[2])
    y2 = fma32(fma32(t, LOG_P[3], LOG_P[4]), t, LOG_P[5])
    y3 = fma32(fma32(t, LOG_P[6], LOG_P[7]), t, LOG_P[8])
    y = fma32(fma32(fma32(y1, t3, y2), t3, y3), t3, e * LOG_LO)
    out = fma32(LOG_HI, e, fma32(-0.5, z, t) + y)
    ok = (x >= MIN_NORMAL) & (b < 0x7F800000)
    return torch.where(ok, out, torch.log(x))


#: XLA:CPU's fp32 ``tanh`` (Eigen's rational form): the argument clamped
#: to +-TANH_CLAMP, x P(x^2) / Q(x^2); x itself below TANH_SMALL in
#: magnitude, +-1 from TANH_ONE on.
TANH_SMALL = float.fromhex("0x1.a36e2ep-12")            # 0.0004
TANH_CLAMP = float.fromhex("0x1.ffec88p+2")             # 7.9988
TANH_ONE = 20.0
TANH_NUM = _hex("-0x1.3e4b8p-52", "0x1.c266fcp-43", "-0x1.7a6ffep-34",
                "0x1.b80082p-25", "0x1.f28694p-17", "0x1.4e1bdap-11",
                "0x1.40b3b8p-8")
TANH_DEN = _hex("0x1.41a7b0p-20", "0x1.f12bacp-14", "0x1.29540ap-9",
                "0x1.40b3bap-8")


def _xla_tanh32(x: Tensor) -> Tensor:
    """XLA:CPU's fp32 ``tanh``: both polynomials in x^2 by Horner's rule,
    every step one FMA, the numerator times x, one division.  It runs on
    any device (the exact FMA is fp64 arithmetic), so a gate's ``tanh``
    on the card equals the CPU's.  Its backward is jax's as XLA computes
    it, ``m + m out`` with ``m = g (1 - out)``, one FMA."""
    x = x.float()
    c = x.clamp(-TANH_CLAMP, TANH_CLAMP)
    c2 = c * c
    num = fma32(c2, TANH_NUM[0], TANH_NUM[1])
    for k in TANH_NUM[2:]:
        num = fma32(c2, num, k)
    den = fma32(c2, TANH_DEN[0], TANH_DEN[1])
    for k in TANH_DEN[2:]:
        den = fma32(c2, den, k)
    out = torch.where(x.abs() < TANH_SMALL, x, (c * num) / den)
    return torch.where(x.abs() >= TANH_ONE,
                       torch.copysign(torch.ones_like(x), x), out)


def _tanh_vjp(g, x, out):
    m = g * (1 - out)
    return fma32(m, out, m)


xla_tanh32 = _with_vjp(_xla_tanh32, _tanh_vjp)


def exp32(x: Tensor) -> Tensor:
    """fp32 ``exp``: XLA:CPU's on the CPU, torch's on the card."""
    return xla_exp32(x) if x.device.type == "cpu" else torch.exp(x.float())


def log1p32(x: Tensor) -> Tensor:
    """fp32 ``log1p``: XLA:CPU's on the CPU, torch's on the card."""
    if x.device.type == "cpu":
        return xla_log1p32(x)
    return torch.log1p(x.float())


def sqrt32(x: Tensor) -> Tensor:
    """The correctly rounded fp32 square root: on the CPU through fp64
    (torch's own fp32 ``sqrt`` there misses it in the last bit of some
    values), on the card torch's (IEEE-rounded)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x.float())


def _lane_fma_row_sum(a: Tensor, b: Tensor) -> Tensor:
    """sum(a * b) over the last axis as LLVM vectorizes XLA:CPU's row
    reduction of a fused product (rows of XLA_REDUCE_WINDOW): lane i takes
    an FMA of each element i mod XLA_LANES in turn, from 0 in lane 0 (-0
    in the others); then the upper half of the lanes onto the lower, the
    upper quarter, lane 1 onto lane 0."""
    v = torch.full((*a.shape[:-1], XLA_LANES), -0.0, dtype=torch.float32)
    v[..., 0] = 0.0
    for j in range(0, a.shape[-1], XLA_LANES):
        v = fma32(a[..., j:j + XLA_LANES], b[..., j:j + XLA_LANES], v)
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


class _SoftmaxCPU(torch.autograd.Function):
    """``e / sum(e)``, e = exp(x - max), and its backward as XLA:CPU
    computes the reference's (jax differentiates the composition): with
    s = sum(e), ``(g / s - sum(g (1 / s^2) e)) e``; at 32 keys the sum's
    product fused into it (:func:`_lane_fma_row_sum`, read from the
    machine code of the qwen3-4b smoke attention's VJP); other row
    lengths round the products and take :func:`row_sum` (not read)."""

    @staticmethod
    def forward(ctx, x):
        e = _by_chunks(_xla_exp32, x - x.amax(dim=-1, keepdim=True))
        s = row_sum(e)[..., None]
        ctx.save_for_backward(e, s)
        return e / s

    @staticmethod
    def backward(ctx, g):
        e, s = ctx.saved_tensors
        gs = g * (1 / (s * s))
        n = e.shape[-1]
        if n == XLA_REDUCE_WINDOW:
            r = _lane_fma_row_sum(gs, e)[..., None]
        else:
            r = row_sum(gs * e)[..., None]
        return (g / s + -r) * e


def softmax32(x: Tensor) -> Tensor:
    """``jax.nn.softmax`` over the last axis of fp32 ``x``: on the CPU
    exp(x - max) over its sum with XLA:CPU's ``exp`` and order of sums
    (torch's own ``softmax`` there differs from it in the last bit of many
    values, which a bf16 cast of the probabilities now and then keeps),
    its backward as XLA computes the reference's (:class:`_SoftmaxCPU`);
    on the card torch's one-kernel ``softmax``."""
    if x.device.type != "cpu":
        return torch.softmax(x, dim=-1)
    return _SoftmaxCPU.apply(x.float())


def _sigmoid32(x: Tensor) -> Tensor:
    return ftz(1.0 / (exp32(-x) + 1.0))


sigmoid32 = _with_vjp(_sigmoid32, lambda g, x, out: g * (out * (1 - out)))
sigmoid32.__doc__ = """``jax.nn.sigmoid`` in fp32: 1 / (1 + exp(-x)); its
backward jax's, ``g * (out * (1 - out))``."""


def _softplus32(x: Tensor) -> Tensor:
    """``jax.nn.softplus`` in fp32: max(x, 0) + log1p(exp(-|x|)), NaN
    kept; its derivative jax's (``logaddexp(x, 0)``'s), ``g * exp(x -
    out)`` (the sigmoid), on every device (torch's own through ``max``
    and ``|x|`` gives 1 at x = 0, not 1/2)."""
    out = torch.clamp_min(x, 0.0) + log1p32(exp32(-x.abs()))
    return torch.where(torch.isnan(x), x, out)


softplus32 = _with_vjp(_softplus32, lambda g, x, out: g * exp32(x - out))
