"""Where the transducer wavefront kernels' time goes (K8 alpha, K9 beta
and posteriors, csrc/rnnt_loss.cu): time text-patched copies of the
kernels and of the block-per-sequence kernels they replaced, and time the
kernels against those in turns, on one GPU.

    python -m end2end_tpu_torch.tools.rnnt_wavefront_breakdown
        [--against FILE...] [--out FILE]

The sibling of ctc_alpha_breakdown (K1), with its build, timing and
clock/power sampler.  The parent is tools/rnnt_loss_reference.cu, kept
verbatim: a block of whole warps a sequence, lane u = thread u, the row
in shared memory, a block max of two barriers a diagonal, the plane
entries loaded from global memory on the diagonal's chain, the posteriors
inside the beta walk.  Each variant is a source with text patches applied
(no switch lives in a kernel; PARENT and NEW list them).  The parent's:
without the plane loads (each entry a constant of its lane; K9 also
without its alpha-tape load), without the tape stores (K8), without the
posterior stores or the posteriors (K9), without libm's exp and log1p in
the logaddexp2s, and its block max without the barrier (wrong outputs).
The kernels': without the plane copies and reads, the tape and offset
stores (both kernels), the skew pass, the posterior pass, libm's exp and
log1p, or the terminal blank (wrong outputs); the warps' slots polled in
place of the barrier; K8's rows stored a diagonal late, as the beta
wavefront stores them; and the lanes interleaved (u = i + 32 j) at one
warp's plan, outputs compared bit for bit.  The kernels also run at other
plans than `wavefront_plan`'s (PLANS, `any_plan`, on a build with
ANY_PLAN's patches, which instantiate them; the outputs, compared bit for
bit, do not change): rings of 2 and 8 diagonals, 2 to 5 lanes a thread,
and one warp at ceil(U+1 / 32) lanes a thread.  A clock probe (PROBE_*)
sums thread 0's cycles a diagonal of sequence 0 in each segment of the
diagonal's step (the stamps themselves cost cycles: the segments add up
to more than the whole).

--against times other versions (whole rnnt_loss.cu files; by default the
parent) beside the kernels in turns, each once in order and then in the
reverse order, and checks that their outputs are bit-equal to the
kernels': K8's tape and offsets, and K9's two posterior planes on the
same inputs.  Two shapes: the transducer training slice's lattice
(B=8, T'=750, U+1=151, the lengths of 30/22/15 s requests with T'/5
labels) and the JAX bench row's (B=8, T=400, U+1=81).  Planes are the
blank and label log-probs of random logits (V=32) from a seed.  Times
are device times (`device_ms`: CALLS calls in a CUDA graph) and cycles
a diagonal (device ms x the SM clock sampled under the kernel over the
T+U-1 diagonals); the card's SM clock, power and temperature are sampled
while the kernels and the first --against run back to back.  Memory: the
wrappers' workspace in bytes beside the planes' (WORKSPACE_SHAPES), and
the peak memory of a loss + gradient call on the transducer and fused
paths with the kernels and with the parent's in their place, in turns.
Prints one JSON object with the card's name and power limit (and writes
it to --out if given).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import rnnt_loss_cuda, rnnt_loss_plain
from ..ops.rnnt_joint import rnnt_nll_fused_pallas
from ..ops.rnnt_loss import rnnt_loss
from ..utils import cuda_build
from .joint_dw_breakdown import build, device_ms, patched, under_load

REFERENCE = Path(__file__).resolve().with_name("rnnt_loss_reference.cu")
# ptxas lines: every parent kernel; the kernels at both shapes' plan (one
# lane a thread over several warps, a ring of 4)
KERNEL = {False: "rnnt_", True: "ILi1ELi4ELb0E"}
CALLS = 20
V = 32
# name: (B, T, U+1, input lengths); labels: T'/5 of each input length
_MAIN_IL = (750, 550, 375, 750, 550, 375, 550, 375)
SHAPES = {"main": (8, 750, 151, _MAIN_IL), "bench": (8, 400, 81, (400,) * 8)}
# (N, T, U+1) of the workspace table: both shapes, a long batch at a large
# U+1, and the card tests' largest register plan
WORKSPACE_SHAPES = {"main": (8, 750, 151), "bench": (8, 400, 81),
                    "N=32, T=1500, U+1=1025": (32, 1500, 1025),
                    "card test, U+1=8192": (3, 9, 8192)}
FUSED_J, FUSED_V = 128, 32768  # the fused joint's bench row
# the parent's entry points: b_pl, l_pl, tape, rcum, n, t, up, stream; and
# b_pl, l_pl, tape, rcum, il, ul, z_small, z_off, gb, gl, n, t, up, stream
_VP, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIG = {"alpha": (_VP,) * 4 + (_I,) * 3 + (_VP,),
           "post": (_VP,) * 10 + (_I,) * 3 + (_VP,)}

_STAMP = (
    "__device__ __forceinline__ long long stamp_after(float x) {\n"
    "  long long c;\n"
    "  asm volatile(\"{\\n .reg .pred p;\\n setp.eq.f32 p, %1, "
    "0f7FC00000;\\n mov.u64 %0, %%clock64;\\n @p mov.u64 %0, 0;\\n}\"\n"
    "               : \"=l\"(c) : \"f\"(x));\n"
    "  return c;\n}\n")

# name: [(text, replacement)] on the parent; every text must occur once
_P_K9_POST = (
    "        gb[base + o] =\n"
    "            (live && lg_b > kLog0Threshold) ? expf(fminf(lg_b, 0.0f)) "
    ": 0.0f;\n"
    "        gl[base + o] =\n"
    "            (live && lg_l > kLog0Threshold) ? expf(fminf(lg_l, 0.0f)) "
    ": 0.0f;\n")
_P_K9_END = "    r_next = r_next + m;\n    __syncthreads();\n  }\n}"
PARENT = {
    "no plane loads": [
        ("      const float skb = plane_at(bp, d - 1 - u, u, t_max, up);\n",
         "      const float skb = (unsigned)(d - 1 - u) < (unsigned)t_max "
         "? -0.5f - 1e-3f * u : kLog0;\n"),
        ("      const float skl = u > 0 ? plane_at(lp, d - u, u - 1, t_max, "
         "up) : kLog0;\n",
         "      const float skl = u > 0 && (unsigned)(d - u) < "
         "(unsigned)t_max ? -0.7f - 1e-3f * u : kLog0;\n"),
        ("      const float skb = plane_at(bp, t, u, t_max, up);\n",
         "      const float skb = in_lattice ? -0.5f - 1e-3f * u : kLog0;\n"),
        ("      const float skl = plane_at(lp, t, u, t_max, up);\n",
         "      const float skl = in_lattice ? -0.7f - 1e-3f * u : kLog0;\n"),
        ("        const float small = __ldg(arow + u) - zs;\n",
         "        const float small = (-2.0f - 1e-3f * u) - zs;\n")],
    "no tape stores": [
        ("      row[u] = v;\n", ""),
        ("    if (threadIdx.x == 0) rcum[(size_t)d * n_seq + n] = r;\n", "")],
    "no posterior stores": [
        (_P_K9_POST,
         "        sink += ((live && lg_b > kLog0Threshold) ? "
         "expf(fminf(lg_b, 0.0f)) : 0.0f) +\n"
         "                ((live && lg_l > kLog0Threshold) ? "
         "expf(fminf(lg_l, 0.0f)) : 0.0f);\n"),
        ("  float r_next = 0.0f;  // beta(d+1)'s offset\n",
         "  float r_next = 0.0f;  // beta(d+1)'s offset\n"
         "  float sink = 0.0f;\n"),
        (_P_K9_END,
         _P_K9_END[:-1] + "  if (sink == 1.2345f) gb[base] = sink;\n}")],
    "no posteriors": [(
        "      if (in_lattice) {\n", "      if (false) {\n")],
    "no exp, log1p": [(
        "  const float out = ms + log1pf(expf(d));\n",
        "  const float out = ms + 0.5f * d;\n")],
    "block max without its barrier": [(
        "  __syncthreads();\n  float m = red[0];\n", "  float m = red[0];\n")],
}
# Where a diagonal's cycles go in the parent: clock stamps, each taken when
# the value it names is ready, summed over the diagonals by thread 0 of
# sequence 0 and written over the first words of its tape (K8) or of its
# blank posteriors (K9); segment: the stamp that ends it.
PARENT_SEGMENTS = {
    "alpha": ("plane loads", "logaddexp2", "block max", "stores, barrier"),
    "post": ("plane loads", "posteriors", "beta logaddexp2s", "block max",
             "row write, barrier")}
PROBE_PARENT = [
    ("constexpr int kMaxThreads = 1024;\n",
     "constexpr int kMaxThreads = 1024;\n" + _STAMP),
    # K8
    ("  float r = 0.0f;\n  for (int d = 1; d < d_total; ++d) {",
     "  float r = 0.0f;\n  long long pf[5] = {0, 0, 0, 0, 0};\n"
     "  long long c0 = clock64(), c1 = c0, c2 = c0;\n"
     "  for (int d = 1; d < d_total; ++d) {"),
    ("      const float v = logaddexp2(a[u + 1] + skb, a[u] + skl);\n",
     "      if (u == threadIdx.x) c1 = stamp_after(skb + skl);\n"
     "      const float v = logaddexp2(a[u + 1] + skb, a[u] + skl);\n"),
    ("    const float m = renorm_shift(block_max(lmax, red));  // a[] reads "
     "done\n    float* row",
     "    c2 = stamp_after(lmax);\n"
     "    const float m = renorm_shift(block_max(lmax, red));  // a[] reads "
     "done\n    const long long c3 = stamp_after(m);\n"
     "    pf[0] += c1 - c0; pf[1] += c2 - c1; pf[2] += c3 - c2;\n"
     "    float* row"),
    ("    if (threadIdx.x == 0) rcum[(size_t)d * n_seq + n] = r;\n"
     "    __syncthreads();\n  }\n}",
     "    if (threadIdx.x == 0) rcum[(size_t)d * n_seq + n] = r;\n"
     "    __syncthreads();\n    const long long c4 = clock64();\n"
     "    pf[3] += c4 - c3; c0 = c4;\n  }\n"
     "  if (n == 0 && threadIdx.x == 0)\n"
     "    for (int i = 0; i < 4; ++i)\n"
     "      reinterpret_cast<long long*>(tape)[i] = pf[i];\n}"),
    # K9
    ("  float r_next = 0.0f;  // beta(d+1)'s offset\n",
     "  float r_next = 0.0f;  // beta(d+1)'s offset\n"
     "  long long pf[5] = {0, 0, 0, 0, 0};\n"
     "  long long c0 = clock64(), c1 = c0, c2 = c0, c3 = c0;\n"),
    ("      const float b_nx = bn[u];\n",
     "      if (u == threadIdx.x) c1 = stamp_after(skb + skl);\n"
     "      const float b_nx = bn[u];\n"),
    ("      // beta on diagonal d, the terminal blank injected on d's scale\n",
     "      if (u == threadIdx.x) c2 = clock64();\n"
     "      // beta on diagonal d, the terminal blank injected on d's "
     "scale\n"),
    ("    const float m = renorm_shift(block_max(lmax, red));  // bn[] "
     "reads done\n",
     "    c3 = stamp_after(lmax);\n"
     "    const float m = renorm_shift(block_max(lmax, red));  // bn[] "
     "reads done\n    const long long c4 = stamp_after(m);\n"
     "    pf[0] += c1 - c0; pf[1] += c2 - c1; pf[2] += c3 - c2;"
     " pf[3] += c4 - c3;\n"),
    (_P_K9_END,
     "    r_next = r_next + m;\n    __syncthreads();\n"
     "    const long long c5 = clock64();\n    pf[4] += c5 - c4; c0 = c5;\n"
     "  }\n"
     "  if (n == 0 && threadIdx.x == 0)\n"
     "    for (int i = 0; i < 5; ++i)\n"
     "      reinterpret_cast<long long*>(gb)[i] = pf[i];\n}"),
]
_K8_READ = ("  // the entries of diagonal d (d = 1 first), read a diagonal "
            "ahead: the\n  // copies of d + 1 were started D - 2 diagonals "
            "before d\n")
_BETA_READ = ("  // the entries of the k-th diagonal d = D-1-k, read a "
              "diagonal ahead\n")
_READ_BODY = (
    "  float eb[R], el[R];\n"
    "  auto read = [&](int s) {\n")
_READ_CONST = (
    "  float eb[R], el[R];\n"
    "  auto read = [&](int s) {\n"
    "#pragma unroll\n"
    "    for (int j = 0; j < R; ++j) {\n"
    "      eb[j] = -0.5f - 1e-3f * (lane_u<R>(j) + s);\n"
    "      el[j] = -0.7f - 1e-3f * (lane_u<R>(j) + s);\n"
    "    }\n"
    "    return;\n")
_FLAGS_INIT = (
    "  for (int i = threadIdx.x; i < 4 * (blockDim.x >> 5); i += "
    "blockDim.x)\n"
    "    reinterpret_cast<unsigned long long*>(sl.red)[i] = ~0ull;\n"
    "  __syncthreads();\n")
# The kernels at any plan: the C check takes R = 1..8 lanes a thread at one
# warp, 1, 2, 4 or 8 over several, and rings of 2, 4 or 8 diagonals, and
# every such kernel is instantiated (the plans any_plan gives)
_PLAN_CHECK = (
    "  long bytes = 4 * (2 * (long)up + 33);\n"
    "  int r = 0, w = 32, d = 0;\n"
    "  if (up <= kMaxThreads * kMaxLanes) {\n"
    "    r = 1;\n"
    "    while ((up + r - 1) / r > kMaxThreads) r *= 2;\n"
    "    w = ((up + r - 1) / r + 31) / 32;\n"
    "    d = r < kMaxLanes ? kRing : 2;\n"
    "    bytes = 4 * (8L * w + (long)d * 2 * r * 32 * w);\n"
    "  }\n"
    "  return up >= 1 && lanes == r && warps == w && ring == d && smem == "
    "bytes &&\n"
    "         bytes <= kSmemLimit;\n")
_PICK = (
    "auto pick(int lanes, bool one_warp) {\n"
    "  if (one_warp) return K<1, kRing, true>::fn();\n"
    "  switch (lanes) {\n"
    "    case 1: return K<1, kRing, false>::fn();\n"
    "    case 2: return K<2, kRing, false>::fn();\n"
    "    case 4: return K<4, kRing, false>::fn();\n"
    "    default: return K<kMaxLanes, 2, false>::fn();\n"
    "  }\n"
    "}\n")
ANY_PLAN = [
    (_PLAN_CHECK,
     "  if (up < 1 || lanes < 1 || lanes > kMaxLanes || warps > 32 ||\n"
     "      warps != ((up + lanes - 1) / lanes + 31) / 32)\n"
     "    return false;\n"
     "  if (warps > 1 && lanes != 1 && lanes != 2 && lanes != 4 && "
     "lanes != 8)\n"
     "    return false;\n"
     "  const long bytes = 4 * (8L * warps + (long)ring * 2 * lanes * 32 * "
     "warps);\n"
     "  return (ring == 2 || ring == 4 || ring == 8) && bytes == smem &&\n"
     "         bytes <= kSmemLimit;\n"),
    (_PICK,
     "auto pick(int lanes, int ring, bool one_warp) {\n"
     "#define E2E_RING(R, W) \\\n"
     "  (ring == 2 ? K<R, 2, W>::fn() : ring == 4 ? K<R, 4, W>::fn() \\\n"
     "             : K<R, 8, W>::fn())\n"
     "  if (one_warp) {\n"
     "    switch (lanes) {\n"
     + "".join(f"      case {r}: return E2E_RING({r}, true);\n"
               for r in range(1, 8)) +
     "      default: return E2E_RING(8, true);\n"
     "    }\n"
     "  }\n"
     "  return lanes == 1 ? E2E_RING(1, false) : lanes == 2 ? "
     "E2E_RING(2, false)\n"
     "         : lanes == 4 ? E2E_RING(4, false) : E2E_RING(8, false);\n"
     "#undef E2E_RING\n"
     "}\n"),
    ("pick<Alpha>(lanes, warps == 1)", "pick<Alpha>(lanes, ring, warps == 1)"),
    ("pick<Beta>(lanes, warps == 1)", "pick<Beta>(lanes, ring, warps == 1)")]
# name: [(text, replacement)] on csrc/rnnt_loss.cu
NEW = {
    "no plane loads": [
        ("      cp_async4(st + j * sl.entry, skb + row + ib[j]);\n"
         "      cp_async4(st + (R + j) * sl.entry, skl + row + il[j]);\n", ""),
        ("      cp_async4(st + j * sl.entry, skb + row + ix[j]);\n"
         "      cp_async4(st + (R + j) * sl.entry, skl + row + ix[j]);\n", ""),
        (_K8_READ + _READ_BODY, _K8_READ + _READ_CONST),
        (_BETA_READ + _READ_BODY, _BETA_READ + _READ_CONST)],
    # each warp's max and edge value as a 64-bit word tagged with the
    # diagonal, read by polling the slot: no block barrier
    "flags in place of the barrier": [(
        "    float* red = slots + (d & 1) * 2 * warps;  // [warps] maxima, "
        "then edges\n"
        "    if (lane == 0) red[warp] = lmax;\n"
        "    if (kLower && lane == 31) red[warps + warp] = x[R - 1];\n"
        "    if (!kLower && lane == 0) red[warps + warp] = x[0];\n"
        "    __syncthreads();\n"
        "    lmax = warp_max(lane < warps ? red[lane] : kLog0);\n"
        "    if (kLower && warp > 0) edge = red[warps + warp - 1];\n"
        "    if (!kLower && warp + 1 < warps) edge = red[warps + warp + 1];\n",
        "    volatile unsigned long long* red =\n"
        "        reinterpret_cast<unsigned long long*>(slots) + (d & 1) * 2 "
        "* warps;\n"
        "    const unsigned long long tag = (unsigned long long)(unsigned)d "
        "<< 32;\n"
        "    auto poll = [&](int i) {\n"
        "      unsigned long long w;\n"
        "      do { w = red[i]; } while ((w >> 32) != (unsigned)d);\n"
        "      return __uint_as_float((unsigned)w);\n"
        "    };\n"
        "    if (lane == 0) red[warp] = tag | __float_as_uint(lmax);\n"
        "    if (kLower && lane == 31)\n"
        "      red[warps + warp] = tag | __float_as_uint(x[R - 1]);\n"
        "    if (!kLower && lane == 0)\n"
        "      red[warps + warp] = tag | __float_as_uint(x[0]);\n"
        "    lmax = warp_max(lane < warps ? poll(lane) : kLog0);\n"
        "    if (kLower && warp > 0 && lane == 0) edge = poll(warps + warp "
        "- 1);\n"
        "    if (!kLower && warp + 1 < warps && lane == 31)\n"
        "      edge = poll(warps + warp + 1);\n"),
        (_K8_READ, _FLAGS_INIT + _K8_READ),
        (_BETA_READ, _FLAGS_INIT + _BETA_READ)],
    "no tape stores": [
        ("    if (u < up) rows[row * up + u] = v[j];\n", ""),
        ("  if (threadIdx.x == 0) offs[row] = off;\n", "")],
    "no skew": [
        ("  cudaError_t err = skew(b, lp, sk, l);\n"
         "  if (err != cudaSuccess) return (int)err;\n",
         "  cudaError_t err = cudaSuccess;\n"),
        ("  cudaError_t err = skew(b, lp, sk, l);\n"
         "  if (err == cudaSuccess)\n",
         "  cudaError_t err = cudaSuccess;\n  if (err == cudaSuccess)\n")],
    "no posterior pass": [(
        "  rnnt_post_kernel<<<blocks", "  if (blocks.x == 0) "
        "rnnt_post_kernel<<<blocks")],
    "no exp, log1p": PARENT["no exp, log1p"],
    "no terminal blank": [(
        "      if (d == d_term && u == u_term) v = logaddexp2(v, eb[j] - "
        "r_next);\n", "")],
    "K8's rows stored a diagonal late": [
        ("    lmax = row_max<R, kOneWarp, true>(lmax, x, sl.red, d, edge);\n",
         "    lmax = row_max<R, kOneWarp, true>(lmax, x, sl.red, d, edge);\n"
         "    if (d > 1) store_row(tape, rcum, a, r, d - 1, n_seq, n, up);\n"),
        ("    r = r + m;\n    store_row(tape, rcum, a, r, d, n_seq, n, up);\n"
         "  }\n  cp_async_wait<0>();\n",
         "    r = r + m;\n  }\n  if (d_total > 1) store_row(tape, rcum, a, r, "
         "d_total - 1, n_seq, n, up);\n  cp_async_wait<0>();\n")],
    # the same outputs, u = i + 32 j (one warp only)
    "interleaved lanes": ANY_PLAN + [
        ("  return R * threadIdx.x + j;\n",
         "  return threadIdx.x + 32 * j;\n"),
        ("  const float up1 = __shfl_up_sync(kFull, x[R - 1], 1);\n"
         "  xn[0] = (threadIdx.x & 31) == 0 ? edge : up1;\n"
         "#pragma unroll\n"
         "  for (int j = 1; j < R; ++j) xn[j] = x[j - 1];\n",
         "  const int lane = threadIdx.x & 31;\n"
         "  float rot[R];\n"
         "#pragma unroll\n"
         "  for (int j = 0; j < R; ++j)\n"
         "    rot[j] = __shfl_sync(kFull, x[j], (lane + 31) & 31);\n"
         "  xn[0] = lane == 0 ? edge : rot[0];\n"
         "#pragma unroll\n"
         "  for (int j = 1; j < R; ++j) xn[j] = lane == 0 ? rot[j - 1] "
         ": rot[j];\n"),
        ("  const float dn1 = __shfl_down_sync(kFull, x[0], 1);\n"
         "#pragma unroll\n"
         "  for (int j = 0; j < R - 1; ++j) xn[j] = x[j + 1];\n"
         "  xn[R - 1] = (threadIdx.x & 31) == 31 ? edge : dn1;\n",
         "  const int lane = threadIdx.x & 31;\n"
         "  float rot[R];\n"
         "#pragma unroll\n"
         "  for (int j = 0; j < R; ++j)\n"
         "    rot[j] = __shfl_sync(kFull, x[j], (lane + 1) & 31);\n"
         "#pragma unroll\n"
         "  for (int j = 0; j < R - 1; ++j) xn[j] = lane == 31 ? rot[j + 1] "
         ": rot[j];\n"
         "  xn[R - 1] = lane == 31 ? edge : rot[R - 1];\n")],
}
# variants run at one warp's plan (ceil(U+1 / 32) lanes a thread), their
# outputs compared with the whole kernels' bit for bit
ONE_WARP = ("interleaved lanes",)
NEW_SEGMENTS = {
    kind: ("copy issue", "logaddexp2s", "next entries", "row max",
           "stores, shift") for kind in ("alpha", "post")}
_PF = ("  long long pf[6] = {0, 0, 0, 0, 0, 0};\n"
       "  long long c0 = clock64();\n")
_PF_SUM = ("    pf[0] += c1 - c0; pf[1] += c2 - c1; pf[2] += c3 - c2;\n"
           "    pf[3] += c4 - c3; pf[4] += c5 - c4; c0 = c5;\n")
_PF_OUT = ("  if (n == 0 && threadIdx.x == 0)\n"
           "    for (int i = 0; i < 5; ++i)\n"
           "      reinterpret_cast<long long*>({})[i] = pf[i];\n}}")


def _probe_loop(copy, read, kind, end, tail, last, out):
    """The clock stamps of one wavefront kernel's diagonal loop: `end` its
    last statement, `tail` the kernel's statements after the loop."""
    row_max = (f"    lmax = row_max<R, kOneWarp, {kind}>(lmax, x, sl.red, d, "
               "edge);\n")
    return [
        (copy + "    cp_async_commit();\n",
         copy + "    cp_async_commit();\n"
         "    const long long c1 = clock64();\n"),
        (f"    {read}\n    float xn[R], edge;\n" + row_max,
         "    const long long c2 = stamp_after(lmax);\n"
         f"    {read}\n"
         "    const long long c3 = stamp_after(eb[R - 1] + el[R - 1]);\n"
         "    float xn[R], edge;\n" + row_max
         + "    const long long c4 = stamp_after(lmax);\n"),
        (end + "  }\n" + tail + "  cp_async_wait<0>();\n}",
         end + f"    const long long c5 = stamp_after({last});\n" + _PF_SUM
         + "  }\n" + tail + "  cp_async_wait<0>();\n" + _PF_OUT.format(out))]


PROBE_NEW = [
    ("constexpr long kSmemLimit = 232448;  // a block's shared memory on the "
     "H100\n",
     "constexpr long kSmemLimit = 232448;  // a block's shared memory on the "
     "H100\n" + _STAMP),
    ("  read(0);\n  float r = 0.0f;\n",
     "  read(0);\n  float r = 0.0f;\n" + _PF),
    ("  read(0);\n  float r_next = 0.0f;  // beta(d+1)'s offset\n",
     "  read(0);\n  float r_next = 0.0f;  // beta(d+1)'s offset\n" + _PF),
    *_probe_loop(
        "    copy(min(d + D - 1, d_total - 1), (d + D - 2) % D);\n",
        "read(d % D);", "true",
        "    store_row(tape, rcum, a, r, d, n_seq, n, up);\n", "",
        "r + a[R - 1] + p[0]", "tape"),
    *_probe_loop(
        "    copy(max(d - D + 1, 0), (k + D - 1) % D);\n",
        "read((k + 1) % D);", "false", "    r_next = r_next + m;\n",
        "  store_row(btape, brcum, bn, r_next, 0, n_seq, n, up);\n",
        "r_next + bn[R - 1] + bs[0]", "btape"),
]
# name: the kernels at another plan (any_plan's, built with ANY_PLAN)
PLANS = {"ring depth 2": {"ring": 2}, "ring depth 8": {"ring": 8},
         **{f"{r} lanes a thread": {"lanes": r} for r in (2, 3, 4, 5)}}
SMEM_LIMIT = 232448  # a block's shared memory on the H100


def any_plan(up: int, lanes: int | None = None,
             ring: int | None = None) -> dict:
    """wavefront_plan(up) with `lanes` a thread and a ring of `ring` in
    place of its own (the plans an ANY_PLAN build takes).  Raises where
    that build has no such kernel or its shared memory does not fit."""
    plan = rnnt_loss_cuda.wavefront_plan(up)
    lanes, ring = lanes or plan["lanes"], ring or plan["ring"]
    warps = -(-(-(-up // lanes)) // 32)
    smem = 4 * (8 * warps + ring * 2 * lanes * 32 * warps)
    if (not 1 <= lanes <= 8 or warps > 32 or ring not in (2, 4, 8)
            or (warps > 1 and lanes not in (1, 2, 4, 8))
            or smem > SMEM_LIMIT):
        raise ValueError(f"no plan of {lanes} lanes a thread and a ring of "
                         f"{ring} at U+1={up}")
    return {"lanes": lanes, "warps": warps, "ring": ring, "smem": smem}


def is_new(src: str) -> bool:
    """Does the source take wavefront_plan's launch plan?"""
    return "int lanes, int warps, int ring" in src


def problem(name, dev, seed=0):
    """(b_pl, l_pl (N, T, U+1), il, ul (N,) int64) on dev from a seed: the
    blank and label log-probs of random logits, labels past ul
    log-zero."""
    b, t, up, il = SHAPES[name]
    gen = torch.Generator(device=dev).manual_seed(seed)
    lp = torch.log_softmax(torch.randn(b, t, up, V, generator=gen,
                                       device=dev), -1)
    y = torch.randint(1, V, (b, up), generator=gen, device=dev)
    il = torch.tensor(il, device=dev)
    ul = torch.minimum(il // 5, torch.tensor(up - 1, device=dev))
    b_pl, l_pl = rnnt_loss_plain.planes(lp, y, ul, 0)
    return b_pl.contiguous(), l_pl.contiguous(), il, ul


def runner(lib, new, data, post, plan=None):
    """A function that launches K8 (post False) or K9 of `lib` once on
    data into fixed output buffers and returns them ((tape, rcum) or
    (gb, gl)); `new`: lib takes a launch plan (`plan`, by default
    wavefront_plan's) and a workspace (the function's `work`).  K9's
    inputs are data's K9 inputs (see k9_inputs)."""
    b_pl, l_pl = data[:2]
    n, t_max, up = b_pl.shape
    dev = b_pl.device
    kind = "post" if post else "alpha"
    fn = getattr(lib, f"e2e_rnnt_{kind}_f32")
    fn.restype = ctypes.c_int
    work = None
    if new:
        fn.argtypes = cuda_build._SIGNATURES[f"e2e_rnnt_{kind}_f32"]
        p = plan or rnnt_loss_cuda.wavefront_plan(up)
        work = torch.empty(max(rnnt_loss_cuda.workspace(n, t_max, up, p,
                                                        post), 1),
                           device=dev)
    else:
        fn.argtypes = OLD_SIG[kind]
    if post:
        out = (torch.empty_like(b_pl), torch.empty_like(b_pl))
        ptrs = (b_pl, l_pl, *data[4], *out) + ((work,) if new else ())
    else:
        out = (torch.empty((t_max + up - 1, n, up), device=dev),
               torch.empty((t_max + up - 1, n), device=dev))
        ptrs = (b_pl, l_pl) + ((work,) if new else ()) + out
    args = [x.data_ptr() for x in ptrs] + [n, t_max, up]
    if new:
        args += [p[k] for k in ("lanes", "warps", "ring", "smem")]

    def launch():
        stream = torch.cuda.current_stream(dev).cuda_stream
        cuda_build.check(fn(*args, stream), f"K{9 if post else 8}")
        return out

    launch.work = work
    return launch


def k9_inputs(lib, new, data):
    """K9's inputs on data: K8's tape and offsets (from lib), the int32
    lengths and the split logZ."""
    b_pl, _, il, ul = data
    tape, rcum = (x.clone() for x in runner(lib, new, data, False)())
    zs, zo = rnnt_loss_plain.log_z(b_pl, tape, rcum, il, ul)
    return (tape, rcum, il.to(torch.int32), ul.to(torch.int32), zs, zo)


def equal_outputs(a, b) -> bool:
    """Bit for bit (a float's sign of zero included)."""
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def probe(lib, new, data, post) -> dict:
    """Cycles a diagonal in each segment (a PROBE build), thread 0 of
    sequence 0: written over K8's tape, the parent K9's blank posteriors,
    or the beta tape in K9's workspace."""
    fn = runner(lib, new, data, post)
    out = fn()[0]
    if new and post:  # the beta tape, at the workspace's start
        out = fn.work
    torch.cuda.synchronize()
    kind = "post" if post else "alpha"
    names = (NEW_SEGMENTS if new else PARENT_SEGMENTS)[kind]
    cycles = out.flatten()[:2 * len(names)].view(torch.int64).tolist()
    diagonals = sum(data[0].shape[1:]) - 1
    return {k: c / diagonals for k, c in zip(names, cycles)}


def workspace_bytes() -> dict:
    """The wrappers' workspace (rnnt_loss_cuda.workspace) in bytes at
    WORKSPACE_SHAPES, K8's and K9's, beside the two planes'."""
    table = {}
    for name, (n, t, up) in WORKSPACE_SHAPES.items():
        plan = rnnt_loss_cuda.wavefront_plan(up)
        table[name] = {
            "K8": 4 * rnnt_loss_cuda.workspace(n, t, up, plan, False),
            "K9": 4 * rnnt_loss_cuda.workspace(n, t, up, plan, True),
            "planes": 2 * 4 * n * t * up}
    return table


@contextlib.contextmanager
def parent_wrappers(lib):
    """rnnt_loss_cuda.alpha and .posteriors replaced, while the context
    lasts, by calls of the parent kernels in lib (build_reference's), which
    take no workspace; their outputs are allocated as the wrappers'."""
    def alpha(b_pl, l_pl):
        return runner(lib, False, (b_pl.contiguous(), l_pl.contiguous()),
                      False)()

    def posteriors(b_pl, l_pl, tape, rcum, il, ul, z_small, z_off):
        dev = b_pl.device
        k9 = (tape.contiguous(), rcum.contiguous(), il.to(dev, torch.int32),
              ul.to(dev, torch.int32), z_small.float().contiguous(),
              z_off.float().contiguous())
        return runner(lib, False, (b_pl.contiguous(), l_pl.contiguous(),
                                   None, None, k9), True)()

    saved = rnnt_loss_cuda.alpha, rnnt_loss_cuda.posteriors
    rnnt_loss_cuda.alpha, rnnt_loss_cuda.posteriors = alpha, posteriors
    try:
        yield
    finally:
        rnnt_loss_cuda.alpha, rnnt_loss_cuda.posteriors = saved


def peak_mib(fn) -> float:
    """The most memory fn() holds on the card above what was allocated
    before it, in MiB (its second call; the first warms the caches)."""
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def loss_paths(dev, seed=0) -> dict:
    """name: a loss + gradient call that runs K8 and K9: the transducer
    loss from (B, T, U+1, V=32) logits at the training lattice, and the
    fused joint's NLL at the bench lattice (J=128, V=32768, bench.py's
    draw), both from a seed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, t, up, il = SHAPES["main"]
    x = torch.randn(b, t, up, V, generator=gen, device=dev,
                    requires_grad=True)
    y = torch.randint(1, V, (b, up - 1), generator=gen, device=dev)
    il = torch.tensor(il, device=dev)
    ul = torch.minimum(il // 5, torch.tensor(up - 1, device=dev))

    def transducer():
        torch.autograd.grad(rnnt_loss(x, y, il, ul, reduction="sum"), x)

    b, t, up, fil = SHAPES["bench"]
    params = [torch.randn(b, t, FUSED_J, generator=gen, device=dev),
              torch.randn(b, up, FUSED_J, generator=gen, device=dev),
              torch.randn(FUSED_J, FUSED_V, generator=gen, device=dev)
              / FUSED_J ** 0.5, torch.zeros(FUSED_V, device=dev)]
    params = [p.requires_grad_(True) for p in params]
    fy = torch.randint(1, FUSED_V, (b, up - 1), generator=gen, device=dev)
    flens = (torch.tensor(fil, device=dev),
             torch.full((b,), up - 1, device=dev))

    def fused():
        nll = rnnt_nll_fused_pallas(*params, fy, *flens)
        torch.autograd.grad(nll.sum(), params)

    return {"transducer loss + grad (B=8, T'=750, U+1=151, V=32)": transducer,
            "fused joint NLL + grad (B=8, T=400, U+1=81, J=128, V=32768)":
                fused}


def peak_memory(lib, dev) -> dict:
    """Peak MiB above the inputs of each loss path, with the kernels and
    with the parent kernels (lib) in their place, in turns (kernels,
    parent, parent, kernels), and the wrappers' launches in each (two
    calls a turn)."""
    out = {}
    for name, fn in loss_paths(dev).items():
        row = {"kernels": [], "parent": [], "kernels launches": [],
               "parent launches": []}
        for who in ("kernels", "parent", "parent", "kernels"):
            before = sum(rnnt_loss_cuda.launches.values())
            with (parent_wrappers(lib) if who == "parent"
                  else contextlib.nullcontext()):
                row[who].append(peak_mib(fn))
            row[f"{who} launches"].append(
                sum(rnnt_loss_cuda.launches.values()) - before)
        out[name] = row
    return out


def build_reference(out_dir: Path):
    """The parent kernels (tools/rnnt_loss_reference.cu) as a ctypes
    library in out_dir, and their ptxas lines."""
    return build({"parent": REFERENCE.read_text()}, out_dir,
                 KERNEL[False])["parent"]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, nargs="*",
                        default=[REFERENCE],
                        help="other versions of rnnt_loss.cu")
    parser.add_argument("--out", type=Path, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rnnt_wavefront_breakdown: needs a CUDA device")
    dev = torch.device("cuda", 0)
    src = (cuda_build.CSRC / "rnnt_loss.cu").read_text()
    parent = REFERENCE.read_text()
    variants = {"whole": src}
    if is_new(src):
        variants["any plan"] = patched(src, ANY_PLAN)
        variants["clock probe"] = patched(src, PROBE_NEW)
        variants.update({name: patched(src, p) for name, p in NEW.items()})
    variants["parent clock probe"] = patched(parent, PROBE_PARENT)
    variants.update({f"parent, {name}": patched(parent, p)
                     for name, p in PARENT.items()})
    turns = ["whole"] + [f"vs {p.name}" for p in args.against]
    variants.update({f"vs {p.name}": p.read_text() for p in args.against})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    new = {name: is_new(text) for name, text in variants.items()}
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            builds = [pool.submit(
                build, {k: v for k, v in variants.items() if new[k] == kind},
                Path(tmp, str(kind)), KERNEL[kind]) for kind in (False, True)]
            libs = {k: v for b in builds for k, v in b.result().items()}
        result = {"card": card, "calls": CALLS, "ptxas": libs["whole"][1],
                  "shapes": {}}
        for name in turns[1:]:
            result[f"{name} ptxas"] = libs[name][1]
        for shape, (b, t, up, _) in SHAPES.items():
            data = problem(shape, dev)
            data = (*data, k9_inputs(libs["whole"][0], new["whole"], data))
            row = {"B, T, U+1": [b, t, up], "diagonals": t + up - 1}
            if new["whole"]:
                row["plan"] = rnnt_loss_cuda.wavefront_plan(up)
            one_warp = {"lanes": -(-up // 32)}
            for post, k in ((False, "K8"), (True, "K9")):
                fns = {name: runner(lib, new[name], data, post,
                                    any_plan(up, **one_warp)
                                    if name in ONE_WARP else None)
                       for name, (lib, _) in libs.items()}
                for name, fn in fns.items():
                    if name.endswith("clock probe"):
                        row[f"{k} {name}, cycles a diagonal"] = probe(
                            libs[name][0], new[name], data, post)
                    elif name not in turns:
                        row[f"{k} {name}"] = device_ms(fn, CALLS)
                same = {name: fns[name] for name in ONE_WARP + ("any plan",)
                        if name in fns}
                if new["whole"]:
                    for name, plan in {**PLANS, "one warp": one_warp}.items():
                        try:
                            plan = any_plan(up, **plan)
                        except ValueError:  # no such plan at this shape
                            continue
                        fn = runner(libs["any plan"][0], True, data, post,
                                    plan)
                        row[f"{k} any plan, {name}"] = device_ms(fn, CALLS)
                        same[f"any plan, {name}"] = fn
                for name, fn in same.items():
                    row[f"{k} {name} bit-equal"] = equal_outputs(
                        fns["whole"](), fn())
                for name in turns + turns[::-1]:
                    row.setdefault(f"{k} {name}", []).append(
                        device_ms(fns[name], CALLS))
                for name in turns[:2]:
                    mhz, watts, temp = under_load(fns[name])
                    row[f"{k} {name} MHz, W, C"] = (mhz, watts, temp)
                    ms = min(row[f"{k} {name}"])[0]
                    row[f"{k} {name} cycles a diagonal"] = (
                        ms * 1e-3 * mhz * 1e6 / (t + up - 1))
                for name in turns[1:]:  # bit-equal to the whole kernel's
                    row[f"{k} {name} bit-equal"] = equal_outputs(
                        fns["whole"](), fns[name]())
            result["shapes"][shape] = row
            del data, fns
        result["workspace bytes"] = workspace_bytes()
        ref = next((name for name in turns[1:] if not new[name]), None)
        if ref:  # an --against file with the parent's entry points
            result["peak MiB"] = peak_memory(libs[ref][0], dev)
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    bad = [f"{shape}: {k}" for shape, row in result["shapes"].items()
           for k, x in row.items() if k.endswith("bit-equal") and not x]
    if bad:
        raise SystemExit(f"outputs differ from the whole kernel's: {bad}")


if __name__ == "__main__":
    main()
