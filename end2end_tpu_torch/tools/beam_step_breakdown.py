"""Where the beam step's time goes (K4-K7, csrc/beam_step.cu): time
text-patched copies of the warp-per-sequence kernel it replaced, and time
the kernel against that one in turns, on one GPU.

    python -m end2end_tpu_torch.tools.beam_step_breakdown [--against FILE...]
        [--out FILE]

The sibling of ctc_alpha_breakdown (K1), with its build, timing and
clock/power sampler.  The parent is tools/beam_step_reference.cu, the
warp-per-sequence kernel kept verbatim: lane w owns beam w, the frame's
inputs are loaded when the frame starts, the stay term and the merge are
serial loops over shared memory, and top-W is W rounds of a strided
rescan plus a shuffle butterfly.  Each variant of it is its source with
text patches applied (no switch lives in the kernel; PARENT lists them):
the whole kernel; without the per-frame loads (frame 0's inputs are kept
in shared memory and fed to every frame); without the stay search (one
slot read in place of the ks-slot loop); without the merge loops (beam 0
as the only candidate parent, slot 0 the only removal); top-W in one
round (every lane takes the first pick, so W-1 rounds go); the rounds
without their shuffle butterfly (each lane keeps its own best); the
rounds' rescan of one slot a lane; and, with an increment table, without
the increment loads.  The kernel of csrc/beam_step.cu gets the same
treatment (NEW): its top-W by the sorted lanes' heads alone or by
rounds alone, without the stay or merge search, the code stores, the
frame wait, the prefetch's issue or the mid-frame __syncwarp, and its
laddexp2 by fast intrinsics; and a clock probe (PROBE) sums lane 0's
cycles a frame in each part of the frame loop.  Variants without a part
give other codes: they time the rest, their picks still feed the state
so that ptxas keeps the work.  A small kernel (LATENCY) measures the
cycles a step of dependent chains of the operations the frame loop
strings together: shuffles, redux.sync, ballots, shared loads with and
without a __syncwarp, a cp.async issue or a store, laddexp2.

Then the kernel, the parent and any --against files (other beam_step.cu
versions) run in turns, each once in order and then in the reverse
order, and their backpointer codes, scores and 10-field states are
compared bit for bit with the kernel's (and the kernel's with three
more runs of its own).  Problems (peaked
lattices from a seed, the top-k by its plain version): the serving
slice's (T'=750, B=8 with the lengths of 30/22/15 s requests, V=32, W=8,
K=16, ks=24) without an LM (K4) and with a bigram increment table (K5);
bench.py's beam-16 row (B=32, T=1000, V=1024, W=16, K=32, ks=40; K4);
and the chunked decode's first 128-frame chunk, resumed from the empty
prefix (B=32, W=8, K=ks=16): V=29 without increments (K7) and V=1024
with a 64-row class-keyed table (K6).  Times are device times
(`device_ms`: CALLS calls in a CUDA graph) and microseconds a frame
(over the longest sequence's frames); the card's SM clock, power and
temperature are sampled while the kernel and the parent run back to
back.  Prints one JSON object with the card's name and power limit (and
writes it to --out if given).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..ops import beam_search_cuda, topk_cuda
from ..utils import cuda_build
from .joint_dw_breakdown import build, device_ms, patched, under_load

REFERENCE = Path(__file__).resolve().with_name("beam_step_reference.cu")
KERNEL = "beam_step"  # every instantiation's ptxas lines
CALLS = 10
# name: (T, B, V, W, K, ks, mode); mode: "K4" none, "K5" a (V+1, V)
# increment table, "K6" a 64-row class-keyed table, "K7" resume
PROBLEMS = {
    "main K4": (750, 8, 32, 8, 16, 24, "K4"),
    "main K5": (750, 8, 32, 8, 16, 24, "K5"),
    "beam16 K4": (1000, 32, 1024, 16, 32, 40, "K4"),
    "chunk K7": (128, 32, 29, 8, 16, 16, "K7"),
    "chunk K6": (128, 32, 1024, 8, 16, 16, "K6"),
}
BREAKDOWN = ("main K4", "main K5", "beam16 K4")  # the parent's variants

_ROUND = ("      for (int c = lane, w = w0, k = k0; c < n_ext; c += 32) {\n"
          "        const float rank")
# name: [(text, replacement)] on the parent; every text occurs once
PARENT = {
    "no frame loads": [
        ("  for (int t = 0; t < t_max; ++t) {\n",
         "  for (int j = lane; j < ks; j += 32) {\n"
         "    s_lpk[j] = lpk[(long long)seq * ks + j];\n"
         "    s_ck[j] = ck[(long long)seq * ks + j];\n"
         "  }\n"
         "  const float lpb0 = lpb[seq];\n"
         "  for (int t = 0; t < t_max; ++t) {\n"),
        ("    for (int j = lane; j < ks; j += 32) {\n"
         "      s_lpk[j] = lpk[row * ks + j];\n"
         "      s_ck[j] = ck[row * ks + j];\n"
         "    }\n"
         "    const float lpb_t = lpb[row];\n",
         "    const float lpb_t = lpb0;\n")],
    "no stay search": [(
        "    for (int j = 0; j < ks; ++j)\n"
        "      rep = fmaxf(rep, s_ck[j] == last ? s_lpk[j] : kLog0);\n",
        "    rep = fmaxf(rep, s_ck[0] == last ? s_lpk[0] : kLog0);\n")],
    "no merge loops": [
        ("      for (int p = 0; p < W; ++p) {\n", "      {\n"
         "        const int p = 0;\n"),
        ("      for (int k = 0; k < K; ++k) {\n", "      {\n"
         "        const int k = 0;\n")],
    "top-W in one round": [
        ("    for (int r = 0; r < W; ++r) {\n",
         "    for (int r = 0; r < 1; ++r) {\n"),
        ("      if (lane == r) {\n", "      if (act) {\n")],
    "rounds without the shuffles": [(
        "      for (int off = 16; off > 0; off >>= 1) {\n"
        "        const float ov = __shfl_xor_sync(kFull, bv, off);\n"
        "        const int oc = __shfl_xor_sync(kFull, bc, off);\n"
        "        if (before(ov, oc, bv, bc)) {\n"
        "          bv = ov;\n"
        "          bc = oc;\n"
        "        }\n"
        "      }\n", "")],
    "rounds rescan one slot": [(
        _ROUND, _ROUND.replace("c < n_ext;", "c < min(n_ext, 32);"))],
    "no increment loads": [(
        "s_lmt[c] = s_lm[w] + __ldg(inc + (long long)ctx * v + col);",
        "s_lmt[c] = s_lm[w] + 1e-3f * (float)(ctx * v + col);")],
}

# name: [(text, replacement)] on csrc/beam_step.cu (wrong outputs, or
# another reading of the same bits)
NEW = {
    "the sorted heads only": [(
        "        picked = __ballot_sync(kFull, cnt > 1) == 0;\n",
        "        picked = true;\n")],
    "rounds only": [(
        "      if ((uint32_t)(tau >> 32) > kKeyLog0) {\n",
        "      if (false) {\n")],
    "no stay search": [(
        "      for (int w = 0; w < W; w += 4) {\n        const int4 l4",
        "      for (int w = 0; w < 4; w += 4) {\n        const int4 l4")],
    "no merge search": [("      for (int p = 0; p < W; p += 4) {\n",
                         "      for (int p = 0; p < 4; p += 4) {\n")],
    "no bp stores": [(
        "    if (act) bp[((long long)t * W + lane) * n + seq] = my_code;\n",
        "")],
    "no frame wait": [(
        "    cp_async_wait<2 * (kRing - 2)>();  // frame t's inputs have "
        "landed\n", "")],
    "laddexp2 by intrinsics": [("m_safe + log1pf(expf(d));",
                                "m_safe + __logf(1.f + __expf(d));")],
    "no prefetch issue": [(
        "    issue(t + kRing - 1);  // into the stage frame t - 1 left\n", "")],
    "no mid-frame __syncwarp": [(
        "    __syncwarp();  // s_ext, s_rep and s_krep are complete\n", "")],
}
# Where a frame's cycles go: clock stamps in the frame loop, each taken
# when the value it names is ready, summed over the frames by lane 0 of
# sequence 0 and written over the first 16 words of bp (segment: the
# stamp that ends it).
SEGMENTS = ("frame wait", "gathers, stay search, extensions, merge search",
            "merges, stays", "bonuses, composites, heads", "top-W",
            "state gather, publish")
_STAMP = (
    "__device__ __forceinline__ long long stamp_after(uint32_t x) {\n"
    "  long long c;\n"
    "  asm volatile(\"{\\n .reg .pred p;\\n setp.eq.u32 p, %1, "
    "0x7FC00001;\\n mov.u64 %0, %%clock64;\\n @p mov.u64 %0, 0;\\n}\"\n"
    "               : \"=l\"(c) : \"r\"(x));\n"
    "  return c;\n}\n")
PROBE = [
    ("__device__ __forceinline__ void cp_async4(", _STAMP
     + "__device__ __forceinline__ void cp_async4("),
    ("  for (int t = 0; t < n_run; ++t) {\n",
     "  long long prof[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long stamp = clock64();\n"
     "  for (int t = 0; t < n_run; ++t) {\n"),
    ("    const float lpb_t = s_lpb[sg];\n",
     "    const float lpb_t = s_lpb[sg];\n"
     "    const long long c0 = stamp_after(__float_as_uint(lpb_t));\n"
     "    prof[0] += c0 - stamp;\n"),
    ("    const int krep = s_krep[lane];\n",
     "    const int krep = s_krep[lane];\n"
     "    const long long c1 = stamp_after((uint32_t)krep ^ hits);\n"
     "    prof[1] += c1 - c0;\n"),
    ("    const float stay = stay_tot + lm;  // ranked with the bonus\n",
     "    const float stay = stay_tot + lm;  // ranked with the bonus\n"
     "    const long long c2 = stamp_after(__float_as_uint(stay));\n"
     "    prof[2] += c2 - c1;\n"),
    ("    uint64_t head = best(0, true);\n",
     "    uint64_t head = best(0, true);\n"
     "    const long long c3 = stamp_after((uint32_t)head);\n"
     "    prof[3] += c3 - c2;\n"),
    ("    // --- the picks' state, each lane its own",
     "    const long long c4 = stamp_after((uint32_t)my_code);\n"
     "    prof[4] += c4 - c3;\n"
     "    // --- the picks' state, each lane its own"),
    ("    publish();\n  }\n  // frozen frames",
     "    publish();\n"
     "    stamp = stamp_after((uint32_t)len);\n"
     "    prof[5] += stamp - c4;\n  }\n"
     "  if (seq == 0 && lane == 0)\n"
     "    for (int i = 0; i < 8; ++i)\n"
     "      reinterpret_cast<long long*>(bp)[i] = prof[i];\n"
     "  // frozen frames"),
]

# The latency of the steps the frame loop chains, in cycles an iteration
# of a dependent chain of 1,000 (one warp; LATENCY_CHAINS names them).
LATENCY_CHAINS = ("add", "redux.sync max", "ballot", "shfl", "shared load",
                  "shared load + __syncwarp",
                  "shared load + cp.async issue + __syncwarp",
                  "shared load + global store + __syncwarp", "laddexp2",
                  "64-bit max")
LATENCY = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void chains(long long* out, const unsigned* g, unsigned* sink,
                       unsigned seed) {
  __shared__ unsigned s[256], s2[32 * 8];
  const unsigned lane = threadIdx.x;
  for (int i = lane; i < 256; i += 32) s[i] = (i * 7 + 3) & 255;
  __syncwarp();
  unsigned x = lane * seed;
  float f = (float)lane * 1e-3f;
  unsigned long long y = lane * 0x9E3779B97F4A7C15ull;
  long long c[11];
  const int N = 1000;
  c[0] = clock64();
  for (int i = 0; i < N; ++i) x = x * 3 + lane;
  c[1] = clock64();
  for (int i = 0; i < N; ++i) x = __reduce_max_sync(~0u, x ^ lane);
  c[2] = clock64();
  for (int i = 0; i < N; ++i) x += __ballot_sync(~0u, (x + lane) & 1);
  c[3] = clock64();
  for (int i = 0; i < N; ++i) x = __shfl_sync(~0u, x, (x + lane) & 31) + 1;
  c[4] = clock64();
  for (int i = 0; i < N; ++i) x = s[(x + lane) & 255];
  c[5] = clock64();
  for (int i = 0; i < N; ++i) {
    x = s[(x + lane) & 255];
    __syncwarp();
  }
  c[6] = clock64();
  for (int i = 0; i < N; ++i) {
    x = s[(x + lane) & 255];
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
        (unsigned)__cvta_generic_to_shared(&s2[lane + 32 * (i & 7)])),
        "l"(g + ((i * 32 + lane) & 4095)) : "memory");
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    __syncwarp();
  }
  c[7] = clock64();
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  for (int i = 0; i < N; ++i) {
    x = s[(x + lane) & 255];
    sink[(i & 63) * 32 + lane] = x;
    __syncwarp();
  }
  c[8] = clock64();
  for (int i = 0; i < N; ++i) {
    const float m = fmaxf(f, -1.f), d = fmaxf(-fabsf(f + 1.f), -1e30f);
    f = m + log1pf(expf(d)) - 1.f;
  }
  c[9] = clock64();
  for (int i = 0; i < N; ++i) {
    const unsigned long long z = y * 3 + lane;
    y = z > y ? z : y + 1;
  }
  c[10] = clock64();
  if (lane == 0)
    for (int i = 0; i < 10; ++i) out[i] = (c[i + 1] - c[i]) / N;
  sink[lane] = x + __float_as_uint(f) + (unsigned)y + s2[lane];
}
extern "C" int e2e_latency(void* out, const void* g, void* sink,
                           void* stream) {
  chains<<<1, 32, 0, (cudaStream_t)stream>>>(
      (long long*)out, (const unsigned*)g, (unsigned*)sink, 12345u);
  return (int)cudaGetLastError();
}
"""


def latencies(lib, dev) -> dict:
    """Cycles an iteration of each LATENCY chain on the card."""
    out = torch.zeros(16, dtype=torch.int64, device=dev)
    g = torch.arange(4096, dtype=torch.int32, device=dev)
    sink = torch.zeros(64 * 32, dtype=torch.int32, device=dev)
    fn = lib.e2e_latency
    fn.argtypes = (ctypes.c_void_p,) * 4
    fn.restype = ctypes.c_int
    for _ in range(2):  # the second run, warm
        cuda_build.check(fn(out.data_ptr(), g.data_ptr(), sink.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream),
                         "e2e_latency")
    torch.cuda.synchronize()
    return dict(zip(LATENCY_CHAINS, out[:10].tolist()))


def probe(lib, args, kw) -> dict:
    """Cycles a frame in each segment of the kernel's frame loop (the
    PROBE build), for lane 0 of sequence 0."""
    bp = runner(lib, args, kw)()[0]
    torch.cuda.synchronize()
    cycles = bp.flatten()[:16].view(torch.int64).tolist()
    frames = max(min(int(args[3][0]), args[0].shape[0]), 1)
    return {k: round(c / frames, 1) for k, c in zip(SEGMENTS, cycles)}


def _lattice(rng, t, b, v):
    """Peaked log-probs: one dominant token a frame (blank half the
    time) over a noisy background (chip_smoke.peaked_lattice's draw)."""
    x = np.log(0.003 / (v - 1)) + 0.5 * rng.standard_normal((t, b, v))
    ids = np.where(rng.random((t, b)) < 0.5, 0, rng.integers(1, v, (t, b)))
    np.put_along_axis(x, ids[..., None], np.log(0.997), axis=-1)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def problem(name, dev, seed=0):
    """(args, kwargs) of `beam_step` for PROBLEMS[name] on dev: (lpk,
    ck, lpb, il, W, K, s_cap, blank) and the mode's inc, cls_map and
    state_in."""
    t, b, v, W, K, ks, mode = PROBLEMS[name]
    rng = np.random.default_rng(seed)
    lp = torch.from_numpy(_lattice(rng, t, b, v)).to(dev)
    if name.startswith("main"):  # 30, 22 and 15 s requests
        il = np.array([750, 550, 375, 750, 550, 375, 550, 375])
    elif mode in ("K6", "K7"):  # every sequence runs the whole chunk
        il = np.full(b, t)
    else:
        il = rng.integers(t // 2, t + 1, b)
    lpk, ck = topk_cuda.topk_plain(lp, ks)
    args = (lpk.contiguous(), ck.contiguous(), lp[:, :, 0].contiguous(),
            torch.from_numpy(il.astype(np.int32)).to(dev), W, K,
            min(t, 512), 0)
    kw = {}
    if mode == "K5":
        kw["inc"] = torch.from_numpy(
            0.6 * np.log(rng.dirichlet(np.ones(v), v + 1)).astype(np.float32)
            + 0.3).to(dev)
    if mode == "K6":
        kw["inc"] = torch.from_numpy(
            0.6 * np.log(rng.dirichlet(np.ones(v), 64)).astype(np.float32)
            + 0.3).to(dev)
        kw["cls_map"] = torch.from_numpy(
            rng.integers(0, 63, v).astype(np.int32)).to(dev)
    if mode in ("K6", "K7"):
        kw["state_in"] = beam_search_cuda.beam_state_init(W, b, dev)
    return args, kw


def runner(lib, args, kw):
    """A function that launches `lib`'s e2e_beam_step_f32 once on
    (args, kw), as `beam_step_cuda` takes them, into fixed buffers and
    returns (bp, score, state_out)."""
    lpk, ck, lpb, il, W, K, s_cap, blank = args
    lpk, ck, lpb, il = (x.contiguous() for x in (lpk, ck, lpb, il))
    t_max, n, ks = lpk.shape
    dev = lpk.device
    inc, cls_map = kw.get("inc"), kw.get("cls_map")
    state_in = kw.get("state_in")
    packed_in = (None if state_in is None else
                 torch.stack([x.view(torch.int32) for x in state_in]))
    out = (torch.empty((t_max, W, n), dtype=torch.int32, device=dev),
           torch.empty((W, n), device=dev),
           torch.empty((10, W, n), dtype=torch.int32, device=dev))
    n_ctx, v = (0, 0) if inc is None else inc.shape
    fn = lib.e2e_beam_step_f32
    fn.argtypes = cuda_build._SIGNATURES["e2e_beam_step_f32"]
    fn.restype = ctypes.c_int
    ptr = [None if x is None else x.data_ptr()
           for x in (lpk, ck, lpb, il, inc, cls_map, packed_in, *out)]

    def launch():
        stream = torch.cuda.current_stream(dev).cuda_stream
        cuda_build.check(fn(*ptr, t_max, n, ks, W, K, s_cap, blank, n_ctx,
                            v, stream), "e2e_beam_step_f32")
        return out

    # every tensor whose pointer the launch passes lives as long as it
    launch.tensors = (lpk, ck, lpb, il, packed_in, kw)
    return launch


def equal_outputs(a, b) -> bool:
    """Codes, scores and state bit for bit (a float's sign of zero
    included)."""
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def build_reference(out_dir: Path):
    """The parent kernel (tools/beam_step_reference.cu) as a ctypes
    library in out_dir, and its ptxas lines."""
    return build({"parent": REFERENCE.read_text()}, out_dir,
                 KERNEL)["parent"]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, nargs="*", default=[],
                        help="other versions of beam_step.cu")
    parser.add_argument("--out", type=Path, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("beam_step_breakdown: needs a CUDA device")
    dev = torch.device("cuda", 0)
    parent = REFERENCE.read_text()
    src = (cuda_build.CSRC / "beam_step.cu").read_text()
    variants = {"kernel": src, "parent": parent,
                "kernel, clock probe": patched(src, PROBE),
                **{f"kernel, {name}": patched(src, p)
                   for name, p in NEW.items()},
                **{f"parent, {name}": patched(parent, p)
                   for name, p in PARENT.items()},
                **{f"vs {p.name}": p.read_text() for p in args.against}}
    turns = ["kernel", "parent"] + [f"vs {p.name}" for p in args.against]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        libs = build({**variants, "latency": LATENCY}, Path(tmp), KERNEL)
        result = {"card": card, "calls": CALLS,
                  "cycles an iteration": latencies(libs.pop("latency")[0],
                                                   dev),
                  **{f"{name} ptxas": libs[name][1] for name in turns},
                  "problems": {}}
        for pname, shape in PROBLEMS.items():
            pargs, kw = problem(pname, dev)
            frames = int(pargs[3].max())
            row = {"T, B, V, W, K, ks, mode": list(shape),
                   "frames": frames}
            fns = {name: runner(lib, pargs, kw)
                   for name, (lib, _) in libs.items()}
            row["cycles a frame, lane 0"] = probe(
                libs["kernel, clock probe"][0], pargs, kw)
            for name, fn in fns.items():
                if name.startswith("kernel, ") and name != (
                        "kernel, clock probe"):
                    row[name] = device_ms(fn, CALLS)
                if pname in BREAKDOWN and name.startswith("parent, ") and (
                        "increment" not in name or "inc" in kw):
                    row[name] = device_ms(fn, CALLS)
            for name in turns + turns[::-1]:
                row.setdefault(name, []).append(device_ms(fns[name], CALLS))
            row["us a frame"] = {
                name: [round(1e3 * ms / frames, 3) for ms, _ in row[name]]
                for name in turns}
            for name in turns[:2]:
                row[f"{name} MHz, W, C"] = under_load(fns[name])
            want = [x.clone() for x in fns["kernel"]()]
            row["kernel run again bit-equal"] = all(
                equal_outputs(want, fns["kernel"]()) for _ in range(3))
            for name in turns[1:]:
                row[f"{name} bit-equal"] = equal_outputs(want, fns[name]())
            result["problems"][pname] = row
            del fns
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    bad = [f"{p}: {k}" for p, row in result["problems"].items()
           for k, x in row.items() if k.endswith("bit-equal") and not x]
    if bad:
        raise SystemExit(f"outputs differ from the kernel's: {bad}")


if __name__ == "__main__":
    main()
