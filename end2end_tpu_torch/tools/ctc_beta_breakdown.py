"""Where K2's time goes: time text-patched copies of the beta/occupation
kernel (K2) on one GPU, the K2 that the current one replaced among them,
and time the two in turns.

    python -m end2end_tpu_torch.tools.ctc_beta_breakdown [--against FILE...]
        [--out FILE]

The sibling of ctc_alpha_breakdown (K1), with its problems and its build,
timing and clock/power sampler.  Each variant is a source with text
patches applied (no switch lives in a kernel).  PARENT patches the
replaced K2 (tools/ctc_beta_reference.cu, kept verbatim: the beta row in
shared memory, two barriers a frame): without the alpha tape loads (a
constant of the state in their place), without the emission gathers,
without the gamma stores (the gammas summed into a register that is
stored never), without the frame's second barrier, without the serial
read of the warps' slots, and without libm's expf and log1pf (the beta
recurrence by the max of its three terms, gamma by the clamped exponent);
NEW patches csrc/ctc_loss.cu's K2 alike (its copies, stores, barrier,
libm and slot redux; logaddexp3 with the max term's expf computed, libm's
log1pf with its branch, the shuffles pinned before the barrier, the frame
loop unrolled by 2).  Most of these variants give wrong outputs on
purpose.  A clock probe of each (PARENT_PROBE, PROBE) sums thread 0's
cycles a frame of sequence 0 in each segment of a frame (the stamps cost
cycles of their own).  Other plans of the new K2 run on a build that
ANY_PLAN's patch lets instantiate every (states, ring) pair (PLANS;
outputs unchanged).  Then the new K2 and the parent run in turns, each
once in order and then in the reverse order, in the tape mode and in
checkpoint mode (64 frames), and their gammas are compared bit for bit;
beside them F.ctc_loss backward alone, the combine, and K2 + the combine
against it.  --against times other versions of K2 (whole ctc_loss.cu
files with the same C entry and plan, such as an earlier design) in the
same turns, bit-compared.  Cycles a frame: device ms x the SM clock
sampled under the kernel over the longest sequence's frames.  Two
shapes: the CTC training slice's (T'=750, B=8, S=187, V=32) and the
metric shape (B=32, T=1000, S=100, V=1024).  Times are device times
(`device_ms`: 20 calls in a CUDA graph).  Prints one JSON object with the
card's name and power limit (and writes it to --out if given).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import ctc_loss_cuda
from ..utils import cuda_build
from .ctc_alpha_breakdown import SHAPES, equal_outputs, problem
from .joint_dw_breakdown import build, device_ms, patched, under_load

REFERENCE = Path(__file__).resolve().with_name("ctc_beta_reference.cu")
KERNEL = "ctc_beta_kernel"  # every instantiation's ptxas lines
CALLS = 20
# the replaced K2's entry point: lp, targets, il, tl, a_in, n_in, z_hat,
# norm_end2, gamma, abuf, nbuf, t_max, n, v, s_max, blank, every, states,
# stream
REF_SIG = (ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)

_STAMP = (
    "__device__ __forceinline__ long long stamp_after(float x) {\n"
    "  long long c;\n"
    "  asm volatile(\"{\\n .reg .pred p;\\n setp.eq.f32 p, %1, "
    "0f7FC00000;\\n mov.u64 %0, %%clock64;\\n @p mov.u64 %0, 0;\\n}\"\n"
    "               : \"=l\"(c) : \"f\"(x));\n"
    "  return c;\n}\n")
_PARENT_END = "      __syncthreads();\n    }\n  }\n}"
_PARENT_SINK = [
    ("  int bnorm2 = 0;\n", "  int bnorm2 = 0;\n  float sink = 0.0f;\n"),
    (_PARENT_END, "      __syncthreads();\n    }\n  }\n"
     "  if (sink < 0.0f) gamma[n] = sink;\n}")]
# name: [(text, replacement)] on tools/ctc_beta_reference.cu; every text
# must occur exactly once
PARENT = {
    "no alpha tape loads": [(
        "        const float log_g = a_t[s] + b + (shift - z);\n",
        "        const float log_g = -1e-3f * s + b + (shift - z);\n")],
    "no emission gathers": [(
        "fmaxf(__ldg(lp_row + lat.ext[s]), kLog0)",
        "fmaxf(-0.5f - 1e-3f * lat.ext[s], kLog0)")],
    "no gamma stores": _PARENT_SINK + [(
        "        g_row[s] = (finite && s < 2 * tl + 1) ? g : 0.0f;\n",
        "        sink += (finite && s < 2 * tl + 1) ? g : 0.0f;\n")],
    "no second barrier": [(_PARENT_END, "    }\n  }\n}")],
    "no serial slot loop": [(
        "  for (int w = 1; w < warps; ++w) m = fmaxf(m, red[w]);\n", "")],
    "no expf, log1pf": [
        ("  const float u = ((expf(a - ms) + expf(b - ms)) + expf(c - ms)) "
         "- 1.0f;\n  const float out = ms + log1pf(fmaxf(u, 0.0f));\n",
         "  const float u = (((a - ms) + (b - ms)) + (c - ms)) - 1.0f;\n"
         "  const float out = ms + fmaxf(u, 0.0f);\n"),
        ("        const float g = expf(fminf(log_g, 0.0f));\n",
         "        const float g = fminf(log_g, 0.0f);\n")],
}
# The parent's frame in segments (non-init frames; segment: the stamp
# that ends it), summed by thread 0 of sequence 0 and written over the
# first 40 bytes of gamma.
PARENT_SEGMENTS = ("beta math", "warp max, slot and barrier",
                   "serial slot loop and shift",
                   "gamma, tape, emissions and stores", "second barrier")
PARENT_PROBE = [
    ("// Row max on the 0.5 grid", _STAMP + "\n// Row max on the 0.5 grid"),
    ("__device__ __forceinline__ float block_max(float v, float* red) {",
     "__device__ __forceinline__ float block_max(float v, float* red,\n"
     "                                           long long& mid) {"),
    ("  __syncthreads();\n  float m = red[0];",
     "  __syncthreads();\n  mid = clock64();\n  float m = red[0];"),
    ("  int bnorm2 = 0;\n",
     "  int bnorm2 = 0;\n  long long prof[5] = {0, 0, 0, 0, 0}, mid = 0, "
     "f0 = 0, c3 = 0;\n"),
    ("    for (int t = t1 - 1; t >= t0; --t) {\n",
     "    for (int t = t1 - 1; t >= t0; --t) {\n      f0 = clock64();\n"),
    ("        m = renorm_shift(block_max(lmax, red));  // barrier: bs reads "
     "done\n",
     "        const long long c1 = stamp_after(lmax);\n"
     "        m = renorm_shift(block_max(lmax, red, mid));\n"
     "        c3 = stamp_after(m);\n"
     "        prof[0] += c1 - f0;\n        prof[1] += mid - c1;\n"
     "        prof[2] += c3 - mid;\n"),
    (_PARENT_END,
     "      const long long c4 = clock64();\n"
     "      __syncthreads();\n"
     "      if (!is_init) {\n"
     "        prof[3] += c4 - c3;\n        prof[4] += clock64() - c4;\n"
     "      }\n    }\n  }\n"
     "  if (n == 0 && threadIdx.x == 0)\n"
     "    for (int i = 0; i < 5; ++i)\n"
     "      reinterpret_cast<long long*>(gamma)[i] = prof[i];\n}"),
]

_NEW_SINK = [
    ("  int staged_frames = 0;\n",
     "  int staged_frames = 0;\n  float sink = 0.0f;\n"),
    ("  // frames t >= il, and every frame where z is not finite: gamma 0\n",
     "  if (sink < 0.0f) gamma[n] = sink;\n"
     "  // frames t >= il, and every frame where z is not finite: gamma 0\n")]
# name: [(text, replacement)] on csrc/ctc_loss.cu's K2
NEW = {
    "no alpha tape copies": [
        ("    if (go && st.col[j] >= 0) cp_async4(dst + 4 * (E + j), arow + j);"
         "\n", "    ;\n"),
        ("    a[j] = w[E + j];\n", "    a[j] = -1e-3f * st.col[j];\n")],
    "no emission copies": [
        ("  if (go && st.col[0] >= 0) cp_async4(dst, lrow + st.col[0]);\n", ""),
        ("      cp_async4(dst + 4 * beta_slot<R>(j), lrow + st.col[j]);\n",
         "      ;\n"),
        ("    e[j] = st.col[j] >= 0 ? fmaxf(w[beta_slot<R>(j)], kLog0) : kLog0;"
         "\n",
         "    e[j] = st.col[j] >= 0 ? -0.5f - 1e-3f * st.col[j] : kLog0;\n")],
    "no gamma stores": _NEW_SINK + [(
        "        if ((st.live >> j) & 1) g_out[j] = g_in[j];\n",
        "        if ((st.live >> j) & 1) sink += g_in[j];\n")],
    "gamma stored every frame": [(
        "      if (staged_frames == tape) store_gamma(t + 1);\n",
        "      if (staged_frames >= 1) store_gamma(t + 1);\n")],
    "no barrier": [(
        "  __syncthreads();\n  float m = 0.0f;\n", "  float m = 0.0f;\n")],
    "no expf, log1pf": [
        ("  const float ep = expf((top_c ? a : fminf(a, b)) - ms);\n"
         "  const float eq = expf((top_c ? b : c) - ms);\n",
         "  const float ep = (top_c ? a : fminf(a, b)) - ms;\n"
         "  const float eq = (top_c ? b : c) - ms;\n"),
        ("ms + log1p_main(fmaxf(u, 0.0f));", "ms + fmaxf(u, 0.0f);"),
        ("expf(fminf(gl[j], 0.0f))", "fminf(gl[j], 0.0f)")],
    "the max term's expf too": [(
        "          logaddexp3_beta(st.x[j], y1, (st.skip2 >> j) & 1 ? y2 : "
        "kLog0),\n",
        "          logaddexp3(st.x[j], y1, (st.skip2 >> j) & 1 ? y2 : kLog0),\n"
    )],
    "libm's log1pf": [
        ("ms + log1p_main(fmaxf(u, 0.0f));", "ms + log1pf(fmaxf(u, 0.0f));")],
    "shuffles pinned before the barrier": [(
        "  const float u1 = __shfl_down_sync(kFull, bnew[0], 1);\n"
        "  const float u2 = __shfl_down_sync(kFull, bnew[k2], 2 - k2);\n"
        "  const float f1 = __shfl_down_sync(kFull, e[0], 1);\n"
        "  const float f2 = __shfl_down_sync(kFull, e[k2], 2 - k2);\n",
        "  auto pinned = [](float v, int d) {\n"
        "    float r;\n"
        "    asm volatile(\"shfl.sync.down.b32 %0, %1, %2, 0x1f, "
        "0xffffffff;\"\n"
        "                 : \"=f\"(r) : \"f\"(v), \"r\"(d));\n"
        "    return r;\n  };\n"
        "  const float u1 = pinned(bnew[0], 1);\n"
        "  const float u2 = pinned(bnew[k2], 2 - k2);\n"
        "  const float f1 = pinned(e[0], 1);\n"
        "  const float f2 = pinned(e[k2], 2 - k2);\n")],
    "frame loop unrolled by 2": [(
        "    for (--t; t >= t0; --t)\n"
        "      beta_frame(t, std::false_type{}, std::true_type{});\n",
        "#pragma unroll 2\n    for (--t; t >= t0; --t)\n"
        "      beta_frame(t, std::false_type{}, std::true_type{});\n")],
    "no slot redux": [(
        "    m = renorm_shift(warp_max(lane < warps ? row[8 * lane] : kLog0));"
        "\n", "    m = renorm_shift(row[0]);\n")],
}
# The new K2's frame in segments (non-init frames of sequence 0, thread
# 0; segment: the stamp that ends it), written over the first 56 bytes of
# gamma.  The work beside the recurrence is timed to its last
# instruction's start: its loads land later.
SEGMENTS = ("recurrence", "beside it: gammas, copies, ring reads",
            "warp max", "shuffles, slots and barrier", "shift",
            "states and exponents", "between frames")
PROBE = [
    ("// Row max on the 0.5 grid", _STAMP + "\n// Row max on the 0.5 grid"),
    ("  float n1, n2;    // the same of the neighbours (pads: log-zero)\n};",
     "  float n1, n2;\n  long long prof[7], stamp;\n};"),
    ("  st.n2 = s0 + R + 1 < L ? kLog0 + kLog0 : kLog0;\n}",
     "  st.n2 = s0 + R + 1 < L ? kLog0 + kLog0 : kLog0;\n"
     "  for (int i = 0; i < 7; ++i) st.prof[i] = 0;\n"
     "  st.stamp = 0;\n}"),
    ("  float bnew[R];\n  float top = kLog0;\n",
     "  float bnew[R];\n  float top = kLog0;\n"
     "  const long long c0 = clock64();\n"
     "  if (st.stamp && !kInit) st.prof[6] += c0 - st.stamp;\n"),
    ("  aside();\n",
     "  const long long c1 = stamp_after(top);\n  aside();\n"
     "  const long long c2 = clock64();\n"),
    ("  if constexpr (!kInit) top = warp_max(top);\n",
     "  if constexpr (!kInit) top = warp_max(top);\n"
     "  const long long c3 = stamp_after(top);\n"),
    ("  __syncthreads();\n  float m = 0.0f;\n",
     "  __syncthreads();\n  const long long c4 = clock64();\n"
     "  float m = 0.0f;\n"),
    ("  const float sz = (float)(*an + bnorm2 - ne) * 0.5f - z;\n",
     "  const long long c5 = stamp_after(m);\n"
     "  const float sz = (float)(*an + bnorm2 - ne) * 0.5f - z;\n"),
    ("                    (edge ? w.w : edge2 ? w.z : f2)\n"
     "              : kLog0;\n}",
     "                    (edge ? w.w : edge2 ? w.z : f2)\n"
     "              : kLog0;\n"
     "  const long long c6 = stamp_after(st.n2 + gl[R - 1]);\n"
     "  if (!kInit) {\n"
     "    st.prof[0] += c1 - c0;\n    st.prof[1] += c2 - c1;\n"
     "    st.prof[2] += c3 - c2;\n    st.prof[3] += c4 - c3;\n"
     "    st.prof[4] += c5 - c4;\n    st.prof[5] += c6 - c5;\n"
     "  }\n  st.stamp = c6;\n}"),
    ("  // frames t >= il, and every frame where z is not finite: gamma 0\n",
     "  if (n == 0 && threadIdx.x == 0)\n"
     "    for (int i = 0; i < 7; ++i)\n"
     "      reinterpret_cast<long long*>(gamma)[i] = st.prof[i];\n"
     "  // frames t >= il, and every frame where z is not finite: gamma 0\n"),
]
# every (states, ring) pair instantiated, so that PLANS run
ANY_PLAN = [(
    "BetaLaunch beta_launcher(int r, int ring) {\n",
    "BetaLaunch beta_launcher(int r, int ring) {\n"
    "#define E2E_BETA(R) (ring == 2 ? launch_beta<R, 2> \\\n"
    "                     : ring == 4 ? launch_beta<R, 4> : launch_beta<R, 8>)"
    "\n  switch (r) {\n"
    + "".join(f"    case {r}: return E2E_BETA({r});\n"
              for r in (1, 2, 3, 4, 8, 16)) +
    "  }\n")]
# name: overrides of beta_plan's (states, ring, tape)
PLANS = {**{f"{r} states a thread": {"states": r} for r in (1, 3, 4, 8)},
         "ring depth 2": {"ring": 2}, "ring depth 4": {"ring": 4},
         "gamma staged 1 frame": {"tape": 1},
         "gamma staged 16 frames": {"tape": 16}}


def plan_with(s_max: int, **over) -> dict:
    """beta_plan(s_max) with `over` in place of its states, ring or tape,
    threads and shared bytes recomputed (the C entry checks the sum)."""
    plan = {**ctc_loss_cuda.beta_plan(s_max), **over}
    L = 2 * s_max + 1
    plan["threads"] = -(-(-(-L // plan["states"])) // 32) * 32
    plan["smem"] = ctc_loss_cuda.beta_smem(
        plan["states"], plan["threads"], plan["ring"], plan["tape"])
    return plan


def runner(lib, new, data, every=0, plan=None, blank=0):
    """A function that launches one K2 of `lib` on data's K1 outputs (the
    package's K1, same `every` and `blank`) into a fixed gamma and returns
    it.  `new`: csrc/ctc_loss.cu's K2 at `plan` (beta_plan's by default),
    else the replaced K2's entry point."""
    lp = data[0].contiguous()
    tgt, il, tl = (x.to(torch.int32).contiguous() for x in data[1:])
    t_max, n, v = lp.shape
    s_max = tgt.shape[1]
    L = 2 * s_max + 1
    z, ne, a, an = ctc_loss_cuda.alpha_cuda(lp, tgt, il, tl, blank, every)
    gamma = torch.empty((t_max, n, L), device=lp.device)
    abuf = torch.empty((n, every, L), device=lp.device)
    nbuf = torch.empty((n, every), dtype=torch.int32, device=lp.device)
    args = [x.data_ptr() for x in (lp, tgt, il, tl, a, an, z, ne, gamma,
                                   abuf, nbuf)]
    args += [t_max, n, v, s_max, blank, every]
    if new:
        fn = lib.e2e_ctc_beta_f32
        fn.argtypes = cuda_build._SIGNATURES["e2e_ctc_beta_f32"]
        plan = plan or ctc_loss_cuda.beta_plan(s_max)
        args += [plan[k] for k in ("states", "threads", "ring", "tape",
                                   "smem")]
    else:
        fn = lib.e2e_ctc_beta_reference_f32
        fn.argtypes = REF_SIG
        args.append(ctc_loss_cuda.alpha_plan(s_max)["states"])
    fn.restype = ctypes.c_int

    def launch():
        stream = torch.cuda.current_stream(lp.device).cuda_stream
        cuda_build.check(fn(*args, stream), "K2")
        return gamma

    launch.inputs = (lp, tgt, il, tl, z, ne, a, an, abuf, nbuf)
    return launch


def probe(lib, new, data, segments) -> dict:
    """Cycles a frame in each segment, thread 0 of sequence 0, over its
    non-init frames."""
    out = runner(lib, new, data)()
    torch.cuda.synchronize()
    cycles = out.flatten()[:2 * len(segments)].view(torch.int64).tolist()
    frames = max(min(int(data[2][0]), data[0].shape[0]) - 1, 1)
    return {k: c / frames for k, c in zip(segments, cycles)}


def build_reference(out_dir: Path):
    """The replaced K2 (tools/ctc_beta_reference.cu) as a ctypes library
    in out_dir, and its ptxas lines."""
    return build({"reference": REFERENCE.read_text()}, out_dir,
                 KERNEL)["reference"]


def library_bwd(data):
    """F.ctc_loss backward alone on data (forward once; host lengths,
    int64 targets)."""
    lp, tgt, il, tl = data
    x = lp.detach().requires_grad_(True)
    loss = torch.nn.functional.ctc_loss(
        x, tgt.long(), il.long().cpu(), tl.long().cpu(), reduction="sum",
        zero_infinity=True)
    return lambda: torch.autograd.grad(loss, x, retain_graph=True)


def frames_of(data) -> int:
    """The frames the longest sequence walks: a kernel's time per frame."""
    return max(min(int(data[2].max()), data[0].shape[0]), 1)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, nargs="*", default=[],
                        help="other versions of csrc/ctc_loss.cu")
    parser.add_argument("--out", type=Path, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ctc_beta_breakdown: needs a CUDA device")
    dev = torch.device("cuda", 0)
    src = (cuda_build.CSRC / "ctc_loss.cu").read_text()
    ref = REFERENCE.read_text()
    variants = {"whole": src, "parent": ref,
                "clock probe": patched(src, PROBE),
                "parent clock probe": patched(ref, PARENT_PROBE),
                "any plan": patched(src, ANY_PLAN),
                **{name: patched(src, p) for name, p in NEW.items()},
                **{f"parent, {name}": patched(ref, p)
                   for name, p in PARENT.items()},
                **{f"vs {p.name}": p.read_text() for p in args.against}}
    turns = ["whole", "parent"] + [f"vs {p.name}" for p in args.against]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        libs = build(variants, Path(tmp), KERNEL)
        is_new = {name: not name.startswith("parent") for name in variants}
        result = {"card": card, "calls": CALLS, "ptxas": libs["whole"][1],
                  "parent ptxas": libs["parent"][1], "shapes": {}}
        for shape, (b, t, s, v) in SHAPES.items():
            data = problem(shape, dev)
            row = {"B, T, S, V": [b, t, s, v],
                   "plan": ctc_loss_cuda.beta_plan(s),
                   "frames": frames_of(data)}
            fns = {name: runner(lib, is_new[name], data)
                   for name, (lib, _) in libs.items()}
            row["cycles a frame, thread 0"] = probe(
                libs["clock probe"][0], True, data, SEGMENTS)
            row["parent cycles a frame, thread 0"] = probe(
                libs["parent clock probe"][0], False, data, PARENT_SEGMENTS)
            for name, fn in fns.items():
                if "probe" not in name and name not in turns:
                    row[name] = device_ms(fn, CALLS)
            for name, over in PLANS.items():
                plan = plan_with(s, **over)
                if plan["smem"] > 232448:
                    continue
                fn = runner(libs["any plan"][0], True, data, plan=plan)
                row[f"whole, {name}"] = device_ms(fn, CALLS)
                row[f"whole, {name} bit-equal"] = equal_outputs(
                    [fn()], [fns["whole"]()])
            ckpt = {name: runner(libs[name][0], is_new[name], data, 64)
                    for name in turns}
            for mode, fs in (("", fns), (" checkpoint 64", ckpt)):
                for name in turns + turns[::-1]:
                    row.setdefault(f"{name}{mode}", []).append(
                        device_ms(fs[name], CALLS))
                for name in turns[1:]:
                    row[f"{name}{mode} bit-equal"] = equal_outputs(
                        [fs["whole"]()], [fs[name]()])
            row["checkpoint 64 == tape"] = equal_outputs(
                [ckpt["whole"]()], [fns["whole"]()])
            for name in ("whole", "parent"):
                mhz, watts, temp = under_load(fns[name])
                row[f"{name} MHz, W, C"] = [mhz, watts, temp]
                ms = min(x[0] for x in row[name])
                row[f"{name} cycles a frame"] = ms * 1e-3 * mhz * 1e6 / (
                    row["frames"])
            lp, tgt, il, tl = data
            gamma = fns["whole"]()
            g = torch.ones(b, device=dev)
            row["combine"] = device_ms(
                lambda: ctc_loss_cuda.grad_cuda(lp, tgt, il, tl, gamma, g),
                CALLS)
            row["F.ctc_loss backward"] = device_ms(library_bwd(data), CALLS)
            k2 = min(x[0] for x in row["whole"]) + row["combine"][0]
            row["K2 + combine / F.ctc_loss backward"] = (
                k2 / row["F.ctc_loss backward"][0])
            result["shapes"][shape] = row
            del data, fns, ckpt
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    bad = [f"{shape}: {k}" for shape, row in result["shapes"].items()
           for k, x in row.items()
           if (k.endswith("bit-equal") or k.endswith("== tape")) and not x]
    if bad:
        raise SystemExit(f"outputs differ from the whole kernel's: {bad}")


if __name__ == "__main__":
    main()
