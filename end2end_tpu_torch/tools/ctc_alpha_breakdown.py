"""Where K1's time goes: time text-patched copies of csrc/ctc_loss.cu's
alpha kernel (K1) on one GPU, and time other versions of it in turns.

    python -m end2end_tpu_torch.tools.ctc_alpha_breakdown [--against FILE...]
        [--out FILE]

The sibling of joint_dh_breakdown (K11), with its build, timing and
clock/power sampler.  Each variant is the source with text patches
applied (no switch lives in the kernel; NEW lists them): the whole K1;
without the emission loads (each state's emission is a constant of its
column, so no copy is made); with the emissions loaded from global
memory at the frame's start, on its critical path, as the two-barrier K1
did; without the tape writes (the carry still feeds z_hat); with a second
barrier a frame after the shift, where the two-barrier step had it; the
frame loop unrolled; the slot max by one load a slot; the copy source
advanced by a pointer; and, with wrong outputs, without parts of the
step (the logaddexp3s, the warp max or its redux, the barrier, the slot
max) or with only its skeleton.  A clock probe (PROBE) reports thread 0's
cycles a frame in each segment of the step.  The whole K1 also runs at
other plans (PLANS: `alpha_plan`'s overrides; its outputs do not change):
a ring of 2 or 4 frames, the tape stored every frame or every 16, and
1, 2, 3, 4 and 6 states a thread.  --against times other versions of K1 (whole
ctc_loss.cu files, such as the parent's from the git history; by default
tools/ctc_alpha_reference.cu, the two-barrier K1 kept verbatim) beside the
whole kernel in turns, each once in order and then in the reverse order,
and checks that their outputs are bit-equal to the whole kernel's: the
tape and the checkpoint rows (every 64 frames), the int32 norms, z_hat and
norm_end2.  Two shapes: the CTC training slice's (T'=750, B=8, S=187,
V=32, the lengths of 30/22/15 s requests) and the metric shape (B=32,
T=1000, S=100, V=1024, variable lengths, one infeasible sample).  Times are
device times (`device_ms`: 20 calls in a CUDA graph), beside F.ctc_loss
forward's on the same inputs; the card's SM clock, power and temperature
are sampled while the whole kernel and the first --against run back to
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

from ..ops import ctc_loss_cuda
from ..utils import cuda_build
from .joint_dw_breakdown import build, device_ms, patched, under_load

REFERENCE = Path(__file__).resolve().with_name("ctc_alpha_reference.cu")
KERNEL = "ctc_alpha_kernel"  # every instantiation's ptxas lines
SHAPES = {"main": (8, 750, 187, 32), "metric": (32, 1000, 100, 1024)}
CALLS = 20
# the two-barrier K1's entry point: lp, targets, il, tl, a_out, n_out,
# z_hat, norm_end2, t_max, n, v, s_max, blank, every, stream
OLD_SIG = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)

_FRAME_LOOP = ("  for (int t = 1; t < t_run; ++t) "
               "frame_step(t, std::false_type{});")
# name: [(text, replacement)]; every text must occur exactly once
NEW = {
    "no emission loads": [
        ("      cp_async4(stage + 4 * j * blockDim.x, row + st.col[j]);\n",
         "      ;\n"),
        ("e[j] = st.col[j] >= 0 ? ld_shared(stage + 4 * slot * blockDim.x) "
         ": kLog0;",
         "e[j] = st.col[j] >= 0 ? -0.5f - 1e-3f * st.col[slot] : kLog0;")],
    "emissions loaded at need": [
        ("    copy_emissions(st, lp_n + ahead * frame,\n"
         "                   ring0 + ((t + D - 1) % D) * stage_bytes);\n",
         ""),
        ("    read_emissions(st, ring0 + (t % D) * stage_bytes, e);\n",
         "    load_emissions(st, lp_n + t * frame, e);\n")],
    "no tape writes": [(
        "              a_out[row * L + s0 + j] = rowf[j * threads + "
        "threadIdx.x];\n", "              ;\n")],
    "two barriers": [(
        "  st.p2 = fmaxf(u2 - m, kLog0);\n}",
        "  st.p2 = fmaxf(u2 - m, kLog0);\n  __syncthreads();\n}")],
    **{f"frame loop unrolled by {u}": [
        (_FRAME_LOOP, f"#pragma unroll {u}\n" + _FRAME_LOOP)] for u in (2, 4)},
    "slot max by loads": [(
        "  const float m = renorm_shift(warp_max(lane < warps ? red[lane] : "
        "kLog0));\n",
        "  float mm = red[0];\n"
        "#pragma unroll\n"
        "  for (int w = 1; w < 8; ++w)\n"
        "    if (w < warps) mm = fmaxf(mm, red[w]);\n"
        "  for (int w = 8; w < warps; ++w) mm = fmaxf(mm, red[w]);\n"
        "  const float m = renorm_shift(mm);\n")],
    "copy source advanced": [
        ("  int k = 0;             // frames staged\n",
         "  int k = 0;             // frames staged\n"
         "  const float* next = lp_n + (D - 1) * frame;\n"
         "  const float* last = lp_n + (t_run - 1) * frame;\n"),
        ("    const int ahead = min(t + D - 1, t_run - 1);\n"
         "    copy_emissions(st, lp_n + ahead * frame,\n",
         "    copy_emissions(st, t + D - 1 < t_run ? next : last,\n"),
        ("    cp_async_commit();\n    cp_async_wait<D - 1>();\n",
         "    next += frame;\n"
         "    cp_async_commit();\n    cp_async_wait<D - 1>();\n")],
    # what the step's parts cost (the outputs are wrong)
    "no logaddexp3": [(
        "x = logaddexp3(st.a[j], a1, (st.skip >> j) & 1 ? a2 : kLog0) + lp;",
        "x = fmaxf(fmaxf(st.a[j], a1), (st.skip >> j) & 1 ? a2 : kLog0) "
        "+ lp;")],
    "no warp max": [("  lmax = warp_max(lmax);\n", "")],
    "warp max by shuffles": [(
        "  lmax = warp_max(lmax);\n",
        "  for (int off = 16; off > 0; off >>= 1)\n"
        "    lmax = fmaxf(lmax, __shfl_xor_sync(kFull, lmax, off));\n")],
    "no barrier": [(
        "  __syncthreads();\n  // the max of the warps' maxima",
        "  // the max of the warps' maxima")],
    "no slot reduction": [(
        "renorm_shift(warp_max(lane < warps ? red[lane] : kLog0));",
        "renorm_shift(red[0]);")],
}
# Where a frame's cycles go: clock stamps in K1's step, each taken when the
# value it names is ready, summed over the frames by thread 0 of sequence 0
# and written over the first 16 words of its tape (segment: the stamp that
# ends it).
SEGMENTS = ("emission read", "logaddexp3", "warp max", "slots and barrier",
            "slot max and shift", "shifted states",
            "staged rows and loop", "copies and wait")
PROBE = [
    ("  float p1, p2;    // the same of states s0 - 1 and s0 - 2 (pads: "
     "log-zero)\n};",
     "  float p1, p2;\n  long long prof[8], stamp;\n};\n"
     "__device__ __forceinline__ long long stamp_after(float x) {\n"
     "  long long c;\n"
     "  asm volatile(\"{\\n .reg .pred p;\\n setp.eq.f32 p, %1, "
     "0f7FC00000;\\n mov.u64 %0, %%clock64;\\n @p mov.u64 %0, 0;\\n}\"\n"
     "               : \"=l\"(c) : \"f\"(x));\n"
     "  return c;\n}"),
    ("  st.p1 = st.p2 = kLog0;\n}",
     "  st.p1 = st.p2 = kLog0;\n"
     "  for (int i = 0; i < 8; ++i) st.prof[i] = 0;\n"
     "  st.stamp = clock64();\n}"),
    ("  float anew[R];\n  float lmax = kLog0;\n",
     "  float anew[R];\n  float lmax = kLog0;\n"
     "  const long long c0 = stamp_after(e[R - 1]);\n"
     "  st.prof[0] += c0 - st.stamp;\n"),
    ("  lmax = warp_max(lmax);\n",
     "  const long long c1 = stamp_after(lmax);\n"
     "  st.prof[1] += c1 - c0;\n"
     "  lmax = warp_max(lmax);\n"
     "  const long long c2 = stamp_after(lmax);\n"
     "  st.prof[2] += c2 - c1;\n"),
    ("  __syncthreads();\n  // the max of the warps' maxima",
     "  __syncthreads();\n"
     "  const long long c3 = clock64();\n"
     "  st.prof[3] += c3 - c2;\n"
     "  // the max of the warps' maxima"),
    ("  norm2 += __float2int_rn(m * 2.0f);\n  if (lane == 0) {",
     "  norm2 += __float2int_rn(m * 2.0f);\n"
     "  const long long c4 = stamp_after(m);\n"
     "  st.prof[4] += c4 - c3;\n"
     "  if (lane == 0) {"),
    ("  st.p2 = fmaxf(u2 - m, kLog0);\n}",
     "  st.p2 = fmaxf(u2 - m, kLog0);\n"
     "  st.stamp = stamp_after(st.p2);\n"
     "  st.prof[5] += st.stamp - c4;\n}"),
    ("    const int ahead = min(t + D - 1, t_run - 1);\n",
     "    const long long q0 = clock64();\n"
     "    const int ahead = min(t + D - 1, t_run - 1);\n"),
    ("    cp_async_wait<D - 1>();\n",
     "    cp_async_wait<D - 1>();\n"
     "    const long long q1 = clock64();\n"
     "    st.prof[6] += q0 - st.stamp;\n"
     "    st.prof[7] += q1 - q0;\n"
     "    st.stamp = q1;\n"),
    ("    norm_end2[n] = norm2;\n  }\n}",
     "    norm_end2[n] = norm2;\n  }\n"
     "  if (n == 0 && threadIdx.x == 0)\n"
     "    for (int i = 0; i < 8; ++i)\n"
     "      reinterpret_cast<long long*>(a_out)[i] = st.prof[i];\n}"),
]


def probe(lib, data) -> dict:
    """Cycles a frame in each segment of K1's step (the PROBE build), for
    thread 0 of sequence 0."""
    out = runner(lib, True, data)()
    torch.cuda.synchronize()
    cycles = out[2].flatten()[:16].view(torch.int64).tolist()
    frames = max(min(int(data[2][0]), data[0].shape[0]), 1)
    return {k: c / frames for k, c in zip(SEGMENTS, cycles)}


NEW["skeleton"] = (NEW["no logaddexp3"] + NEW["no emission loads"]
                   + NEW["no tape writes"] + NEW["no warp max"]
                   + NEW["no slot reduction"])
NEW["no math, no reductions"] = (NEW["no logaddexp3"] + NEW["no warp max"]
                                 + NEW["no slot reduction"])
# name: the whole kernel at another plan (alpha_plan's overrides)
PLANS = {"ring depth 2": {"ring": 2}, "ring depth 4": {"ring": 4},
         "tape stored every frame": {"tape": 1},
         "tape staged 16 frames": {"tape": 16},
         **{f"{r} states a thread": {"states": r} for r in (1, 2, 3, 4, 6)}}


def problem(name, dev, seed=0):
    """(log-probs (T, N, V) float32, targets (N, S), input and target
    lengths (N,)) on dev, int32, from a seed."""
    b, t, s, v = SHAPES[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, b, v)) * 2.0
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    if name == "main":  # 30, 22 and 15 s requests: T'/4 labels each
        il = np.array([750, 550, 375, 750, 550, 375, 550, 375])
        tl = il // 4
    else:  # chip_smoke.ctc_problem's draw
        il = rng.integers(t // 2, t + 1, b)
        tl = np.minimum(rng.integers(1, s + 1, b), np.maximum(il // 3, 1))
        tl[1], il[1] = s, s - 1
    tgt = rng.integers(1, v, (b, s))
    return (torch.from_numpy(lp).to(dev),
            *(torch.from_numpy(a.astype(np.int32)).to(dev)
              for a in (tgt, il, tl)))


def runner(lib, new, data, every=0, **plan):
    """A function that launches one K1 of `lib` on data into fixed output
    buffers and returns them: (z_hat, norm_end2, alpha rows, norms).
    `new`: the planned K1, at alpha_plan(**plan) (else the two-barrier
    one's entry point)."""
    lp = data[0].contiguous()
    tgt, il, tl = (x.to(torch.int32).contiguous() for x in data[1:])
    t_max, n, v = lp.shape
    s_max = tgt.shape[1]
    rows = -(-t_max // every) if every else t_max
    out = (torch.empty(n, device=lp.device),
           torch.empty(n, dtype=torch.int32, device=lp.device),
           torch.empty((rows, n, 2 * s_max + 1), device=lp.device),
           torch.empty((rows, n), dtype=torch.int32, device=lp.device))
    fn = lib.e2e_ctc_alpha_f32
    fn.restype = ctypes.c_int
    args = [x.data_ptr() for x in (lp, tgt, il, tl, out[2], out[3], out[0],
                                   out[1])] + [t_max, n, v, s_max, 0, every]
    if new:
        fn.argtypes = cuda_build._SIGNATURES["e2e_ctc_alpha_f32"]
        plan = ctc_loss_cuda.alpha_plan(s_max, **plan)
        args += [plan[k] for k in ("states", "threads", "ring", "tape",
                                   "smem")]
    else:
        fn.argtypes = OLD_SIG

    def launch():
        stream = torch.cuda.current_stream(lp.device).cuda_stream
        cuda_build.check(fn(*args, stream), "K1")
        return out

    return launch


def equal_outputs(a, b) -> bool:
    """Bit for bit (a float's sign of zero included)."""
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def build_reference(out_dir: Path):
    """The two-barrier K1 (tools/ctc_alpha_reference.cu) as a ctypes
    library in out_dir, and its ptxas lines."""
    return build({"reference": REFERENCE.read_text()}, out_dir,
                 KERNEL)["reference"]


def library_fwd(data):
    """F.ctc_loss forward on data (host lengths, int64 targets)."""
    lp, tgt, il, tl = data
    args = (tgt.long(), il.long().cpu(), tl.long().cpu())
    return lambda: torch.nn.functional.ctc_loss(
        lp, *args, reduction="sum", zero_infinity=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, nargs="*",
                        default=[REFERENCE],
                        help="other versions of K1's source")
    parser.add_argument("--out", type=Path, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ctc_alpha_breakdown: needs a CUDA device")
    dev = torch.device("cuda", 0)
    src = (cuda_build.CSRC / "ctc_loss.cu").read_text()
    variants = {"whole": src, "clock probe": patched(src, PROBE),
                **{name: patched(src, p) for name, p in NEW.items()}}
    turns = ["whole"] + [f"vs {p.name}" for p in args.against]
    variants.update({f"vs {p.name}": p.read_text() for p in args.against})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        libs = build(variants, Path(tmp), KERNEL)
        new = {name: "alpha_plan" in text or "int states," in text
               for name, text in variants.items()}
        result = {"card": card, "calls": CALLS, "ptxas": libs["whole"][1],
                  "shapes": {}}
        for name in turns[1:]:
            result[f"{name} ptxas"] = libs[name][1]
        for shape, (b, t, s, v) in SHAPES.items():
            data = problem(shape, dev)
            row = {"B, T, S, V": [b, t, s, v],
                   "plan": ctc_loss_cuda.alpha_plan(s)}
            fns = {name: runner(lib, new[name], data)
                   for name, (lib, _) in libs.items()}
            for name, fn in fns.items():
                if name == "clock probe":
                    row["cycles a frame, thread 0"] = probe(
                        libs[name][0], data)
                elif name not in turns:
                    row[name] = device_ms(fn, CALLS)
            for name, plan in PLANS.items():
                try:
                    fn = runner(libs["whole"][0], True, data, **plan)
                except ValueError:  # the plan does not hold at this shape
                    continue
                row[f"whole, {name}"] = device_ms(fn, CALLS)
                row[f"whole, {name} plan"] = ctc_loss_cuda.alpha_plan(s,
                                                                      **plan)
            for name in turns + turns[::-1]:
                row.setdefault(name, []).append(device_ms(fns[name], CALLS))
            row["F.ctc_loss forward"] = device_ms(library_fwd(data), CALLS)
            for name in turns[:2]:
                row[f"{name} MHz, W, C"] = under_load(fns[name])
            for name in turns[1:]:  # bit-equal to the whole kernel's
                row[f"{name} bit-equal"] = all(
                    equal_outputs(runner(libs["whole"][0], True, data,
                                         every)(),
                                  runner(libs[name][0], new[name], data,
                                         every)())
                    for every in (0, 64))
            result["shapes"][shape] = row
            del data, fns
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
