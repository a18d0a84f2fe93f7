"""Where the backtrace kernel's time goes (csrc/backtrace.cu): time it and
the lane-walk kernel, text-patched variants of them and other versions
in turns on one GPU, and the backtrace with and without its kernel.

    python -m end2end_tpu_torch.tools.lane_walk_breakdown [--against FILE...]
        [--out FILE]

The sibling of topk_breakdown, with its build, timing and clock/power
sampler.  Codes (T, W, N) int32 are drawn from a seed over [0, W + W K)
with stays at 75% (what the beam step writes is of that form; each path
then emits ~T/4 tokens, within s_cap as the beam step's cap keeps it,
so the plain scatter has no two emissions on one slot) at three
shapes: the serving slice's backtrace (T'=750, N=8, W=8, K=16), the LM
decode's at B=128 (T=1000, N=128, W=8, K=16), bench.py's beam-16 row
(T=1000, N=32, W=16, K=32) and a chunk of the chunked decode (T=128,
N=32, W=8, K=16).  Variants of NEW (no switch lives in the kernels;
their outputs are wrong on purpose): without the lane walk's per-frame
store (the lanes' values summed into lane0), without the loads of ids
(the backtrace's rows, the lane walk's tokens), without the loads of
codes (each frame's code a function of t), without the shuffle (each
lane takes its own column's entry), 16 frames a block, 4 or 16 writing
warps.  Then the kernels and any --against files (other backtrace.cu
versions with these entry points) run in turns, each once in order and
then in the reverse order, their outputs compared with the kernels' and
with `backtrace_plain`'s and `lane_walk_plain`'s.  Cycles a frame:
device ms x the SM clock sampled under the backtrace kernel over T.
Beside them, `backtrace` on the same codes, one call, with the kernel
and with the host walk.  Times are device times (`device_ms`: CALLS
calls in a CUDA graph).  Prints one JSON object with the card's name and
power limit (and writes it to --out if given).
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

from ..ops import beam_search_cuda
from ..utils import cuda_build
from .joint_dw_breakdown import (build, device_ms, patched, time_ms,
                                 under_load)

KERNEL = "_kernel"  # the walk's and the backtrace's ptxas lines
CALLS = 20
SHAPES = {  # name: (T, N, W, K)
    "main": (750, 8, 8, 16),
    "b128": (1000, 128, 8, 16),
    "beam16": (1000, 32, 16, 32),
    "chunk": (128, 32, 8, 16),
}
_CHAIN = "      const int got = __shfl_sync(kFull, offer[f], cur);\n"
_FILL = ("    const int e =\n"
         "        in ? a.rev[(seqj * W + j - sj * W) * a.t_max +\n"
         "                   (p == a.s_cap - 1 ? 0 : ej - 1 - p)]\n"
         "           : 0;\n"
         "    const int tok =\n"
         "        __ldg(a.ck + ((long long)(e >> 7) * n + seqj) * a.ks + "
         "(e & 127));\n")
# name: [(text, replacement)] on csrc/backtrace.cu; every text occurs once
NEW = {
    "no walk stores": [(
        "        if (act) a.took[t * stride + at] = got >> 5;\n",
        "        sink += got;\n"), (
        "  lane0 = cur - base;\n", "  lane0 = cur - base + sink;\n"), (
        "  int emitted = 0;\n", "  int emitted = 0, sink = 0;\n")],
    "no row loads": [(_FILL, "    const int e = in ? p << 7 : 0;\n"
                              "    const int tok = ej + p;\n"), (
        "    const int tok = __ldg(a.ck + ((long long)t * n + first + j / W) "
        "* a.ks +\n                          max(took - 1, 0));\n",
        "    const int tok = t;\n")],
    "no code loads": [(
        "    c[f] = (act && t >= 0) ? __ldg(col + t * stride) : w;\n",
        "    c[f] = (act && t >= 0) ? ((t ^ w) & 7) : w;\n")],
    "no shuffle": [(_CHAIN, "      const int got = offer[f];\n")],
    "16 frames a block": [("constexpr int kFrames = 32;",
                           "constexpr int kFrames = 16;")],
    "4 fill warps": [("constexpr int kFillWarps = 8;",
                      "constexpr int kFillWarps = 4;")],
    "16 fill warps": [("constexpr int kFillWarps = 8;",
                       "constexpr int kFillWarps = 16;")],
}


def problem(name: str, dev, seed: int = 0):
    """(bp (T, W, N) int32 codes, ck (T, N, K + 8) int32 ids, scores
    (W, N))."""
    t, n, w, k = SHAPES[name]
    rng = np.random.default_rng(seed)
    bp = rng.integers(0, w + w * k, (t, w, n))
    bp = np.where(rng.random((t, w, n)) < 0.75, np.arange(w)[None, :, None],
                  bp).astype(np.int32)
    ck = rng.integers(0, 29, (t, n, k + 8)).astype(np.int32)
    scores = rng.standard_normal((w, n)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (bp, ck, scores))


def runner(lib, bp, ck, W, K, scores=None, s_cap=512):
    """A function that launches `lib`'s lane walk on bp and ck into fixed
    outputs and returns (lane0, toks, n_emit); with scores its backtrace,
    returning (tokens, lens, scores, times)."""
    t_max, _, n = bp.shape
    dev = bp.device
    if scores is None:
        took = torch.empty((t_max, n, W), dtype=torch.int32, device=dev)
        out = (torch.empty((n, W), dtype=torch.int64, device=dev),
               torch.empty((n, W, t_max), dtype=torch.int64, device=dev),
               torch.empty((n, W), dtype=torch.int64, device=dev), took)
        name = "e2e_lane_walk"
        ptrs = [ck.data_ptr(), took.data_ptr(), out[1].data_ptr(),
                out[0].data_ptr(), out[2].data_ptr()]
        sizes = [t_max, n, W, K, ck.shape[2]]
    else:
        rev = torch.empty((n, W, t_max), dtype=torch.int32, device=dev)
        tokens = torch.empty((n, W, s_cap), dtype=torch.int32, device=dev)
        out = (tokens, torch.empty((n, W), dtype=torch.int32, device=dev),
               torch.empty((n, W), device=dev), torch.empty_like(tokens))
        name = "e2e_backtrace"
        ptrs = [ck.data_ptr(), scores.data_ptr(), rev.data_ptr(),
                out[0].data_ptr(), out[3].data_ptr(), out[1].data_ptr(),
                out[2].data_ptr()]
        sizes = [t_max, n, W, K, ck.shape[2], s_cap]
        out = (*out, rev)
    fn = getattr(lib, name)
    fn.argtypes = cuda_build._SIGNATURES[name]
    fn.restype = ctypes.c_int
    args = [bp.data_ptr(), *ptrs, *sizes]

    def launch():
        stream = torch.cuda.current_stream(bp.device).cuda_stream
        cuda_build.check(fn(*args, stream), name)
        return out[:-1]  # the scratch stays alive with the launch

    return launch


def same(got, want) -> bool:
    """Equal dtypes and bits."""
    return all(a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
        for a, b in zip(got, want))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, nargs="*", default=[],
                        help="other versions of csrc/backtrace.cu")
    parser.add_argument("--out", type=Path, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lane_walk_breakdown: needs a CUDA device")
    dev = torch.device("cuda", 0)
    src = (cuda_build.CSRC / "backtrace.cu").read_text()
    variants = {"kernel": src,
                **{f"kernel, {name}": patched(src, p)
                   for name, p in NEW.items()},
                **{f"vs {p.name}": p.read_text() for p in args.against}}
    turns = ["kernel"] + [f"vs {p.name}" for p in args.against]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        libs = build(variants, Path(tmp), KERNEL)
        result = {"card": card, "calls": CALLS, "ptxas": {
            name: libs[name][1] for name in turns}, "shapes": {}}
        for shape, (t, n, W, K) in SHAPES.items():
            bp, ck, scores = problem(shape, dev)
            s_cap = min(t, 512)
            row = {"T, N, W, K, s_cap": [t, n, W, K, s_cap]}
            fns = {}
            for name, (lib, _) in libs.items():
                fns[name] = runner(lib, bp, ck, W, K, scores, s_cap)
                fns[f"{name}, lane walk"] = runner(lib, bp, ck, W, K)
            for name, fn in fns.items():
                if name.startswith("kernel, ") and name != (
                        "kernel, lane walk"):
                    row[name] = device_ms(fn, CALLS)
            both = [x for name in turns for x in (name, f"{name}, lane walk")]
            for name in both + both[::-1]:
                row.setdefault(name, []).append(device_ms(fns[name], CALLS))
            mhz = under_load(fns["kernel"], 1.0)
            row["kernel MHz, W, C"] = mhz
            for name in ("kernel", "kernel, lane walk"):
                row[f"{name} cycles a frame"] = min(
                    x[0] for x in row[name]) * 1e-3 * mhz[0] * 1e6 / t
            want = [x.clone() for x in fns["kernel"]()]
            plain = beam_search_cuda.backtrace_plain(bp, ck, scores, W, K,
                                                     s_cap)
            row["backtrace_plain bit-equal"] = same(want, plain)
            walk = [x.clone() for x in fns["kernel, lane walk"]()]
            row["lane walk: host walk bit-equal"] = same(
                walk, beam_search_cuda.lane_walk_plain(bp, ck, W, K))
            for name in turns[1:]:
                row[f"{name} bit-equal"] = same(
                    walk, fns[f"{name}, lane walk"]()) and same(
                    want, fns[name]())
            for how, fn in (
                    ("the kernel", lambda: beam_search_cuda.backtrace(
                        bp, ck, scores, W, K, s_cap)),
                    ("the host walk, torch compaction",
                     lambda: beam_search_cuda.backtrace_plain(
                         bp, ck, scores, W, K, s_cap))):
                row[f"backtrace one call, {how}"] = time_ms(fn)
            result["shapes"][shape] = row
            del fns
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    bad = [f"{s}: {k}" for s, row in result["shapes"].items()
           for k, x in row.items() if k.endswith("bit-equal") and not x]
    if bad:
        raise SystemExit(f"outputs differ from the kernel's: {bad}")


if __name__ == "__main__":
    main()
