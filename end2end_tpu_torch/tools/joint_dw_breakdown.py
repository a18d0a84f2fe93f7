"""Where K12's time goes: time copies of csrc/rnnt_joint.cu's dW/db kernel
with one part of its work taken out, on one GPU.

    python -m end2end_tpu_torch.tools.joint_dw_breakdown [--source FILE]
        [--out FILE]

Each variant is the source with one text patch applied (no switch lives
in the kernel): the whole kernel, then without the h loads, without the
exps (d takes the exponent itself), without the db sums and without the
dW product.  A variant's time less the whole kernel's is what that part
costs beyond what overlaps it.  The patches know two versions of the
kernel: the split-row kernel in the package and the one-block-per-V-tile
kernel it replaced (its rnnt_joint.cu from the git history, passed with
--source).  Every variant is built by its own nvcc, all at once, into
csrc/build/ and timed with CUDA events (median of 5 after a warm-up),
then run back to back for 2 s while nvidia-smi samples the SM clock, the
power draw and the temperature (a kernel that draws less power keeps a
higher clock), at the JAX bench row (B=8, T=400, U=80: R = 259,200 rows,
J=128) at V=32768 (K12) and at one of D=4 vocabulary shards, V/D=8192
(K12tp).  Prints one JSON object with the card's name and power limit
(and writes it to --out if given).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ..ops import rnnt_joint_cuda
from ..utils import cuda_build

R, J = 8 * 400 * 81, 128
SHAPES = {"K12 (V=32768)": 32768, "K12tp (V/D=8192)": 8192}
# an H100 SXM's SMs, and the dense bf16 operations a clock on one SM's
# tensor cores (the data sheet's 989 TFLOP/s is 132 x 4096 x 1,830 MHz)
N_SMS, BF16_TC_OPS_PER_SM_CLOCK = 132, 4096

# name: [(text, replacement)]; every text must occur exactly once
OLD = {
    "no h load": [(
        "      __syncthreads();  // the previous row block's reads are done\n"
        "      load_h<NJ>(h, s, r0, R, J, 0, J);\n",
        "      __syncthreads();  // the previous row block's reads are done\n")],
    "no exp": [(
        "float d = -__expf((x - st.m) - st.logs) * (st.gb + st.gl);",
        "float d = -((x - st.m) - st.logs) * (st.gb + st.gl);")],
    "no db sums": [(
        "for (int r = 0; r < kRows; ++r) db_acc += s.x[r * kXld + "
        "threadIdx.x];",
        "db_acc += s.x[threadIdx.x];")],
    "no dW product": [(
        "        wmma::mma_sync(acc[jm], ht, dfr, acc[jm]);\n", "")],
}
NEW = {
    "no h load": [(
        "    cp_async16(hs + b * kHCols8 + a * kHRows8 + ri * 16,\n"
        "               live ? h + r * J + j : h, live);\n", "")],
    "no exp": [
        ("float da = ex2(fmaf(sacc[4 * nf + e], kLog2e, ba - mr)) * nc;",
         "float da = fmaf(sacc[4 * nf + e], kLog2e, ba - mr) * nc;"),
        ("float dv = ex2(fmaf(sacc[4 * nf + 2 + e], kLog2e, bb - mr)) * nc;",
         "float dv = fmaf(sacc[4 * nf + 2 + e], kLog2e, bb - mr) * nc;")],
    "no db sums": [("        dba += da;\n        dbb += dv;\n", "")],
    "no dW product": [(
        "      wgmma_rs<JP>(dacc, a[kk],\n"
        "                   smem_desc(hs + 2 * kk * kHRows8, kHRows8, "
        "kHCols8));\n", "      ;\n")],
}
_OLD_SIG = (ctypes.c_void_p,) * 10 + (ctypes.c_longlong,) + (
    ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def patched(src: str, patches) -> str:
    for text, repl in patches:
        if src.count(text) != 1:
            raise ValueError(f"patch text found {src.count(text)} times: "
                             f"{text!r}")
        src = src.replace(text, repl)
    return src


def build(variants: dict, out_dir: Path,
          kernel: str = "rnnt_joint_dw_kernelILi8ELb0E") -> dict:
    """nvcc each source (one process each, all at once) into a shared
    library; returns {name: (ctypes lib, ptxas lines of `kernel`, K12 at
    NJ=8 by default)}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build._nvcc()
    procs = {}
    for i, (name, src) in enumerate(variants.items()):
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(src)
        so = out_dir / f"variant{i}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        ptxas = []
        for k, line in enumerate(lines):
            if kernel in line and "entry" in line:
                ptxas = [x.strip() for x in lines[k:k + 4]
                         if "Used" in x or "spill" in x] + ptxas
            elif kernel in line and "wgmma" in line:  # ptxas's advisories
                ptxas.append(line.strip())
        libs[name] = (ctypes.CDLL(str(so)), ptxas)
    return libs


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int) -> tuple[float, str]:
    """Device time of one fn() call in ms, and how it was taken: `calls`
    calls captured in a CUDA graph and replayed between one pair of events
    ("graph"), so the card never waits for the host's work around the
    launches.  Where fn cannot be captured (it synchronises, or copies
    from pageable host memory), the device time of the kernels and copies
    of `calls` calls summed by torch.profiler ("profiler"), or, if the
    profiler records none, the calls back to back between one pair of
    events ("stream", host gaps included).  The first call is a warm-up
    (it builds the library)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls, "graph"
    except RuntimeError:
        torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us > 0:
        return us / 1e3 / calls, "profiler"
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls, "stream"


def under_load(fn, seconds=2.0):
    """Run fn() back to back for `seconds` while nvidia-smi samples the SM
    clock, the power draw and the temperature every 100 ms; their medians
    past the first quarter (MHz, W, C).  A card at its power or thermal
    limit clocks down, and every kernel's time with it."""
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()
    smi.terminate()
    rows = [[float(x) for x in line.split(",")]
            for line in smi.communicate()[0].splitlines()
            if line.count(",") == 2]
    rows = rows[len(rows) // 4:]
    return tuple(statistics.median(c) for c in zip(*rows))


@functools.cache
def max_sm_mhz() -> float:
    """The card's max SM clock in MHz (nvidia-smi's clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def tensor_ops_per_s() -> float:
    """The card's dense bf16 tensor-core rate at its max SM clock, the
    clock at which a bound is the least time the card could take."""
    return N_SMS * BF16_TC_OPS_PER_SM_CLOCK * max_sm_mhz() * 1e6


def inputs(v, dev, seed=0):
    """bf16 h (R, J) and W (J, V), and float32 / int32 row inputs."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.tanh(torch.randn(R, J, generator=gen, device=dev))
    w = torch.randn(J, v, generator=gen, device=dev) / J ** 0.5
    y = torch.randint(0, v, (R,), generator=gen, device=dev,
                      dtype=torch.int32)
    m = torch.full((R,), 4.0, device=dev)
    logs = torch.full((R,), float(torch.log(torch.tensor(float(v)))),
                      device=dev)
    gb, gl = -torch.rand(2, R, generator=gen, device=dev)
    return (h.to(torch.bfloat16), w.to(torch.bfloat16),
            torch.zeros(v, device=dev), y, m, logs, gb.contiguous(),
            gl.contiguous())


def launcher(lib, src, args, v, dev):
    """A function that launches the variant once (and its second pass)."""
    ptrs = [a.data_ptr() for a in args]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if "rnnt_joint_dw_sum_kernel" not in src:
        dw = torch.empty((J, v), device=dev)
        db = torch.empty(v, device=dev)
        fn = lib.e2e_rnnt_joint_dw
        fn.argtypes, fn.restype = _OLD_SIG, ctypes.c_int
        return (lambda: cuda_build.check(fn(
            *ptrs, dw.data_ptr(), db.data_ptr(), R, J, v, v, 0, stream),
            "old K12")), {}
    plan_fn = lib.e2e_rnnt_joint_dw_plan
    plan_fn.argtypes = cuda_build._SIGNATURES["e2e_rnnt_joint_dw_plan"]
    info = (ctypes.c_int * 5)()
    cuda_build.check(plan_fn(J, info), "plan")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile = int(re.search(r"constexpr int kDwTile = (\d+);", src).group(1))
    splits = rnnt_joint_cuda.plan_splits(R, -(-v // tile), sms, info[0])
    out = torch.empty((J + 1) * v, device=dev)
    ws = torch.empty((splits, out.numel()), device=dev)
    fn = lib.e2e_rnnt_joint_dw
    fn.argtypes = cuda_build._SIGNATURES["e2e_rnnt_joint_dw"]
    plan = {"splits": splits, "blocks": -(-v // tile) * splits, "tile": tile,
            "blocks_per_sm": info[0], "regs": info[1], "smem": info[2],
            "spill_bytes": info[3], "stages": info[4]}
    return (lambda: cuda_build.check(fn(
        *ptrs, out.data_ptr(), ws.data_ptr(), R, J, v, v, 0, splits, stream),
        "K12")), plan


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", type=Path,
                        default=cuda_build.CSRC / "rnnt_joint.cu")
    parser.add_argument("--out", type=Path, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("joint_dw_breakdown: needs a CUDA device")
    dev = torch.device("cuda", 0)
    src = args.source.read_text()
    new = "rnnt_joint_dw_sum_kernel" in src
    variants = {"whole": src, **{name: patched(src, p) for name, p in
                                 (NEW if new else OLD).items()}}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        libs = build(variants, Path(tmp))
        result = {"card": card, "source": str(args.source),
                  "kernel": "split rows" if new else "one block per V tile",
                  "R": R, "J": J, "ptxas": libs["whole"][1], "shapes": {}}
        for shape, v in SHAPES.items():
            data = inputs(v, dev)
            row = {}
            for name, (lib, _) in libs.items():
                fn, plan = launcher(lib, src, data, v, dev)
                row[name] = time_ms(fn)
                row[f"{name} MHz, W, C"] = under_load(fn)
                if name == "whole":
                    row["plan"] = plan
            result["shapes"][shape] = row
            del data
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
