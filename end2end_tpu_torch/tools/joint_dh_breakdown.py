"""Where K11's time goes: time copies of csrc/rnnt_joint.cu's dh kernel
with one part of its work taken out, on one GPU.

    python -m end2end_tpu_torch.tools.joint_dh_breakdown [--source FILE]
        [--against FILE ...] [--out FILE]

The sibling of joint_dw_breakdown (K12), with its build, timing and
clock/power sampler.  Each variant is the source with one text patch
applied (no switch lives in the kernel): the whole kernel, then without
the W loads, without the exps (d takes the exponent itself) and without
the dh product (each k-step's packed bf16 d is folded into the dh
accumulators by integer XOR and one add instead, so that d, its exps and
the packing stay live: ptxas drops what feeds nothing).  A variant's time
less the whole kernel's is what that part costs beyond what overlaps
it.  Each shape also reports the logits' own tensor time at the card's
max SM clock, a floor that every variant of the wgmma kernel keeps.  The patches know two versions of
the kernel: the wgmma kernel in the package and the wmma kernel it
replaced (its rnnt_joint.cu from the git history, passed with --source).
--against times other versions of the wgmma kernel (whole rnnt_joint.cu
files, such as a design alternative) beside the whole kernel, in turns:
each once in order, then again in the reverse order.
Every variant is built by its own nvcc, all at once, and timed with CUDA
events (median of 5 after a warm-up), then run back to back for 2 s while
nvidia-smi samples the SM clock, the power draw and the temperature, at
the JAX bench row (B=8, T=400, U=80: R = 259,200 rows, J=128) at V=32768
(K11) and at one of D=4 vocabulary shards, V/D=8192 (K11tp).  Prints one
JSON object with the card's name and power limit (and writes it to --out
if given).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import rnnt_joint_cuda
from ..utils import cuda_build
from .joint_dw_breakdown import (build, inputs, patched, tensor_ops_per_s,
                                 time_ms, under_load)

R, J = 8 * 400 * 81, 128
SHAPES = {"K11 (V=32768)": 32768, "K11tp (V/D=8192)": 8192}
KERNEL = "rnnt_joint_dh_kernelILi8ELb0E"  # ptxas's name of K11 at J = 128

# name: [(text, replacement)]; every text must occur exactly once
OLD = {
    "no W load": [(
        "      load_w(w, s, c0, 0, J, Vp);\n"
        "      load_bias(b, s, c0, V);\n"
        "      __syncthreads();\n"
        "      logits_tile<NJ>(s);\n"
        "      __syncthreads();\n",
        "      load_bias(b, s, c0, V);\n"
        "      __syncthreads();\n"
        "      logits_tile<NJ>(s);\n"
        "      __syncthreads();\n")],
    "no exp": [(
        "float d = -__expf((x - st.m) - st.logs) * (st.gb + st.gl);",
        "float d = -((x - st.m) - st.logs) * (st.gb + st.gl);")],
    "no dh product": [(
        "          wmma::mma_sync(acc[i], a, wt, acc[i]);\n", "")],
}
NEW = {
    "no W load": [(
        "    mbar_expect_tx(bar, stage);\n"
        "    bulk_copy(dst, w + ((size_t)c0 * nslab + jq * kTile) * JP, "
        "L::w_bytes,\n"
        "              bar);\n",
        "    mbar_expect_tx(bar, stage - L::w_bytes);\n")],
    "no exp": [(
        "      sacc[4 * nf] = ex2(fmaf(sacc[4 * nf], kLog2e, bc.x - Ma)) "
        "* nca;\n"
        "      sacc[4 * nf + 1] = ex2(fmaf(sacc[4 * nf + 1], kLog2e, "
        "bc.y - Ma)) * nca;\n"
        "      sacc[4 * nf + 2] = ex2(fmaf(sacc[4 * nf + 2], kLog2e, "
        "bc.x - Mb)) * ncb;\n"
        "      sacc[4 * nf + 3] = ex2(fmaf(sacc[4 * nf + 3], kLog2e, "
        "bc.y - Mb)) * ncb;\n",
        "      sacc[4 * nf] = fmaf(sacc[4 * nf], kLog2e, bc.x - Ma) * nca;\n"
        "      sacc[4 * nf + 1] = fmaf(sacc[4 * nf + 1], kLog2e, "
        "bc.y - Ma) * nca;\n"
        "      sacc[4 * nf + 2] = fmaf(sacc[4 * nf + 2], kLog2e, "
        "bc.x - Mb) * ncb;\n"
        "      sacc[4 * nf + 3] = fmaf(sacc[4 * nf + 3], kLog2e, "
        "bc.y - Mb) * ncb;\n")],
    "no dh product": [(
        "      wgmma_rs<JP, kKMajor>(\n"
        "          dacc, a[kk], smem_desc(ws + 2 * kk * kDhStep8, kDhStep8, "
        "kDhJ8));\n",
        "      dacc[kk] += __uint_as_float(a[kk][0] ^ a[kk][1] ^ a[kk][2] ^ "
        "a[kk][3]);\n")],
}


def launcher(lib, new, args, v, dev):
    """A function that launches the variant once, and its plan (the new
    kernel's resources)."""
    if new:  # the wgmma kernel takes W in its W tiles' layout, b in log2
        args = (args[0], rnnt_joint_cuda.w_tiles(args[1], J),
                rnnt_joint_cuda.dh_bias(args[2], v), *args[3:])
    stream = torch.cuda.current_stream(dev).cuda_stream
    # room for either kernel's output: the old one wrote whole 64-row
    # blocks of 128 columns, the new one (R, J)
    out = torch.empty((-(-R // 128) * 128, 128), device=dev)
    fn = lib.e2e_rnnt_joint_dh
    fn.argtypes = cuda_build._SIGNATURES["e2e_rnnt_joint_dh"]
    plan = {}
    if new:
        plan_fn = lib.e2e_rnnt_joint_dh_plan
        plan_fn.argtypes = cuda_build._SIGNATURES["e2e_rnnt_joint_dh_plan"]
        keys = rnnt_joint_cuda.DH_PLAN_KEYS
        info = (ctypes.c_int * len(keys))()
        cuda_build.check(plan_fn(J, info), "plan")
        plan = {"blocks": -(-R // 128), **dict(zip(keys, info))}

    def launch():
        cuda_build.check(fn(*(a.data_ptr() for a in args), out.data_ptr(),
                            R, J, v, v, 0, stream), "K11")

    return launch, plan


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", type=Path,
                        default=cuda_build.CSRC / "rnnt_joint.cu")
    parser.add_argument("--against", type=Path, nargs="*", default=[],
                        help="other versions of the wgmma kernel's source")
    parser.add_argument("--out", type=Path, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("joint_dh_breakdown: needs a CUDA device")
    dev = torch.device("cuda", 0)
    src = args.source.read_text()
    new = "e2e_rnnt_joint_dh_plan" in src
    variants = {"whole": src, **{name: patched(src, p) for name, p in
                                 (NEW if new else OLD).items()}}
    turns = ["whole"] + [f"vs {p.name}" for p in args.against]
    variants.update({f"vs {p.name}": p.read_text() for p in args.against})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        libs = build(variants, Path(tmp), KERNEL)
        result = {"card": card, "source": str(args.source),
                  "kernel": "wgmma, 128 rows" if new else "wmma, 64 rows",
                  "R": R, "J": J, "ptxas": libs["whole"][1], "shapes": {}}
        for name in turns[1:]:
            result[f"{name} ptxas"] = libs[name][1]
        for shape, v in SHAPES.items():
            data = inputs(v, dev)
            row = {"logits tensor ms": 2 * R * J * v / tensor_ops_per_s()
                   * 1e3}
            fns = {}
            for name, (lib, _) in libs.items():
                fns[name], plan = launcher(lib, new or name in turns[1:],
                                           data, v, dev)
                row[name] = time_ms(fns[name])
                row[f"{name} MHz, W, C"] = under_load(fns[name])
                if name in turns:
                    row[f"{name} plan"] = plan
            if len(turns) > 1:
                for name in reversed(turns):
                    row[f"{name} again"] = time_ms(fns[name])
            result["shapes"][shape] = row
            del data
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
