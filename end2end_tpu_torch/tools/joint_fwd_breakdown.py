"""Where K10's time goes: time copies of csrc/rnnt_joint.cu's forward kernel
with one part of its work taken out, on one GPU.

    python -m end2end_tpu_torch.tools.joint_fwd_breakdown [--source FILE]
        [--against FILE ...] [--out FILE]

The sibling of joint_dh_breakdown (K11) and joint_dw_breakdown (K12), with
their build, timing and clock/power sampler.  Each variant is the source
with one text patch applied (no switch lives in the kernel): the whole
kernel, then without the W copies (each stage keeps the W tile of its
first fill), without the exps (the sum takes the
exponent itself), without the products (the accumulators are halved once a
tile instead, so that the exps still read values that change: ptxas drops
what feeds nothing), and with two and with one warpgroup per block instead
of four.  A variant's time less the whole kernel's is what that part costs
beyond what overlaps it.  Each shape also reports two floors at the card's
max SM clock: the logits' own tensor time (2 R J V bf16 operations) and
the exps' own time (R V at 16 a clock per SM).

The patches know two versions of the kernel: the wgmma kernel in the
package and the wmma kernel it replaced (tools/joint_fwd_reference.cu, or
the parent's rnnt_joint.cu from the git history, passed with --source).
For the wgmma kernel the wmma kernel is also timed beside the whole kernel
in turns (A B B A) on the device (`device_ms`), its outputs compared.
--against takes other versions of rnnt_joint.cu (such as the parent's, or
a design alternative): their K10 is timed in the turns too, and where they
hold K11 and K12, these run on the same inputs as this source's, in turns,
with the outputs compared bit for bit.  Every variant is built by its own
nvcc, all at once, and timed with CUDA events (median of 5 after a
warm-up), then run back to back for 2 s while nvidia-smi samples the SM
clock, the power draw and the temperature, at the JAX bench row (B=8,
T=400, U=80: R = 259,200 rows, J=128) at V=32768 (K10) and at one of D=4
vocabulary shards, V/D=8192 (K10tp, raw outputs).  Prints one JSON object
with the card's name and power limit (and writes it to --out if given).
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
from .joint_dw_breakdown import (N_SMS, build, device_ms, inputs, max_sm_mhz,
                                 patched, tensor_ops_per_s, time_ms,
                                 under_load)

R, J = 8 * 400 * 81, 128
SHAPES = {"K10 (V=32768)": (32768, 0), "K10tp (V/D=8192)": (8192, 1)}
KERNEL = "rnnt_joint_fwd_kernelILi8ELb0E"  # ptxas's name of K10 at J = 128
REFERENCE = Path(__file__).resolve().with_name("joint_fwd_reference.cu")
PARENT = "wmma K10"  # the reference's name among the variants
EXP_PER_SM_CLOCK = 16

# name: [(text, replacement)]; every text must occur exactly once
OLD = {
    "no W load": [("      load_w(w, s, c0, 0, J, Vp);\n", "")],
    "no exp": [(
        "      if (c0 + seg + 4 * i < V) part += __expf(vals[i] - m_new);\n",
        "      if (c0 + seg + 4 * i < V) part += vals[i] - m_new;\n")],
    "no products": [("  logits_mma<NJ>(s, acc);\n", "")],
}
NEW = {
    "no W copy": [(  # past the first fills the stages keep their W tiles
        "    mbar_expect_tx(bar, stage);  // W, h when it streams, the bias\n"
        "    bulk_copy(dst, wsrc, L::w_bytes, bar);\n",
        "    mbar_expect_tx(bar, it < S ? stage : stage - L::w_bytes);\n"
        "    if (it < S) bulk_copy(dst, wsrc, L::w_bytes, bar);\n")],
    "no exp": [(
        "        sa0 += ex2(acc[4 * nf] - Ma);\n"
        "        sa1 += ex2(acc[4 * nf + 1] - Ma);\n"
        "        sb0 += ex2(acc[4 * nf + 2] - Mb);\n"
        "        sb1 += ex2(acc[4 * nf + 3] - Mb);\n",
        "        sa0 += acc[4 * nf] - Ma;\n"
        "        sa1 += acc[4 * nf + 1] - Ma;\n"
        "        sb0 += acc[4 * nf + 2] - Mb;\n"
        "        sb1 += acc[4 * nf + 3] - Mb;\n")],
    "no products": [(
        "        wgmma_ss<128, kKMajor, kMNMajor>(\n"
        "            acc, smem_desc(ha + k * 2 * hj8, hj8, kDhStep8),\n"
        "            smem_desc(ws + 2 * k * kDhJ8, kDhJ8, kDhStep8), "
        "k > 0 || q > 0);\n",
        "        if (k == 0)\n"
        "#pragma unroll\n"
        "          for (int i = 0; i < 64; ++i) acc[i] *= 0.5f;\n")],
    "two warpgroups": [("static constexpr int groups = WIDE ? 2 : 4;",
                        "static constexpr int groups = WIDE ? 2 : 2;")],
    "one warpgroup": [("static constexpr int groups = WIDE ? 2 : 4;",
                       "static constexpr int groups = WIDE ? 2 : 1;")],
}
_OLD_FWD = (ctypes.c_void_p,) * 8 + (ctypes.c_longlong,) + (
    ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def is_old(src: str) -> bool:
    """The wmma kernel (the reference, or the parent's rnnt_joint.cu)."""
    return "logits_tile_wide" in src


def _plan(lib, rows):
    if not hasattr(lib, "e2e_rnnt_joint_fwd_plan"):  # the parent's library
        return {"blocks": -(-R // rows)}
    fn = lib.e2e_rnnt_joint_fwd_plan
    fn.argtypes, fn.restype = (ctypes.c_int, ctypes.c_void_p), ctypes.c_int
    keys = rnnt_joint_cuda.DH_PLAN_KEYS  # K10's plan has K11's keys
    info = (ctypes.c_int * len(keys))()
    cuda_build.check(fn(J, info), "plan")
    return {"blocks": -(-R // rows), **dict(zip(keys, info))}


def _caller(fn, tensors, tail, dev, what):
    """A function that calls the C entry `fn` with the tensors' pointers,
    `tail` and the current stream (a graph captures its own); it holds the
    tensors, so their memory outlives it."""
    def call():
        cuda_build.check(fn(*(x.data_ptr() for x in tensors), *tail,
                            torch.cuda.current_stream(dev).cuda_stream), what)

    return call


def launcher(lib, old, data, v, raw, dev):
    """A function that launches the variant once, its (4, R) output and its
    plan."""
    h, w, b, y = data[:4]
    out = torch.empty((4, R), device=dev)
    fn = lib.e2e_rnnt_joint_fwd
    fn.restype = ctypes.c_int
    if old:
        fn.argtypes = _OLD_FWD
        args = (h, w, b, y)
    else:  # W in its tiles' layout, b natural and in log2 units
        fn.argtypes = cuda_build._SIGNATURES["e2e_rnnt_joint_fwd"]
        args = (h, rnnt_joint_cuda.w_tiles(w, J), b,
                rnnt_joint_cuda.dh_bias(b, v), y)
    launch = _caller(fn, (*args, *out), (R, J, v, v, 0, raw), dev, "K10")
    return launch, out, _plan(lib, 64 if old else
                              rnnt_joint_cuda.fwd_rows(J))


def build_reference(out_dir: Path):
    """The wmma K10 (tools/joint_fwd_reference.cu) as a ctypes library in
    out_dir, and its ptxas lines."""
    return build({PARENT: REFERENCE.read_text()}, out_dir, KERNEL)[PARENT]


def runner(lib, args, raw):
    """A function that runs the wmma K10 of `lib` (K10tp with `raw`) once
    on the float32 (h, w, b, y, blank) as its wrapper did, the bf16 casts
    included, and returns its (4, R) output."""
    h, w, b, y, blank = args
    r, j = h.shape
    v = w.shape[1]
    out = torch.empty((4, r), device=h.device)
    fn = lib.e2e_rnnt_joint_fwd
    fn.argtypes, fn.restype = _OLD_FWD, ctypes.c_int

    def run():
        hb = h.to(torch.bfloat16)
        wb, vp = rnnt_joint_cuda._bf16_w(w, v)
        cuda_build.check(fn(
            hb.data_ptr(), wb.data_ptr(), b.data_ptr(), y.data_ptr(),
            *(o.data_ptr() for o in out), r, j, v, vp, blank, raw,
            torch.cuda.current_stream(h.device).cuda_stream), PARENT)
        return out

    return run


def backward_turns(libs, names, data, v, dev):
    """K11 and K12 of each library in `names` on the same inputs: device ms
    in turns (A B B A), and whether each one's outputs equal the first's
    bit for bit."""
    h, w, b, y, m, logs, gb, gl = data
    wt, b2 = rnnt_joint_cuda.w_tiles(w, J), rnnt_joint_cuda.dh_bias(b, v)
    rows = {}
    for kernel in ("dh", "dw"):
        plan = rnnt_joint_cuda.dw_plan(R, J, v, dev) if kernel == "dw" else {}
        splits = plan.get("splits", 1)
        fns, outs = {}, {}
        for name in names:
            lib = libs[name][0]
            fn = getattr(lib, f"e2e_rnnt_joint_{kernel}")
            fn.argtypes = cuda_build._SIGNATURES[f"e2e_rnnt_joint_{kernel}"]
            fn.restype = ctypes.c_int
            if kernel == "dh":
                out = torch.empty((R, J), device=dev)
                fns[name] = _caller(fn, (h, wt, b2, y, m, logs, gb, gl, out),
                                    (R, J, v, v, 0), dev, "K11")
            else:
                out = torch.empty((J + 1) * v, device=dev)
                ws = torch.empty((splits, out.numel()), device=dev)
                fns[name] = _caller(
                    fn, (h, w, b, y, m, logs, gb, gl, out, ws),
                    (R, J, v, v, 0, splits), dev, "K12")
            outs[name] = out
        times = {name: [] for name in names}
        for name in [*names, *reversed(names)]:
            times[name].append(device_ms(fns[name], 10)[0])
        torch.cuda.synchronize()
        first = outs[names[0]]
        rows[f"K{11 if kernel == 'dh' else 12} device ms"] = times
        rows[f"K{11 if kernel == 'dh' else 12} bit-equal"] = {
            name: bool(torch.equal(outs[name], first)) for name in names}
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", type=Path,
                        default=cuda_build.CSRC / "rnnt_joint.cu")
    parser.add_argument("--against", type=Path, nargs="*", default=[],
                        help="other versions of rnnt_joint.cu")
    parser.add_argument("--out", type=Path, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("joint_fwd_breakdown: needs a CUDA device")
    dev = torch.device("cuda", 0)
    src = args.source.read_text()
    old = is_old(src)
    variants = {"whole": src, **{name: patched(src, p) for name, p in
                                 (OLD if old else NEW).items()}}
    turns = ["whole"]
    if not old:
        variants[PARENT] = REFERENCE.read_text()
        turns.append(PARENT)
    for p in args.against:
        variants[f"vs {p}"] = p.read_text()
        turns.append(f"vs {p}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        libs = build(variants, Path(tmp), KERNEL)
        result = {"card": card, "max SM MHz": max_sm_mhz(),
                  "source": str(args.source),
                  "kernel": "wmma, 64 rows" if old else "wgmma, 256 rows",
                  "R": R, "J": J, "ptxas": {n: libs[n][1] for n in turns},
                  "shapes": {}}
        exp_per_s = N_SMS * EXP_PER_SM_CLOCK * max_sm_mhz() * 1e6
        for shape, (v, raw) in SHAPES.items():
            data = inputs(v, dev)
            row = {"logits tensor ms": 2 * R * J * v / tensor_ops_per_s()
                   * 1e3, "exps ms": R * v / exp_per_s * 1e3}
            fns, outs = {}, {}
            for name, (lib, _) in libs.items():
                fns[name], outs[name], plan = launcher(
                    lib, is_old(variants[name]), data, v, raw, dev)
                row[name] = time_ms(fns[name])
                row[f"{name} MHz, W, C"] = under_load(fns[name])
                if name in turns:
                    row[f"{name} plan"] = plan
            for name in turns[1:]:
                fns[name]()
                fns["whole"]()
                torch.cuda.synchronize()
                row[f"{name} max abs diff"] = float(
                    (outs[name] - outs["whole"]).abs().max())
            if len(turns) > 1:
                row["device ms in turns"] = {
                    name: [device_ms(fns[name], 10)[0]] for name in turns}
                for name in reversed(turns):
                    row["device ms in turns"][name].append(
                        device_ms(fns[name], 10)[0])
            backward = [n for n in turns
                        if "e2e_rnnt_joint_dh" in variants[n]]
            if len(backward) > 1:
                row.update(backward_turns(libs, backward, data, v, dev))
            result["shapes"][shape] = row
            del data
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
