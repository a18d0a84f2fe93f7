"""Where K3's time goes (csrc/topk.cu): time the top-k kernel, the K3 it
replaced and torch.topk in turns on one GPU, with text-patched variants
of the kernel and its other plans.

    python -m end2end_tpu_torch.tools.topk_breakdown [--against FILE...]
        [--out FILE]

The sibling of beam_step_breakdown, with its build, timing and
clock/power sampler.  The parent is tools/topk_reference.cu, the K3 kept
verbatim (a warp a row, k rounds of a rescan and a shuffle butterfly).
Shapes (seeded normal rows): the serving slice's top-k (T'=750, B=8, V=32,
k=24), the LM decode's at B=128 (T=1000, V=29, k=24), the beam decoder's
reference shape (B=32, T=1000, V=1024, k=24) and bench.py's beam-16 row
(k=40).  At each shape: `topk_plan`'s launch; the variants of NEW (no
switch lives in the kernel): the select path with scalar loads only,
without the first chunk's bound (all of the first chunk admitted), with
2 or 8 warps a block, and without its merges (wrong outputs on
purpose: it times the loads and the admission alone); the kernel at the
other plans of OTHER_PLANS (a longer list, the rounds); then the kernel,
the parent, torch.topk and any --against files (other topk.cu versions,
with this entry point or the parent's) in turns, each once in order and
then in the reverse order, their values and indices compared bit for bit
with the kernel's and with `topk_plain`'s.  Times are device times
(`device_ms`: CALLS calls in a CUDA graph); the card's SM clock, power
and temperature are sampled while the kernel and the parent run back to
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

from ..ops import topk_cuda
from ..utils import cuda_build
from .joint_dw_breakdown import build, device_ms, patched, under_load

REFERENCE = Path(__file__).resolve().with_name("topk_reference.cu")
KERNEL = "topk"  # every kernel's ptxas lines
CALLS = 50
SHAPES = {  # name: (T, B, V, k)
    "main": (750, 8, 32, 24),
    "b128": (1000, 128, 29, 24),
    "ref": (1000, 32, 1024, 24),
    "beam16": (1000, 32, 1024, 40),
}
# name: [(text, replacement)] on csrc/topk.cu; every text occurs once
NEW = {
    "scalar loads": [("    if (aligned && c0 + kChunk <= v) {\n",
                      "    if (false) {\n")],
    "no first-chunk bound": [(
        "    if (c0 == 0 && k <= 32 && v >= kChunk) {\n",
        "    if (false) {\n")],
    "2 warps a block": [("constexpr int kWarps = 4;",
                         "constexpr int kWarps = 2;")],
    "8 warps a block": [("constexpr int kWarps = 4;",
                         "constexpr int kWarps = 8;")],
    "no merges": [(
        "      merge_sorted<M>(list, segment_sort_desc<32>(buf[held + lane], "
        "lane),\n                      lane);\n",
        "      list[0] = list[0] > buf[held + lane] ? list[0] : "
        "buf[held + lane];\n"), (  # the list's indices stay in the row
        "      vals[row * k + e] = __ldg(xr + i);\n",
        "      vals[row * k + e] = __ldg(xr + (i & 0x7fffffff) % v);\n")],
}
# name: plan overrides (select-path shapes only)
OTHER_PLANS = {"list 64": {"list": 64}, "list 256": {"list": 256},
               "rounds": {"path": "rounds", "list": 0}}
# the parent's entry point: x, vals, idx, rows, v, k, stream
PARENT_SIG = (ctypes.c_void_p,) * 3 + (ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p)


def problem(name: str, dev, seed: int = 0) -> torch.Tensor:
    """The shape's (T, B, V) float32 rows, seeded normal values."""
    t, b, v, _ = SHAPES[name]
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.standard_normal((t, b, v)).astype(np.float32)).to(dev)


def runner(lib, x, k, plan=None):
    """A function that launches one top-k of `lib` on x into fixed outputs
    and returns (values, indices): with `plan` (a dict) csrc/topk.cu's
    entry point, else the parent's."""
    v = x.shape[-1]
    rows = x.numel() // v
    vals = torch.empty((*x.shape[:-1], k), device=x.device)
    idx = torch.empty((*x.shape[:-1], k), dtype=torch.int32,
                      device=x.device)
    if plan is None:
        name = ("e2e_topk_reference_f32" if hasattr(
            lib, "e2e_topk_reference_f32") else "e2e_topk_f32")
        fn = getattr(lib, name)
        fn.argtypes = PARENT_SIG
        args = [x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, v, k]
    else:
        name = "e2e_topk_f32"
        fn = lib.e2e_topk_f32
        fn.argtypes = cuda_build._SIGNATURES[name]
        args = [x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, v, k,
                plan["segment"], plan["list"]]
    fn.restype = ctypes.c_int

    def launch():
        stream = torch.cuda.current_stream(x.device).cuda_stream
        cuda_build.check(fn(*args, stream), name)
        return vals, idx

    return launch


def build_reference(out_dir: Path):
    """The replaced K3 (tools/topk_reference.cu) as a ctypes library in
    out_dir, and its ptxas lines."""
    return build({"parent": REFERENCE.read_text()}, out_dir,
                 KERNEL)["parent"]


def same_bits(got, want) -> bool:
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, nargs="*", default=[],
                        help="other versions of csrc/topk.cu")
    parser.add_argument("--out", type=Path, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("topk_breakdown: needs a CUDA device")
    dev = torch.device("cuda", 0)
    src = (cuda_build.CSRC / "topk.cu").read_text()
    variants = {"kernel": src, "parent": REFERENCE.read_text(),
                **{f"kernel, {name}": patched(src, p)
                   for name, p in NEW.items()},
                **{f"vs {p.name}": p.read_text() for p in args.against}}
    # the parent's entry point takes no plan
    planned = {name: "int list," in text for name, text in variants.items()}
    turns = ["kernel", "parent", "torch.topk"] + [
        f"vs {p.name}" for p in args.against]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        libs = build(variants, Path(tmp), KERNEL)
        result = {"card": card, "calls": CALLS,
                  **{f"{name} ptxas": libs[name][1] for name in
                     ("kernel", "parent")}, "shapes": {}}
        for shape, (t, b, v, k) in SHAPES.items():
            x = problem(shape, dev)
            plan = topk_cuda.topk_plan(v, k)
            row = {"T, B, V, k": [t, b, v, k], "plan": plan}
            fns = {name: runner(lib, x, k, plan if planned[name] else None)
                   for name, (lib, _) in libs.items()}
            fns["torch.topk"] = lambda: torch.topk(x, k)
            for name, fn in fns.items():
                if name.startswith("kernel, ") and (
                        plan["path"] == "select" or "warps" in name):
                    row[name] = device_ms(fn, CALLS)
            if plan["path"] == "select":
                for name, over in OTHER_PLANS.items():
                    other = {**plan, **over}
                    if other["list"] and other["list"] < k:
                        continue
                    fn = runner(libs["kernel"][0], x, k, other)
                    row[f"kernel, {name}"] = device_ms(fn, CALLS)
                    row[f"kernel, {name} bit-equal"] = same_bits(
                        fn(), fns["kernel"]())
            for name in turns + turns[::-1]:
                row.setdefault(name, []).append(device_ms(fns[name], CALLS))
            for name in ("kernel", "parent"):
                row[f"{name} MHz, W, C"] = under_load(fns[name], 1.0)
            want = [y.clone() for y in fns["kernel"]()]
            row["plain bit-equal"] = same_bits(want,
                                               topk_cuda.topk_plain(x, k))
            for name in turns[1:]:
                if name != "torch.topk":
                    row[f"{name} bit-equal"] = same_bits(want, fns[name]())
            row["torch.topk values bit-equal"] = same_bits(
                want[:1], fns["torch.topk"]()[:1])
            result["shapes"][shape] = row
            del fns
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    bad = [f"{s}: {k}" for s, row in result["shapes"].items()
           for k, x in row.items()
           if k.endswith("bit-equal") and not x and "torch.topk" not in k]
    if bad:
        raise SystemExit(f"outputs differ from the kernel's: {bad}")


if __name__ == "__main__":
    main()
