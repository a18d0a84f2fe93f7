"""Run one cell of the port's benchmark once.

    python3 e2e_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (`python3 -m e2e_bench.run ...` works too).
It needs CUDA devices, as many as the cell asks for, and exits with 2
without them.  Set-up (weights and inputs drawn from the seed, a warm-up
at every shape, the checked first steps) is followed by a window of
`--seconds`, the check against the plain reference, and one JSON line on
standard output: the end-to-end metrics (`--trace 0`) or the per-layer
ones (`--trace 1`, read from torch.profiler over a fixed slice of the
window).  The numbers checked go to standard error as its last lines,
each beside its limit, and into the JSON line's last key, `checks`.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "e2e_bench":
    sys.path[0] = str(ROOT)  # run as a script: no module here shadows others
FORBIDDEN = ("jax", "jaxlib", "flax", "end2end_tpu")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name is one that the port's
    benchmark must never load, compared as whole names."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _caches():
    """Build and kernel caches at fixed paths inside the checkout."""
    base = ROOT / ".e2e_bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    import torch

    from e2e_bench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"e2e_bench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    harness.apply_precision(cell.cfg)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda:0", T_START, ROOT)
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"e2e_bench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    notes = out.pop("notes")
    print("e2e_bench: " + " ".join(f"{k}={v}" for k, v in notes.items()),
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"e2e_bench check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    for c in out["checks"].values():
        if not math.isfinite(c["value"]):
            c["value"] = None  # not a number: printed as null
    print(json.dumps(out, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
