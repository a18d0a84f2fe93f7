"""Run cells several times, each run its own process, and summarise the
spread of each metric, as the bounds in `BENCHMARK.json` are set from.

    python3 e2e_bench/repeat.py --workload <cell> --seeds 11 12 ... \
        --out DIR [--sets 2] [--seconds S] [--trace 0|1]

Runs `e2e_bench/run.py` once a seed, `--sets` times over the same seeds;
each run's standard output and error are kept in `--out`.  Prints one
JSON line a run, then a line a metric: each set's median and its spread,
the distance between the first and third quartiles
(`statistics.quantiles(values, n=4)`) over the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    sets = []
    for s in range(args.sets):
        runs = []
        for seed in args.seeds:
            cmd = [sys.executable, str(ROOT / "e2e_bench" / "run.py"),
                   "--workload", args.workload, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(args.trace)]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            stem = out / f"{args.workload}.s{s}.{seed}.t{args.trace}"
            stem.with_suffix(".out").write_text(p.stdout)
            stem.with_suffix(".err").write_text(p.stderr)
            line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() \
                else "{}"
            try:
                res = json.loads(line)
            except json.JSONDecodeError:
                res = {}
            print(json.dumps({"set": s, "seed": seed, "rc": p.returncode,
                              "wall_s": wall, **res}), flush=True)
            if p.returncode == 0 and res:
                runs.append(res)
        sets.append(runs)
    names = sorted({m for runs in sets for r in runs for m in r["metrics"]})
    for name in names:
        row = {"metric": name}
        for s, runs in enumerate(sets):
            vals = [r["metrics"][name]["value"] for r in runs
                    if name in r["metrics"]]
            if len(vals) >= 2:
                row[f"set{s}"] = {"median": statistics.median(vals),
                                  "spread": spread(vals), "n": len(vals),
                                  "values": vals}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
