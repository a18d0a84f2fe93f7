"""A cell's traced slice by the port's spans, and what tracing costs.

    python3 -m e2e_bench.span_report --workload <cell> --seed <n> \
        [--out <dir>]

from the root of a checkout, on a CUDA device.  After the cell's set-up
it runs the steps of the harness's traced slice (the mix's `trace`: skip,
count) three times: untraced, under the harness's profiler, untraced
again; then reduces the trace with `spans.SpanTrace` and prints one JSON
object: device and idle seconds by span, the share of device time under
no span, the synchronising calls by span, the spans a step records, the
traced window against the untraced steps, the readings of the cell's
per-layer metrics and of those in `spans.READINGS`.  A fourth pass
records Python stacks, to name the port's function and the call around
each sync.  `--out` keeps the JSON there, and the trace, gzipped.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "e2e_bench":
    sys.path[0] = str(ROOT)

from e2e_bench import harness, spans  # noqa: E402
from e2e_bench import trace as trace_mod  # noqa: E402


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(entry, ks, dev) -> float:
    _sync(dev)
    t = time.perf_counter()
    for k in ks:
        entry.step(k)
    _sync(dev)
    return time.perf_counter() - t


def _profiled(entry, ks, dev, stack: bool = False):
    """The steps under torch.profiler in `e2e.slice`, as the harness
    traces them; returns (the works, the trace's path)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts, with_stack=stack)
    rf = torch.profiler.record_function("e2e.slice")
    _sync(dev)
    prof.__enter__()
    rf.__enter__()
    works = [entry.step(k) for k in ks]
    _sync(dev)
    rf.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(str(path))
    return works, path


def sync_sites(path) -> Counter:
    """{(span, the port's innermost function > the call it made): syncs}
    from a trace recorded with Python stacks."""
    st = spans.SpanTrace(path)
    with open(path) as f:
        frames = {}
        for e in json.load(f)["traceEvents"]:
            if e.get("ph") == "X" and e.get("cat") == "python_function":
                frames.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]))
    out = Counter()
    for label, name, th, t in st.sync_labels():
        if not spans.is_port(label):
            continue
        open_ = sorted((f for f in frames.get(th, ()) if f[0] <= t < f[1]),
                       key=lambda f: f[0])
        port = [i for i, f in enumerate(open_)
                if "end2end_tpu_torch/" in f[2]]
        site = "?"
        if port:
            i = port[-1]
            call = open_[i + 1][2] if i + 1 < len(open_) else name
            site = (open_[i][2].split("end2end_tpu_torch/")[-1] + " > "
                    + call.split(" at 0x")[0][:80])
        out[f"{label} | {site} | {name}"] += 1
    return out


def report(cell, seed: int, dev, out: Path | None = None) -> dict:
    entry = cell.entry.Entry(cell.cfg, cell.mix, seed, dev)
    entry.setup()
    tr = cell.mix.get("trace", {})
    first = tr.get("skip", 2)
    ks = range(first, first + tr.get("count", 4))
    plain = [_timed(entry, ks, dev)]
    works, path = _profiled(entry, ks, dev)
    plain.append(_timed(entry, ks, dev))
    try:
        st = spans.SpanTrace(path)
        base = trace_mod.Trace(path, trace_mod.port_kernels(
            ROOT / "end2end_tpu_torch" / "csrc"))
        if out is not None:
            out.mkdir(parents=True, exist_ok=True)
            with open(path, "rb") as src, gzip.open(
                    out / f"{cell.name}.trace.json.gz", "wb") as dst:
                shutil.copyfileobj(src, dst)
    finally:
        os.remove(path)
    run = harness.Run(cell.entry.KIND, works=works, slice_works=works,
                      trace=base)
    steps = len(works)
    audio_s = sum(w["audio_s"] for w in works)
    device = st.device_s()
    idle = st.idle_s()
    total = sum(device.values())
    # the idle stretches that `trace.Trace` labels train.backward
    backward_gaps = st.idle_s(lambda g: base._label(g[0]) == "train.backward")
    result = {
        "cell": cell.name, "seed": seed, "steps": steps, "audio_s": audio_s,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "plain_s": plain, "traced_window_s": st.window_s,
        "tracing_cost": st.window_s / min(plain) - 1.0,
        "spans_a_step": {n: c / steps for n, c in sorted(st.counts.items())},
        "device_s": _sorted(device), "device_total_s": total,
        "unattributed_share": device.get(None, 0.0) / total if total else 0,
        "idle_s": _sorted(idle), "idle_total_s": sum(idle.values()),
        "backward_gap_idle_s": _sorted(backward_gaps),
        "syncs": dict(Counter(f"{lb} | {n}"
                              for lb, n, _, _ in st.sync_labels())),
        "readings": spans.readings(st, run, cell.cfg["model"]),
        "metrics": {m["name"]: harness.reader(ROOT, m["name"])(run)
                    for m in cell.per_layer},
    }
    _, spath = _profiled(entry, ks, dev, stack=True)
    try:
        result["sync_sites"] = dict(sync_sites(spath))
    finally:
        os.remove(spath)
    entry.free()
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{cell.name}.json").write_text(json.dumps(result, indent=1))
    return result


def _sorted(c: Counter) -> dict:
    return {str(k): v for k, v in sorted(c.items(), key=lambda kv: -kv[1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    from e2e_bench.run import _caches

    _caches()
    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("span_report: needs a CUDA device", file=sys.stderr)
        return 2
    harness.apply_precision(cell.cfg)
    res = report(cell, args.seed, torch.device("cuda:0"), args.out)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
