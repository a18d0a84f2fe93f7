"""The general harness: it finds a cell's files by the names in
`BENCHMARK.json`, runs the cell's entry through set-up, the measured
window and the check, and reduces what it recorded to the cell's metrics.

Everything that belongs to one configuration, mix, entry or metric is a
file of its own, found by name:

  configuration   configs/<config>.json     (BENCHMARK.json names the file)
  traffic mix     traffic/<traffic>.json    (names its entry)
  timed entry     entries/<entry>.py        (class Entry)
  limits          limits/<cell>.json        (the check's numbers' limits)
  metric          metrics/<metric>.py       (read(run) -> value or None)

so that a new cell, mix, entry or metric is new files and new entries in
`BENCHMARK.json`, and no edit.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from e2e_bench import programs
from e2e_bench import trace as trace_mod


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    entry: object  # the entry module
    end_to_end: list
    per_layer: list


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, workload: str) -> Cell:
    """The cell `workload` of `root/BENCHMARK.json`, with its files."""
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    w = cells[workload]
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    base = root / "e2e_bench"
    mix = _json(base / "traffic" / f"{w['traffic']}.json")
    entry = _load_module(base / "entries" / f"{mix['entry']}.py",
                         f"e2e_bench_entry_{mix['entry']}")

    def listed(metric):
        return workload in metric.get("workloads", [workload])

    return Cell(workload, w["chips"], _json(root / cfg_file), mix,
                _json(base / "limits" / f"{workload}.json"), entry,
                [m for m in bench["end_to_end"] if listed(m)],
                [m for m in bench["per_layer"] if listed(m)])


def apply_precision(cfg: dict) -> None:
    """Set the switches the configuration's precision states, as
    "torch.backends.<...>": value."""
    for key, value in cfg["precision"].items():
        if key.startswith("torch.backends."):
            obj = torch
            *path, last = key.split(".")[1:]
            for name in path:
                obj = getattr(obj, name)
            setattr(obj, last, value)


def reader(root: Path, metric: str):
    return _load_module(Path(root) / "e2e_bench" / "metrics" / f"{metric}.py",
                        "e2e_bench_metric_" + metric.replace(".", "_")
                        .replace("-", "_")).read


@dataclass
class Run:
    """What a metric's reader reads."""
    kind: str
    setup_s: float = 0.0
    window_s: float = 0.0
    works: list = field(default_factory=list)        # one dict a step
    slice_works: list = field(default_factory=list)  # the traced steps'
    trace: object = None                             # a trace.Trace


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Profiled:
    """torch.profiler over the traced slice, in `e2e.slice`, ended by a
    device synchronise; the trace goes to a temporary file."""

    def __init__(self, dev):
        self.dev = dev
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.rf = torch.profiler.record_function("e2e.slice")

    def __enter__(self):
        _sync(self.dev)
        self.prof.__enter__()
        self.rf.__enter__()
        return self

    def stop(self):
        _sync(self.dev)
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        return self

    def export(self) -> str:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(path)
        return path


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, root: Path) -> dict:
    """Set-up, window and check of one run.  Returns the result: metrics,
    correct, attempted, failed, the device's readings, the breakdown when
    traced, and the numbers checked with their limits."""
    dev = torch.device(device)
    entry = cell.entry.Entry(cell.cfg, cell.mix, seed, dev)
    with programs.builds() as built:
        entry.setup()
    _sync(dev)
    run = Run(cell.entry.KIND)
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    deadline = t0 + seconds
    tr = cell.mix.get("trace", {})
    first, last = tr.get("skip", 2), tr.get("skip", 2) + tr.get("count", 4)
    prof, done, k = None, None, 0
    while time.perf_counter() < deadline:
        if traced and k == first:
            prof = _Profiled(dev).__enter__()
        work = entry.step(k)
        run.works.append(work)
        k += 1
        if prof is not None:
            run.slice_works.append(work)
            if k == last:
                done, prof = prof.stop(), None
    if prof is not None:
        done = prof.stop()
    _sync(dev)
    run.window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    failed = entry.failures(run.works)
    attempted = sum(len(w.get("latencies_s", [None])) for w in run.works)
    if done is not None:
        trace_path = done.export()
        try:
            run.trace = trace_mod.Trace(trace_path, trace_mod.port_kernels(
                root / "end2end_tpu_torch" / "csrc"))
        finally:
            os.remove(trace_path)
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    entry.free()
    t_check = time.perf_counter()
    numbers = entry.check()
    check_s = time.perf_counter() - t_check
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items()}
    correct = (failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(10),
                            "idle_gaps": run.trace.idle_gaps(10)}
    out["notes"] = {**_notes(run), "build_s": sum(built),
                    "check_s": check_s, **getattr(entry, "check_notes", {})}
    out["checks"] = checks
    return out


def _notes(run: Run) -> dict:
    """Counts printed beside the result (not metrics)."""
    lat = sorted(x for w in run.works for x in w.get("latencies_s", []))
    notes = {"steps": len(run.works), "window_s": run.window_s,
             "setup_s": run.setup_s,
             "audio_s": sum(w["audio_s"] for w in run.works)}
    if any("tokens" in w for w in run.works):
        notes["tokens_per_audio_s"] = (sum(w.get("tokens", 0)
                                           for w in run.works)
                                       / notes["audio_s"])
    if lat:
        notes["latency_median_ms"] = 1e3 * lat[len(lat) // 2]
        notes["requests"] = len(lat)
    return notes
