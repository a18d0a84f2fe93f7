"""Reduction of a torch.profiler trace of the traced slice.

The slice runs inside `record_function("e2e.slice")`, which ends after a
device synchronise; its span is the traced window.  Device operations are
the trace's kernels, memcpys and memsets; the port's kernels are those
whose name is a `__global__` function of `end2end_tpu_torch/csrc/*.cu`.
An idle gap is a stretch of the window with no device operation, labelled
by the innermost `record_function` range the harness had open on the host
when it began.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
    r"(\w+)\s*\(")


def port_kernels(csrc: Path) -> set:
    """Names of the port's CUDA kernels."""
    names = set()
    for src in sorted(Path(csrc).glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return names


def base_name(name: str) -> str:
    """A demangled kernel name's function name, without namespaces,
    template arguments or parameters."""
    head = re.split(r"[<(]", name.replace("(anonymous namespace)::", ""),
                    maxsplit=1)[0].split()
    return head[-1].split("::")[-1] if head else name


class Trace:
    def __init__(self, path, port: set):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = [e for e in events if e.get("ph") == "X"]
        slices = [e for e in spans if e.get("name") == "e2e.slice"
                  and e.get("cat") == "user_annotation"]
        if not slices:
            raise RuntimeError("the trace holds no e2e.slice range")
        s = slices[0]
        self.t0, self.t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        self.ops = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
             e["name"], e.get("cat"))
            for e in spans if e.get("cat") in _DEVICE
            and self.t0 <= float(e["ts"]) < self.t1)
        self.ranges = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in spans if e.get("cat") == "user_annotation"
            and e["name"] != "e2e.slice")
        self.port = port

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy(self):
        out = []
        for a, b, _, _ in self.ops:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) * 1e-6

    def kernel_s(self, which) -> float:
        """Seconds of the kernels whose base name `which` accepts."""
        return sum(b - a for a, b, n, c in self.ops
                   if c == "kernel" and which(base_name(n))) * 1e-6

    def is_port(self, name: str) -> bool:
        return name in self.port

    @property
    def launches(self) -> int:
        return len(self.ops)

    def top_ops(self, k: int = 10) -> list:
        total = {}
        for a, b, n, _ in self.ops:
            total[n] = total.get(n, 0.0) + (b - a) * 1e-6
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], s] for n, s in top]

    def idle_gaps(self, k: int = 10) -> list:
        gaps, prev = [], self.t0
        for a, b in self._busy() + [[self.t1, self.t1]]:
            if a > prev:
                gaps.append((a - prev, prev))
            prev = max(prev, b)
        gaps.sort(reverse=True)
        return [[self._label(t), g * 1e-6] for g, t in gaps[:k]]

    def _label(self, t: float) -> str:
        inner = [(b - a, n) for a, b, n in self.ranges if a <= t < b]
        return min(inner)[1] if inner else "e2e.slice"
