"""The traced slice by the port's spans.

`trace.Trace` keeps the slice's device operations and the host ranges by
name alone.  `SpanTrace` reads the same Chrome trace and keeps what ties
the two: for each host thread, the port's spans (the `record_function`
ranges of `end2end_tpu_torch.utils.profiling.span`, names in `PORT`), the
timed entries' own ranges (`HARNESS`) and the autograd engine's backward
nodes; the CUDA runtime calls; and the `correlation` id that ties each
kernel, memcpy and memset to the call that launched it.  From these:

  * a device operation's span: the innermost span open on the launching
    thread when it was launched.  A backward node takes the name
    `<span>.backward` of the forward span that made it: the node and the
    forward op that recorded it carry one sequence number.  On the thread
    that runs the backward, the engine's work between two nodes goes to
    the node that follows.  An operation under no port span goes to the
    innermost harness range open then (on any thread).
  * idle by span: each instant of an idle stretch goes to the innermost
    span open at that instant on the thread that launches the device's
    next operation (the one the device waits for).
  * host syncs by span: the synchronising runtime calls (`SYNCS`) made
    inside a port span.

The port's spans nest on their own thread; where two ranges overlap
without nesting, the inner one is cut at the outer one's end.
"""

from __future__ import annotations

import bisect
import json
from collections import Counter

PORT = frozenset({
    "ctc_pipeline.loss", "ctc_pipeline.decode", "transducer.loss",
    "frontend", "encoder", "encoder.subsample", "encoder.blocks",
    "ctc.loss", "rnnt.predictor", "rnnt.joint", "rnnt.loss", "ctc.greedy",
    "ctc.beam", "ctc.beam.topk", "ctc.beam.step", "ctc.beam.backtrace"})
HARNESS = frozenset({"train.forward", "train.backward", "train.optimizer",
                     "decode.model", "decode.result"})
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})
BACKWARD = ".backward"
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME = ("cuda_runtime", "cuda_driver")
_NODE = "autograd::engine::evaluate_function: "


def is_port(label) -> bool:
    """Whether a label is a port span or a port span's backward."""
    return label is not None and (label in PORT or (
        label.endswith(BACKWARD) and label[:-len(BACKWARD)] in PORT))


def busy(ops, t0: float, t1: float) -> list:
    """The union of the operations' (start, end, ...) intervals inside
    [t0, t1), as sorted [start, end] pairs (as `trace.Trace` merges)."""
    out = []
    for a, b, *_ in sorted(ops):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def gaps(ops, t0: float, t1: float) -> list:
    """The idle stretches (start, end) of [t0, t1)."""
    out, prev = [], t0
    for a, b in busy(ops, t0, t1) + [[t1, t1]]:
        if a > prev:
            out.append((prev, a))
        prev = max(prev, b)
    return out


class Timeline:
    """Which of a set of labelled (start, end, label) ranges is innermost
    at each instant: sorted disjoint segments."""

    def __init__(self, ranges):
        self.segs = []
        stack, t = [], None  # stack: (end, label), ends non-increasing

        def upto(x):
            nonlocal t
            while stack and stack[-1][0] <= x:
                end, label = stack.pop()
                if end > t:
                    self.segs.append((t, end, label))
                    t = end
            if stack and x > t:
                self.segs.append((t, x, stack[-1][1]))
            t = max(t, x)

        for a, b, label in sorted(ranges, key=lambda r: (r[0], -r[1])):
            if t is None:
                t = a
            upto(a)
            if stack:
                b = min(b, stack[-1][0])
            if b > a:
                stack.append((b, label))
        if t is not None:
            upto(float("inf"))
        self.starts = [s[0] for s in self.segs]

    def at(self, t: float):
        """The innermost label open at `t`, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.segs[i][1]:
            return self.segs[i][2]
        return None

    def split(self, a: float, b: float) -> tuple:
        """({label: time} of [a, b), [the uncovered pieces])."""
        out, rest, t = Counter(), [], a
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        while i < len(self.segs) and self.segs[i][0] < b:
            s, e, label = self.segs[i]
            s, e = max(s, a), min(e, b)
            if e > s:
                if s > t:
                    rest.append((t, s))
                out[label] += e - s
                t = e
            i += 1
        if b > t:
            rest.append((t, b))
        return out, rest


def split_idle(gap_list, timeline_for, fallback: Timeline) -> Counter:
    """{label: microseconds} of the idle stretches: `timeline_for(gap)` is the
    timeline of the thread the gap waits for; what it leaves uncovered
    goes to `fallback`, and what that leaves to None."""
    out = Counter()
    for a, b in gap_list:
        parts, rest = timeline_for((a, b)).split(a, b)
        out.update(parts)
        for c, d in rest:
            more, left = fallback.split(c, d)
            out.update(more)
            if left:
                out[None] += sum(e - s for s, e in left)
    return out


def port_idle_share(trace):
    """The share of a `trace.Trace`'s window, in %, that is idle while a
    port span is the innermost range open; None when the trace holds no
    port span.  It reads the ranges of every thread as one, which is the
    launching thread's where one thread launches, as in decoding."""
    if not any(n in PORT for _, _, n in trace.ranges):
        return None
    line = Timeline([r for r in trace.ranges if r[2] in PORT | HARNESS])
    idle = split_idle(gaps(trace.ops, trace.t0, trace.t1),
                      lambda gap: line, Timeline([]))
    port = sum(v for k, v in idle.items() if is_port(k))
    return 100.0 * port / (trace.t1 - trace.t0)


class SpanTrace:
    def __init__(self, path):
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
        s = next((e for e in events if e.get("name") == "e2e.slice"
                  and e.get("cat") == "user_annotation"), None)
        if s is None:
            raise RuntimeError("the trace holds no e2e.slice range")
        self.t0, self.t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        self.ops = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
              e["name"], e.get("args", {}).get("correlation"))
             for e in events if e.get("cat") in _DEVICE
             and self.t0 <= float(e["ts"]) < self.t1), key=lambda o: o[:2])
        self.starts = [o[0] for o in self.ops]
        self.launch = {}   # correlation -> (thread, time)
        self.syncs = []    # (thread, time, name)
        self.counts = Counter()  # port spans opened in the window
        ranges, harness, nodes, fwd = {}, [], {}, {}
        for e in events:
            cat, name = e.get("cat"), e.get("name", "")
            args = e.get("args", {})
            th = (e.get("pid"), e.get("tid"))
            a = float(e["ts"])
            b = a + float(e.get("dur", 0))
            seq = args.get("Sequence number", -1)
            if cat in _RUNTIME:
                if "correlation" in args:
                    self.launch[args["correlation"]] = (th, a)
                if name in SYNCS and self.t0 <= a < self.t1:
                    self.syncs.append((th, a, name))
            elif cat == "user_annotation" and name in PORT:
                ranges.setdefault(th, []).append((a, b, name))
                self.counts[name] += self.t0 <= a < self.t1
            elif cat == "user_annotation" and name in HARNESS:
                harness.append((a, b, name))
            elif cat == "cpu_op" and name.startswith(_NODE):
                nodes.setdefault(th, []).append((a, b, seq))
            elif cat == "cpu_op" and seq >= 0:
                fwd.setdefault(seq, []).append((a, th))
        port = {th: Timeline(r) for th, r in ranges.items()}
        inside = {th: Timeline([(a, b, True) for a, b, _ in r])
                  for th, r in nodes.items()}
        # a backward node's span: that of the last forward op before it
        # with its sequence number (the numbers count on per thread; the
        # benchmark's forwards run on one); ops run inside a node are not
        # forward ops
        made = {seq: sorted((a, th) for a, th in ops
                            if th not in inside or not inside[th].at(a))
                for seq, ops in fwd.items()}
        for th, rows in nodes.items():
            prev = None
            for a, b, seq in sorted(rows):
                # the engine's work between two nodes goes to the next
                start = a if prev is None else min(a, prev)
                prev = b if prev is None else max(b, prev)
                ops = made.get(seq, ())
                i = bisect.bisect_left(ops, (a,)) - 1
                if seq < 0 or i < 0 or ops[i][1] not in port:
                    continue
                label = port[ops[i][1]].at(ops[i][0])
                if label is not None:
                    ranges.setdefault(th, []).append(
                        (start, b, label + BACKWARD))
        self.lines = {th: Timeline(r) for th, r in ranges.items()}
        self.harness = Timeline(harness)
        self._none = Timeline([])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def label(self, thread, t: float):
        """The span of a host instant on a thread: the innermost port span
        (or port span's backward) open there, else the innermost harness
        range open then on any thread, else None."""
        line = self.lines.get(thread)
        label = line.at(t) if line is not None else None
        return label if label is not None else self.harness.at(t)

    def op_labels(self) -> list:
        """Each device operation's span (None where its launch is not in
        the trace or falls under no span)."""
        out = []
        for _, _, _, corr in self.ops:
            where = self.launch.get(corr)
            out.append(None if where is None else self.label(*where))
        return out

    def device_s(self) -> Counter:
        """{span: seconds of its device operations}."""
        out = Counter()
        for (a, b, _, _), label in zip(self.ops, self.op_labels()):
            out[label] += (b - a) * 1e-6
        return out

    def waited_on(self, gap):
        """The timeline of the thread that launches the operation after an
        idle stretch (the last operation's, after the last stretch)."""
        if not self.ops:
            return self._none
        i = min(bisect.bisect_left(self.starts, gap[1]), len(self.ops) - 1)
        where = self.launch.get(self.ops[i][3])
        return self.lines.get(where[0], self._none) if where else self._none

    def idle_s(self, keep=None) -> Counter:
        """{span: idle seconds attributed to it} over the window, or over
        the idle stretches (start, end) that `keep` accepts."""
        stretches = [g for g in gaps(self.ops, self.t0, self.t1)
                     if keep is None or keep(g)]
        idle = split_idle(stretches, self.waited_on, self.harness)
        return Counter({k: v * 1e-6 for k, v in idle.items()})

    def sync_labels(self) -> list:
        """(span, runtime call, thread, time) of each synchronising call
        in the window."""
        return [(self.label(th, t), name, th, t)
                for th, t, name in self.syncs]

    def port_syncs(self) -> Counter:
        """{port span: synchronising calls made inside it}."""
        return Counter(label for label, *_ in self.sync_labels()
                       if is_port(label))


def _syncs(st, run):
    return sum(st.port_syncs().values()) / len(run.slice_works)


def _idle(st, run, names=("rnnt.predictor", "rnnt.predictor" + BACKWARD)):
    idle = st.idle_s()
    return 100.0 * sum(idle[n] for n in names) / st.window_s


def _device_ms(name):
    def read(st, run):
        device = st.device_s()
        audio_s = sum(w["audio_s"] for w in run.slice_works)
        return 1e3 * (device[name] + device[name + BACKWARD]) / audio_s
    return read


# The per-layer metrics that need a SpanTrace of the traced slice, which
# the harness does not keep (it deletes the trace once `trace.Trace` has
# read it): (the run's kind, the model, the reading from the SpanTrace
# and the harness's Run).
READINGS = {
    "host_syncs.train": ("train", "ctc", _syncs),
    "host_syncs.train.transducer": ("train", "transducer", _syncs),
    "host_syncs.decode": ("decode", "ctc", _syncs),
    "idle.predictor.train.transducer": ("train", "transducer", _idle),
    "joint_ms.train.transducer": ("train", "transducer",
                                  _device_ms("rnnt.joint")),
    "subsample_ms.train": ("train", "ctc", _device_ms("encoder.subsample")),
    "subsample_ms.decode": ("decode", "ctc",
                            _device_ms("encoder.subsample")),
}


def readings(st: SpanTrace, run, model: str) -> dict:
    """{metric: reading} of the READINGS for the run's kind and model."""
    if not run.slice_works:
        return {}
    return {name: fn(st, run) for name, (kind, m, fn) in READINGS.items()
            if kind == run.kind and m == model}
