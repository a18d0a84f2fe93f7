"""Tracing, build logging and throughput (torch port of
`end2end_tpu/utils/profiling.py`).

  * `trace(logdir)`: everything in the block under `torch.profiler`, host
    activity always and the card's kernels whenever CUDA is available,
    written into `logdir` as a Chrome trace (`*.pt.trace.json`), the
    format TensorBoard's profiler plugin reads.
  * `log_compiles()`: the port compiles no XLA programs; what it builds
    at run time are its libraries, the CUDA kernels (`utils/cuda_build.py`,
    nvcc) and the C++ host runtime (`utils/native.py`, g++).  Inside the
    block each of those builds, or each reuse of a library already built,
    is logged with its seconds and the library's file name.
  * `Throughput`: a steady-state throughput meter (wall time, iterations/s
    and units/s).
  * `span(name)`: a `torch.profiler.record_function` range around a block
    while a profiler records, and a shared null context otherwise (one
    flag check).  The port marks its layer boundaries with it: the
    pipelines' and the transducer's entry points, the frontend, the
    encoder with its subsampler and block loop, the losses, the GRU
    predictor's loop, the joint and the decoders.  A span sits around a
    whole loop, never inside one, and never in a backward: the profiler
    stamps each backward node with the sequence number of the forward op
    that made it, which ties the node to that op's span.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger("end2end_tpu_torch")

_LOG_BUILDS: list[bool] = []  # the `enabled` of each open log_compiles
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` around the block while a profiler
    records (its times share the device trace's clock); else a shared
    null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything in the block into `logdir` (TensorBoard format)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
        if cuda:  # the block's kernels end inside the trace
            torch.cuda.synchronize()
    logger.info("profiler trace written to %s", logdir)


@contextlib.contextmanager
def log_compiles(enabled: bool = True):
    """Log every build of the port's libraries inside the block."""
    _LOG_BUILDS.append(bool(enabled))
    try:
        yield
    finally:
        _LOG_BUILDS.pop()


def build_done(library: str, seconds: float, cached: bool) -> None:
    """Report a library's build (or, `cached`, its reuse from the build
    directory); the build functions call it, and it logs inside an
    enabled `log_compiles` block."""
    if _LOG_BUILDS and _LOG_BUILDS[-1]:
        logger.warning("%s %s in %.3f s",
                       "found in the cache:" if cached else "built",
                       os.path.basename(library), seconds)


class Throughput:
    """Steady-state throughput meter.

    >>> meter = Throughput(units_per_iter=B * T)
    >>> for _ in range(iters):
    ...     out = step(...)
    >>> torch.cuda.synchronize(); print(meter.stop(iters))
    """

    def __init__(self, units_per_iter: float = 1.0):
        self.units_per_iter = units_per_iter
        self.t0 = time.perf_counter()

    def stop(self, iters: int):
        dt = time.perf_counter() - self.t0
        return {
            "seconds": dt,
            "iters_per_s": iters / dt,
            "units_per_s": iters * self.units_per_iter / dt,
        }
