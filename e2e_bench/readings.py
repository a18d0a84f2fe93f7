"""Arithmetic the metric readers under `metrics/` share.  Each reader is
`read(run) -> value or None` on a `harness.Run`; None means it found
nothing to read in this run, and the harness leaves the metric out."""

from __future__ import annotations

from e2e_bench import bounds


def window_rate(run, kind: str):
    """Unpadded audio seconds a second over the whole window."""
    if run.kind != kind or not run.works:
        return None
    return sum(w["audio_s"] for w in run.works) / run.window_s


def slice_audio_s(run) -> float:
    return sum(w["audio_s"] for w in run.slice_works)


def mfu(run, kind: str):
    """The traced slice's model operations over its length and the card's
    dense bf16 peak, in %."""
    if run.kind != kind or run.trace is None or not run.slice_works:
        return None
    ops = sum(w["flops"] for w in run.slice_works)
    return 100.0 * ops / run.trace.window_s / bounds.BF16_DENSE_OPS_PER_S


def torch_ops_ms(run, kind: str):
    """Device ms a second of audio in kernels that are not the port's."""
    if run.kind != kind or run.trace is None or not run.slice_works:
        return None
    t = run.trace.kernel_s(lambda n: not run.trace.is_port(n))
    return 1e3 * t / slice_audio_s(run)


def roofline(run, group: str, kernels: set):
    """The group's least time (`bounds`, summed over the traced steps) over
    its kernels' device time, in %."""
    if run.trace is None:
        return None
    least = sum(w["bounds"].get(group, 0.0) for w in run.slice_works)
    took = run.trace.kernel_s(lambda n: n in kernels)
    if least <= 0.0 or took <= 0.0:
        return None
    return 100.0 * least * 1e-3 / took


def launches(run, kind: str):
    """Device operations a second of audio in the traced slice."""
    if run.kind != kind or run.trace is None or not run.slice_works:
        return None
    return run.trace.launches / slice_audio_s(run)


def idle(run, kind: str):
    """The traced window's share with no device operation, in %."""
    if run.kind != kind or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
