"""Unpadded audio seconds transcribed in the window, over the window
(RTFx)."""

from e2e_bench import readings


def read(run):
    return readings.window_rate(run, "decode")
