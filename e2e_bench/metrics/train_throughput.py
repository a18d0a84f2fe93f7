"""Unpadded audio seconds of the steps completed in the window, over the
window (which ends in a device synchronise)."""

from e2e_bench import readings


def read(run):
    return readings.window_rate(run, "train")
