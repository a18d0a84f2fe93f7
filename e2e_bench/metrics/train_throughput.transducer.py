"""Unpadded audio seconds of the steps completed in the window, over the
window (which ends in a device synchronise).  The transducer's training
cells report it in place of `train_throughput`, so that each model's
bound is set from its own spread."""

from e2e_bench import readings


def read(run):
    return readings.window_rate(run, "train")
