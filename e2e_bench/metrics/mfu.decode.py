"""Model operations of the traced decode steps over their time and the card's dense bf16 peak, %."""

from e2e_bench import readings


def read(run):
    return readings.mfu(run, "decode")
