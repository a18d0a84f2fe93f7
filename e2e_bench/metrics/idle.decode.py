"""Share of the traced decode window with no device operation, %."""

from e2e_bench import readings


def read(run):
    return readings.idle(run, "decode")
