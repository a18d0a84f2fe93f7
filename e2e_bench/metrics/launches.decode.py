"""Device operations a second of audio (traced decode steps)."""

from e2e_bench import readings


def read(run):
    return readings.launches(run, "decode")
