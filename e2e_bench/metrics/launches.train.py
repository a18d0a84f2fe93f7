"""Device operations a second of audio (traced train steps)."""

from e2e_bench import readings


def read(run):
    return readings.launches(run, "train")
