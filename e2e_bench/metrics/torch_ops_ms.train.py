"""Device ms in kernels not the port's own, a second of audio (traced train steps)."""

from e2e_bench import readings


def read(run):
    return readings.torch_ops_ms(run, "train")
