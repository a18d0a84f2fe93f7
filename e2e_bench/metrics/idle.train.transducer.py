"""As `idle.train`, in the transducer's training cells, where it moves
`train_throughput.transducer`."""

from e2e_bench import readings


def read(run):
    return readings.idle(run, "train")
