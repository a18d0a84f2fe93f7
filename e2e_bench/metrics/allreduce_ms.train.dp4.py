"""Device ms a second of a step's audio (all ranks') in NCCL's kernels on
rank 0: the gradients' all-reduce, the loss's, and the go broadcast
(traced train steps); None where the trace holds none."""

from e2e_bench import readings


def read(run):
    if run.kind != "train" or run.trace is None or not run.slice_works:
        return None
    t = run.trace.kernel_s(lambda n: n.startswith("nccl"))
    return 1e3 * t / readings.slice_audio_s(run) if t > 0 else None
