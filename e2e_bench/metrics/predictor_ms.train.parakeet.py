"""Device ms a second of audio in cuDNN's LSTM, the transducer's LSTM
predictor forward and backward (traced train steps).  cuDNN runs a
sequence as per-step cell kernels (`CELLS`, their base names as the H100's
trace shows them under `rnnt.predictor` and its backward) interleaved
with generic GEMM kernels; a run of cell kernels no more than `BETWEEN`
kernels apart is one sequence, and every kernel from its first cell
kernel to its last is counted.  The sequence-wide GEMMs before the first
cell (the input projection) and after the last (the weight gradients) are
not: a floor.  None where the trace holds no cell kernel."""

from e2e_bench import readings
from e2e_bench.trace import base_name

CELLS = {"elemWiseRNNcell", "LSTM_elementWise_bp1",
         "GENERIC_elementWise_bp2"}
BETWEEN = 4


def read(run):
    if run.kind != "train" or run.trace is None or not run.slice_works:
        return None
    kernels = [(a, b, base_name(n) in CELLS)
               for a, b, n, c in run.trace.ops if c == "kernel"]
    cells = [i for i, (_, _, cell) in enumerate(kernels) if cell]
    if not cells:
        return None
    total, first = 0.0, cells[0]
    for prev, i in zip(cells, cells[1:] + [None]):
        if i is None or i - prev > BETWEEN:
            total += sum(b - a for a, b, _ in kernels[first:prev + 1])
            first = i
    return 1e3 * total * 1e-6 / readings.slice_audio_s(run)
