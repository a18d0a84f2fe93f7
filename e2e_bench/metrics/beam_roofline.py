"""K3 + K4 + the backtrace: their least time on the traced batches' inputs
over their device time, %."""

from e2e_bench import readings

KERNELS = {"topk_select_kernel", "topk_sort_kernel", "topk_rounds_kernel",
           "beam_step_kernel", "backtrace_kernel"}


def read(run):
    return readings.roofline(run, "beam", KERNELS)
