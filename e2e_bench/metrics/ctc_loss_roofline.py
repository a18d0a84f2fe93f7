"""K1 + K2 + the gradient's combine: their least time on the traced steps'
inputs over their device time, %."""

from e2e_bench import readings

KERNELS = {"ctc_alpha_kernel", "ctc_beta_kernel", "ctc_grad_kernel"}


def read(run):
    return readings.roofline(run, "ctc_loss", KERNELS)
