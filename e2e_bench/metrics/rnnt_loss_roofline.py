"""K8 + K9 (with their skew pass): their least time on the traced steps'
inputs over their device time, %."""

from e2e_bench import readings

KERNELS = {"rnnt_skew_kernel", "rnnt_alpha_kernel", "rnnt_beta_kernel",
           "rnnt_post_kernel", "rnnt_alpha_rows_kernel",
           "rnnt_post_rows_kernel"}


def read(run):
    return readings.roofline(run, "rnnt_loss", KERNELS)
