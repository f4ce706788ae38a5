"""k4_linstep_roofline (%): K4's bound at the configuration's window
shapes (common.kernel_work "linstep") over its mean device time per call
in the traced slice; a call is its first launch (schur_corr_kernel), the
blocked Cholesky (linstep_chol_kernel) and the landmark back-substitution
(linstep_dl_kernel), counted by linstep_chol_kernel."""

from .common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "linstep",
                        ("schur_corr_kernel", "linstep_chol_kernel", "linstep_dl_kernel"),
                        "linstep_chol_kernel")
