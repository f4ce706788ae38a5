"""k1_proj_rows_roofline (%): K1's bound over the window's N projection
rows (common.kernel_work "proj_rows") over its mean device time per launch
in the traced slice."""

from .common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "proj_rows", ("proj_rows_kernel",), "proj_rows_kernel")
