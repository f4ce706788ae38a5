"""sys_frame_ms_p50: the median of utils.perf's `sys.frame` samples (the
root span of each System.pub_image call) over the window (host clock, ms)."""

from .common import phase_median_ms


def read(ctx):
    return phase_median_ms(ctx, "sys.frame")
