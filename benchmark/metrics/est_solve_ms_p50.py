"""est_solve_ms_p50: the median of utils.perf's `est.solve_device` samples over the window (host
clock, ms)."""

from .common import phase_median_ms


def read(ctx):
    return phase_median_ms(ctx, "est.solve_device")
