"""pg_opt_dispatch_ms_p50: the median of utils.perf's `pg.opt_dispatch` samples over the window (host
clock, ms)."""

from .common import phase_median_ms


def read(ctx):
    return phase_median_ms(ctx, "pg.opt_dispatch")
