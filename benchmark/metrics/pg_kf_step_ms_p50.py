"""pg_kf_step_ms_p50: the median of utils.perf's `pg.kf_device_step` samples over the window (host
clock, ms)."""

from .common import phase_median_ms


def read(ctx):
    return phase_median_ms(ctx, "pg.kf_device_step")
