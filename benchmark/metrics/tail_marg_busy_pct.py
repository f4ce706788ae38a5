"""tail_marg_busy_pct: over the frames whose in-program latency is at or
above its p90, the share of their latency intervals during which the
marginalization worker was inside an `est.marg_job` span (%;
benchmark/spans.py)."""

from .. import spans


def read(ctx):
    return spans.tail_busy_pct(ctx, "est.marg_job")
