"""tail_pg_busy_pct: over the frames whose in-program latency is at or
above its p90, the share of their latency intervals during which the
pose-graph worker was inside a `pg.push` span (%; benchmark/spans.py)."""

from .. import spans


def read(ctx):
    return spans.tail_busy_pct(ctx, "pg.push")
