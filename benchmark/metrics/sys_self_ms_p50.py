"""sys_self_ms_p50: the median over the window's frames of `sys.frame` less
the union of its children on the frame thread: the System's own time in a
pub_image call (host clock, ms; benchmark/spans.py)."""

from .. import spans


def read(ctx):
    return spans.self_ms_p50(ctx)
