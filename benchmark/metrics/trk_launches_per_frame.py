"""trk_launches_per_frame: the traced slice's kernel-launch calls whose
innermost span on their own thread is a `trk.*` span, over the slice's
frames (benchmark/spans.py)."""

from .. import spans


def read(ctx):
    return spans.launches_per_frame(ctx, "trk")
