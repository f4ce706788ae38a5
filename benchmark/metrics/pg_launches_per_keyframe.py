"""pg_launches_per_keyframe: the traced slice's kernel-launch calls whose
innermost span on the pose-graph worker is a `pg.*` span, over the slice's
keyframes: the `pg.push` spans that made one, each counted by its share
inside the slice (benchmark/spans.py)."""

from .. import spans


def read(ctx):
    return spans.pg_launches_per_keyframe(ctx)
