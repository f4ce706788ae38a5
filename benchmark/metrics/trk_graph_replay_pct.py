"""trk_graph_replay_pct: 100 x the window's `trk.dispatch` spans that
enclose a `trk.replay` span (the tracker's steady step replayed as one CUDA
graph), over all of the window's `trk.dispatch` spans (program_span;
benchmark/spans.py). None where the program records neither `trk.replay`
nor `trk.step_eager` spans: a program that does not say how it stepped."""

from .. import spans

DISPATCH, REPLAY, EAGER = "trk.dispatch", "trk.replay", "trk.step_eager"


def read(ctx):
    recs = spans.window_spans(ctx)
    if not recs or not any(s.name in (REPLAY, EAGER) for s in recs):
        return None
    by_id = {s.id: s for s in recs}
    dispatch = {s.id for s in recs if s.name == DISPATCH}
    replayed = set()
    for s in recs:
        if s.name != REPLAY:
            continue
        up = by_id.get(s.parent)
        while up is not None and up.id not in dispatch:
            up = by_id.get(up.parent)
        if up is not None:
            replayed.add(up.id)
    return 100.0 * len(replayed) / len(dispatch) if dispatch else None
