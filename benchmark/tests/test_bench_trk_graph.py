"""benchmark/metrics/trk_graph_replay_pct.py on hand-built span records:
the share of `trk.dispatch` spans that enclose a `trk.replay` span, and
None (never 0) where the program records no step span at all."""

import pytest

from benchmark.metrics import trk_graph_replay_pct
from isvins_tpu_torch.utils.perf import Span

MAIN, PG = 118, 133  # native thread ids
MS = 1_000_000


def _frame(i, step, first_id):
    """Frame i's sys.frame root with one trk.dispatch and, inside it, a
    `step` span (or none); ids from first_id."""
    t = 100 * MS * i
    out = [Span(first_id, "sys.frame", i, MAIN, t, t + 90 * MS, None),
           Span(first_id + 1, "trk.dispatch", i, MAIN, t + 1 * MS, t + 9 * MS, first_id)]
    if step is not None:
        out.append(Span(first_id + 2, step, i, MAIN, t + 2 * MS, t + 8 * MS, first_id + 1))
    return out


def _run(steps):
    return [s for i, st in enumerate(steps) for s in _frame(i, st, 10 * i + 1)]


@pytest.mark.parametrize("steps,want", [
    (["trk.step_eager", "trk.step_eager", "trk.replay", "trk.replay"], 50.0),
    (["trk.replay"] * 5, 100.0),
    (["trk.step_eager"] * 3, 0.0),
    (["trk.step_eager", "trk.replay", "trk.replay"], 100.0 * 2 / 3),
])
def test_share_of_replayed_dispatches(steps, want):
    assert trk_graph_replay_pct.read({"spans": _run(steps)}) == pytest.approx(want)


def test_a_replay_nested_deeper_counts_once_and_others_do_not():
    """A trk.replay under another span inside trk.dispatch counts for that
    dispatch; one outside every dispatch, or on another thread with no
    dispatch above it, counts for none."""
    recs = _run(["trk.step_eager", None])
    recs += [Span(90, "trk.capture", 1, MAIN, 101 * MS, 108 * MS, 12),
             Span(91, "trk.replay", 1, MAIN, 102 * MS, 107 * MS, 90),
             Span(92, "trk.replay", 1, MAIN, 102 * MS, 107 * MS, 90),
             Span(93, "trk.replay", 1, MAIN, 150 * MS, 151 * MS, 11),
             Span(94, "trk.replay", None, PG, 150 * MS, 151 * MS, None)]
    assert trk_graph_replay_pct.read({"spans": recs}) == pytest.approx(50.0)


@pytest.mark.parametrize("recs", [
    [],  # nothing recorded
    _run([None, None, None]),  # a program without step spans: the parent of the graph
    [Span(1, "trk.replay", 0, MAIN, 0, MS, None)],  # no dispatch to share
])
def test_nothing_to_read_is_none(recs):
    assert trk_graph_replay_pct.read({"spans": recs}) is None
