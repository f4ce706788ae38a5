"""benchmark/spans.py on hand-built spans and (start_ns, end_ns, name,
thread) host events: the anchors' clock offset, launches put down to the
innermost span on their own thread, self time, the tails' busy overlap,
the idle gaps' labels, each new reader on a run it can read and on one it
cannot (None, never 0), and the kept session found from its summary in a
real CPU profiler session."""

import threading

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, spans
from benchmark.trace import Slice
from isvins_tpu_torch.utils import perf
from isvins_tpu_torch.utils.perf import Span

NEW = ("sys_frame_ms_p50", "sys_self_ms_p50", "tail_pg_busy_pct", "tail_marg_busy_pct",
       "trk_launches_per_frame", "est_launches_per_frame", "pg_launches_per_keyframe")
OFF = 1_792_299_000_000_000_000  # kineto's clock less perf_counter's
MAIN, PG, MARG = 118, 133, 140  # native thread ids
PG_IDENT = 0x7F5A_4EDF_F6C0  # the worker's get_ident(); the profiler keeps its low 32 bits
MARG_IDENT = 0x7F5A_99FF_F6C0  # bit 31 set: the profiler's signed 32 bits read negative
MS = 1_000_000


def _run():
    """Two frames on the frame thread (ms on perf's clock), the pose-graph
    worker's push handed from frame 1's feed, a marginalization job handed
    from frame 0's marginalize, and two poses out."""
    S = Span
    return [
        S(1, "sys.frame", 0, MAIN, 0, 100 * MS, None),
        S(2, "trk.dispatch", 0, MAIN, 10 * MS, 30 * MS, 1),
        S(3, "est.process_image", None, MAIN, 40 * MS, 90 * MS, 1),
        S(4, "est.solve_device", None, MAIN, 50 * MS, 70 * MS, 3),
        S(5, "est.marginalize", None, MAIN, 75 * MS, 80 * MS, 3),
        S(6, "est.marg_job", None, MARG, 78 * MS, 150 * MS, 5),
        S(7, "sys.frame", 1, MAIN, 100 * MS, 220 * MS, None),
        S(8, "sys.pose_out", 0, MAIN, 110 * MS, 110 * MS, 7),
        S(9, "sys.feed_pose_graph", 0, MAIN, 150 * MS, 160 * MS, 7),
        S(10, "pg.push", 0, PG, 160 * MS, 260 * MS, 9),
        S(11, "pg.kf_device_step", 0, PG, 170 * MS, 200 * MS, 10),
        S(12, "sys.frame", 2, MAIN, 220 * MS, 300 * MS, None),
        S(13, "sys.pose_out", 1, MAIN, 230 * MS, 230 * MS, 12),
    ]


def _launch(t_ms, thread):
    return (OFF + int(t_ms * MS), OFF + int(t_ms * MS) + 5000, "cudaLaunchKernel", thread)


def _anchor(t_ms, late_ns=0):
    stamp = int(t_ms * MS)
    return (OFF + stamp + late_ns, OFF + stamp + late_ns + 13000, f"{perf.ANCHOR}{stamp}", MAIN)


def _host():
    return [
        _anchor(0, late_ns=250_000), _anchor(100, 3000), _anchor(220, 5000),
        _launch(15, MAIN), _launch(20, MAIN),                    # trk.dispatch
        _launch(55, MAIN), _launch(60, MAIN), _launch(76, MAIN),  # est.solve_device, est.marginalize
        _launch(35, MAIN),                                        # sys.frame's own time
        _launch(180, PG_IDENT & 0xFFFFFFFF),                      # pg.kf_device_step on the worker
        _launch(240, PG_IDENT & 0xFFFFFFFF),                      # pg.push on the worker
        _launch(265, PG_IDENT & 0xFFFFFFFF),                      # the worker, no span open
        _launch(100, (MARG_IDENT & 0xFFFFFFFF) - (1 << 32)),      # est.marg_job on its worker
        _launch(100.5, 999),                                      # a thread no span names
    ]


def _ctx(excluded=None, frames=2):
    return {"spans": _run(), "span_threads": {MAIN: 140040058364672, PG: PG_IDENT, MARG: MARG_IDENT},
            "excluded": excluded or {},
            "trace": {"frames": frames, "session": 1, "host_events": _host(),
                      "device_intervals": [(OFF + 12 * MS, OFF + 13 * MS),
                                           (OFF + 70 * MS, OFF + 71 * MS),
                                           (OFF + 181 * MS, OFF + 182 * MS)]},
            "samples": {"sys.frame": [0.1, 0.12, 0.08]}, "phases": {}}


def test_anchor_offset_is_recovered():
    off, spread = spans.clock_offset(_host())
    assert off == OFF + 5000  # the median; the first anchor opened late
    assert spread == 250_000 - 3000  # statistics.quantiles' quartiles of three
    assert spans.clock_offset([_launch(1, MAIN)]) is None


def test_launches_go_to_the_innermost_span_on_their_own_thread():
    ctx = _ctx()
    n = spans.launch_layers(_host(), _run(), OFF + 5000, ctx["span_threads"])
    assert n == {"trk": 2, "est": 3, "worker": 3, "pg": 2, "unattributed": 3}
    assert sum(n[k] for k in spans.LAYERS) == sum(
        1 for e in _host() if e[2].startswith(spans.LAUNCH_CALLS))
    tl = spans.Timeline(_run())
    assert tl.innermost(MAIN, 60 * MS).name == "est.solve_device"
    assert tl.innermost(MAIN, 72 * MS).name == "est.process_image"
    assert tl.innermost(MAIN, 95 * MS).name == "sys.frame"
    assert tl.innermost(PG, 150 * MS) is None and tl.innermost(PG, 199 * MS).name == "pg.kf_device_step"
    assert tl.root(tl.by_id[10]).name == "sys.frame" and tl.root(tl.by_id[11], True).name == "pg.push"


def test_self_time_and_tail_overlap_on_a_hand_built_run():
    run = _run()
    root, kids = run[0], [run[1], run[2], run[5]]
    assert spans.self_time(root, kids[:2]) == (100 - 20 - 50) * MS
    assert spans.self_time(root, [run[2], run[3]]) == (100 - 50) * MS  # nested: the union
    merged = spans.union([(0, 10), (5, 20), (30, 40)])
    assert merged == [[0, 20], [30, 40]]
    assert spans.overlap(merged, 15, 35) == 5 + 5
    ctx = _ctx()
    # self times: 100 - 20 - 50, 120 - 10 (an instant takes none), 80 ms
    assert spans.self_ms_p50(ctx) == pytest.approx(80.0)
    # latency: frame 0 from 0 to 220 ms (its pose comes out in call 1), frame 1
    # from 100 to 300 ms; the p90 of (220, 200) ms keeps frame 0 alone
    assert spans.tail_busy_pct(ctx, "pg.push") == pytest.approx(100 * 60 / 220)
    assert spans.tail_busy_pct(ctx, "est.marg_job") == pytest.approx(100 * 72 / 220)
    # frame 0's root under a profiler session: only frame 1 is left, [100, 300] ms
    skip = _ctx(excluded={"sys.frame": [(0, 1)]})
    assert spans.tail_busy_pct(skip, "pg.push") == pytest.approx(100 * 100 / 200)
    assert spans.tail_busy_pct(ctx, "no.such_span") is None


def test_idle_gaps_are_labelled_with_each_threads_innermost_span():
    labels = spans.idle_by_span(_ctx())
    assert [round(g, 6) for g, _ in labels] == [0.11, 0.057]
    # 126 ms: frame 1's own time, the marginalization job; 41.5 ms: frame 0's estimator
    assert labels[0][1] == {"sys.frame": "sys.frame", "est.marg_job": "est.marg_job"}
    assert labels[1][1] == {"sys.frame": "est.process_image"}


def test_new_readers_on_a_hand_built_run():
    ctx = _ctx(excluded={"sys.frame": [(2, 3)]})
    # the third frame was under a profiler session: medians of the first two
    want = {"sys_frame_ms_p50": 110.0, "sys_self_ms_p50": (30.0 + 110.0) / 2,
            "tail_pg_busy_pct": 100 * 60 / 220, "tail_marg_busy_pct": 100 * 72 / 220,
            "trk_launches_per_frame": 1.0, "est_launches_per_frame": 1.5}
    for name, v in want.items():
        assert harness.load_reader(name)(ctx) == pytest.approx(v), name
    # the kept session's frames are the third (excluded range (2, 3)): 220-300 ms;
    # the push (160-260 ms, a keyframe: it holds pg.kf_device_step) lies 40 % inside it
    assert harness.load_reader("pg_launches_per_keyframe")(ctx) == pytest.approx(2 / 0.4)


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_none_where_there_is_nothing(name):
    perf.enable(False)
    perf.reset()
    read = harness.load_reader(name)
    assert read({"samples": {}, "phases": {}, "trace": None, "excluded": {}}) is None
    assert read({"samples": {}, "phases": {}, "spans": [], "trace": {"frames": 2, "session": 1,
                "host_events": [], "device_intervals": []}, "excluded": {}}) is None
    bare = _ctx()
    bare["trace"]["host_events"] = [e for e in _host() if not e[2].startswith(perf.ANCHOR)]
    if "launches" in name:  # no anchor: the clocks cannot be joined
        assert read(bare) is None


def test_the_kept_session_is_read_from_a_live_slice():
    """A CPU profiler session over root spans: the anchors it recorded give
    back perf's clock, and session_events finds the Slice from its kept
    summary."""
    perf.reset()
    perf.enable(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for k in range(5):
                with perf.phase("sys.frame", frame=k):
                    with perf.phase("trk.dispatch"):
                        pass
    finally:
        perf.enable(False)
    sl = Slice("cpu", 0, 5, 1)
    sl.done = [(prof, 1.0, {}, 5)]
    sl.summary = {"session": 1, "frames": 5, "launches": 0}
    ctx = {"trace": sl.summary, "samples": {}, "phases": {}, "excluded": {}}
    host, dev = spans.session_events(ctx)
    assert len(host) == 5 and dev == []
    off, spread = spans.clock_offset(host)
    assert spread < 1e6  # the anchors agree to under a millisecond on this host
    assert spans.window_spans(ctx)[-1].name == "sys.frame"
    assert spans.span_threads(ctx)[threading.get_native_id()] == threading.get_ident()
    n = spans.launches(ctx)
    assert n["frames"] == 5 and sum(n[k] for k in spans.LAYERS) == 0
    perf.reset()
    del sl
    assert spans.session_events({"trace": {"session": 1, "frames": 1}}) is None
