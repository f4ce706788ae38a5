"""utils.perf, the port's span recorder, on the CPU: nesting gives parents
and frames, a span handed to another thread is that thread's parent, the
phase samples hold the spans' durations under the same names, each root
span emits one clock anchor into a profiler session, and with perf off
nothing is recorded and no anchor is emitted."""

import threading

import pytest
from torch.profiler import ProfilerActivity, profile

from isvins_tpu_torch.utils import perf


@pytest.fixture(autouse=True)
def _clean():
    perf.enable(False)
    perf.reset()
    yield
    perf.enable(False)
    perf.reset()


def _by_name(spans):
    return {s.name: s for s in spans}


def test_nesting_gives_parents_and_frames():
    perf.enable(True)
    with perf.phase("sys.frame", frame=3) as root:
        assert perf.current() is root
        with perf.phase("trk.dispatch", frame=4) as child:
            with perf.phase("trk.inner"):
                perf.event("sys.pose_out")
        perf.event("sys.pose_out2", frame=1)
    perf.add("ext", 0.25)
    assert perf.current() is None
    s = _by_name(perf.spans())
    me = threading.get_native_id()
    assert s["sys.frame"].parent is None and s["sys.frame"].frame == 3
    assert s["sys.frame"].id == root.id and s["trk.dispatch"].id == child.id
    assert s["trk.dispatch"].parent == root.id and s["trk.dispatch"].frame == 4
    assert s["trk.inner"].parent == child.id and s["trk.inner"].frame == 4
    assert s["sys.pose_out"].parent == s["trk.inner"].id and s["sys.pose_out"].frame == 4
    assert s["sys.pose_out"].start_ns == s["sys.pose_out"].end_ns
    assert s["sys.pose_out2"].parent == root.id and s["sys.pose_out2"].frame == 1
    assert s["ext"].parent is None and s["ext"].end_ns - s["ext"].start_ns == 250_000_000
    assert {x.thread for x in s.values()} == {me}
    outer, inner = s["sys.frame"], s["trk.inner"]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    # records in the order they ended
    assert [x.name for x in perf.spans()] == ["sys.pose_out", "trk.inner", "trk.dispatch",
                                              "sys.pose_out2", "sys.frame", "ext"]


def test_a_handed_span_is_the_parent_on_another_thread():
    perf.enable(True)
    seen = {}

    def job(parent):
        seen["thread"] = threading.get_native_id()
        seen["ident"] = threading.get_ident()
        with perf.phase("est.marg_job", parent=parent):
            with perf.phase("est.marg_forward"):
                pass

    with perf.phase("est.marginalize", frame=9):
        worker = threading.Thread(target=job, args=(perf.current(),))
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive()
    s = _by_name(perf.spans())
    assert s["est.marg_job"].parent == s["est.marginalize"].id
    assert s["est.marg_job"].frame == 9 and s["est.marg_forward"].frame == 9
    assert s["est.marg_forward"].parent == s["est.marg_job"].id
    assert s["est.marg_job"].thread == seen["thread"] != s["est.marginalize"].thread
    assert perf.threads()[seen["thread"]] == seen["ident"]


def test_samples_hold_the_span_durations_under_the_same_names():
    perf.enable(True)
    for k in range(3):
        with perf.phase("sys.frame", frame=k):
            with perf.phase("trk.dispatch"):
                pass
            perf.event("sys.pose_out")
    perf.add("trk.dispatch", 0.5)
    spans = perf.spans()
    assert set(perf._SAMPLES) == {"sys.frame", "trk.dispatch"}  # an instant has no sample
    for name, xs in perf._SAMPLES.items():
        assert xs == [(s.end_ns - s.start_ns) / 1e9 for s in spans if s.name == name]
    assert perf._SAMPLES["trk.dispatch"][-1] == 0.5
    assert perf.stats()["trk.dispatch"]["count"] == 4
    assert perf.thread_total_s("sys.frame") == pytest.approx(sum(perf._SAMPLES["sys.frame"]))


def _anchors(prof):
    return [e for e in prof.profiler.kineto_results.events() if e.name().startswith(perf.ANCHOR)]


def test_each_root_span_emits_one_anchor_with_its_clock():
    perf.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(3):
            with perf.phase("sys.frame", frame=k) as root:
                with perf.phase("est.process_image"):
                    pass
                with perf.phase("est.marg_job", parent=root):  # a hand-off: no anchor
                    pass
    anchors = _anchors(prof)
    roots = [s for s in perf.spans() if s.name == "sys.frame"]
    assert len(anchors) == len(roots) == 3
    for a, r in zip(sorted(anchors, key=lambda e: e.start_ns()), roots):
        stamp = int(a.name()[len(perf.ANCHOR):])
        assert stamp <= r.start_ns  # stamped just before its root opened


def test_off_records_nothing_and_emits_no_anchor():
    perf.enable(False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with perf.phase("sys.frame", frame=0) as sp:
            assert sp is None and perf.current() is None
            perf.event("sys.pose_out", frame=0)
        perf.add("trk.dispatch", 0.1)
    assert _anchors(prof) == []
    assert perf.spans() == [] and dict(perf._SAMPLES) == {} and perf.stats() == {}
    assert perf.thread_total_s("sys.frame", "trk.dispatch") == 0.0
