"""The benchmark's metric arithmetic on the CPU: percentiles over all
frames, the union of device intervals and the idle gaps of a trace, each
reader on a context it can and cannot read, and kernel_work against the
bounds of PERF.md section 6 (K1 0.000181 ms, K4 0.000502 ms at the EuRoC
window B=18, F=1000, N=3072).

The readers' checks hold for any per-layer metric BENCHMARK.json gains:
every metric reads None where there is nothing to read, and one outside
WANT is read in another test file, by a call load_reader("<name>") there."""

import json
import re
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness
from benchmark.metrics import common
from benchmark.trace import summarize_events

from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
EUROC = {"B": 18, "Vo": 8, "F": 1000, "N": 3072}


def test_percentile_is_over_every_frame():
    lat = list(range(1, 101))  # 100 frames, 1..100 ms
    assert harness.percentile(lat, 90) == pytest.approx(90.1)
    assert harness.percentile([5.0] * 9 + [500.0], 90) == pytest.approx(54.5)


@pytest.mark.parametrize("intervals,total", [
    ([], 0), ([(0, 10)], 10), ([(0, 10), (5, 20)], 20), ([(0, 10), (20, 30)], 20),
    ([(0, 100), (10, 20), (30, 40)], 100), ([(5, 6), (0, 1), (1, 5)], 6),
    ([(50, 60), (0, 10), (5, 55)], 60)])
def test_busy_time_is_the_union_of_device_intervals(intervals, total):
    s = summarize_events([(a, b, "k") for a, b in intervals], [], 1.0)
    assert s["busy_s"] == pytest.approx(total / 1e9)


def test_trace_summary_busy_gaps_and_launches():
    dev = [(0, 10, "k1"), (5, 20, "k2"), (30, 40, "k1"), (100, 110, "k3")]
    host = [(0, 200, "frame"), (25, 35, "aten::add"), (45, 95, "aten::mul"),
            (50, 60, "cudaLaunchKernel"), (61, 62, "cuLaunchKernel"), (80, 81, "cudaMemcpyAsync")]
    s = summarize_events(dev, host, 200e-9)
    assert s["launches"] == 2
    assert s["busy_s"] == pytest.approx(20e-9 + 10e-9 + 10e-9)
    assert s["kernels"]["k1"] == (2, pytest.approx(20e-9))
    assert [g[0] for g in s["idle_gaps"]] == ["aten::mul", "aten::add"]
    assert s["idle_gaps"][0][1] == pytest.approx(60e-9)
    assert s["device_ops"][0] == ["k1", pytest.approx(20e-9)]


def test_kernel_work_reproduces_the_kernel_tables_bounds():
    sh = common.window_shapes(EUROC)
    assert (sh["D"], sh["Dr"]) == (276, 114)
    assert common.kernel_bound_s("proj_rows", sh) * 1e3 == pytest.approx(0.000181, rel=5e-3)
    assert common.kernel_bound_s("linstep", sh) * 1e3 == pytest.approx(0.000502, rel=5e-3)


def _ctx(trace=None, samples=None):
    return {"phases": {}, "samples": samples or {}, "launches": {}, "dims": EUROC,
            "trace": trace, "window_frames": 10}


def _full_ctx():
    """A context that holds what every per-layer reader reads: the phases'
    samples, the traced slice's launches, busy time and kernels, and
    test_bench_spans.py's hand-built run (spans of three frames, the
    workers' pushes and jobs, the kept session's host events; its third
    frame under the profiler), with a `trk.replay` inside frame 0's
    `trk.dispatch`. A reader caches its join in the context: a fresh one
    each."""
    import test_bench_spans as hand
    from isvins_tpu_torch.utils.perf import Span

    ctx = hand._ctx(excluded={"sys.frame": [(2, 3)]})
    ctx["spans"].append(Span(14, "trk.replay", 0, hand.MAIN, 12 * hand.MS, 28 * hand.MS, 2))
    ctx["samples"].update({"trk.dispatch": [0.1, 0.3, 0.2], "est.solve_device": [0.2],
                           "est.marg_collect": [0.01, 0.03], "pg.kf_device_step": [0.07],
                           "pg.opt_dispatch": [0.4, 0.5]})
    ctx.update(launches={}, dims=EUROC, window_frames=10)
    ctx["trace"].update(
        launches=300_000, busy_s=0.4, window_s=5.0,
        kernels={"proj_rows_kernel(float*)": (110, 110 * 0.00219e-3),
                 "schur_corr_kernel(a)": (100, 100 * 0.006e-3),
                 "linstep_chol_kernel(b)": (100, 100 * 0.1e-3),
                 "linstep_dl_kernel(c)": (100, 100 * 0.0173e-3)})
    return ctx


# each reader's reading on _full_ctx(); a per-layer metric outside this table
# brings a test of its own, in a test file of its own
WANT = {"trk_dispatch_ms_p50": 200.0, "est_solve_ms_p50": 200.0,
        "est_marg_wait_ms_p50": 20.0, "pg_kf_step_ms_p50": 70.0,
        "pg_opt_dispatch_ms_p50": 450.0,
        "launches_per_frame": 150_000.0,  # the slice's 300,000 launches over its 2 frames
        "device_idle_pct": 92.0,
        "k4_linstep_roofline": 100 * 0.000502e-3 / 0.1233e-3,  # K4's three kernels a call
        "k1_proj_rows_roofline": 100 * 0.000181e-3 / 0.00219e-3,
        # the hand-built run's readings (test_bench_spans.py)
        "sys_frame_ms_p50": 110.0, "sys_self_ms_p50": (30.0 + 110.0) / 2,
        "tail_pg_busy_pct": 100 * 60 / 220, "tail_marg_busy_pct": 100 * 72 / 220,
        "trk_launches_per_frame": 1.0, "est_launches_per_frame": 1.5,
        "pg_launches_per_keyframe": 2 / 0.4,
        "trk_graph_replay_pct": 100.0}  # frame 0's one dispatch encloses a replay
NAMES = [m["name"] for m in SPEC["per_layer"]]


def reads_none_on_nothing(name: str) -> bool:
    """Whether the metric's reader reads None on a context with nothing
    to read (no trace, no samples, no spans in the port's recorder)."""
    from isvins_tpu_torch.utils import perf

    perf.enable(False)
    perf.reset()  # with no spans in the context the span readers read the recorder
    return harness.load_reader(name)(_ctx()) is None


def other_test_files():
    here = Path(__file__).resolve()
    return sorted(f for f in here.parent.glob("test_*.py") if f != here)


def readers_without_a_test(names, test_files) -> list:
    """The names outside WANT that no file of `test_files` reads: none
    holds a call load_reader("<name>") (or with single quotes)."""
    texts = [f.read_text() for f in test_files]
    return [n for n in names if n not in WANT and not any(
        re.search(rf"load_reader\(\s*([\"']){re.escape(n)}\1\s*\)", t) for t in texts)]


def test_readers_read_what_is_there_and_nothing_else():
    assert set(WANT) <= set(NAMES), sorted(set(WANT) - set(NAMES))
    for name in WANT:
        read = harness.load_reader(name)
        assert read(_full_ctx()) == pytest.approx(WANT[name], rel=5e-3), name
        assert reads_none_on_nothing(name), name  # nothing to read: left out, never 0


@pytest.mark.parametrize("name", NAMES)
def test_every_reader_reads_none_where_there_is_nothing(name):
    assert reads_none_on_nothing(name)


def test_every_reader_outside_the_table_has_a_test_of_its_own():
    assert readers_without_a_test(NAMES, other_test_files()) == []


def test_every_metric_has_a_reader_or_the_harness_takes_it():
    for m in SPEC["end_to_end"]:
        assert m["name"] in ("frames_per_s", "pose_latency_ms_p90", "setup_s")
        assert m["source"] == "host_clock"
    for m in SPEC["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        moved = {e["name"] for e in SPEC["end_to_end"]}
        assert m["moves"] in moved


def test_roofline_share_never_reads_zero_without_device_time():
    trace = {"launches": 1, "frames": 1, "busy_s": 1.0, "window_s": 2.0, "kernels": {}}
    assert harness.load_reader("k4_linstep_roofline")(_ctx(trace)) is None
    assert np.isfinite(common.kernel_bound_s("linstep", common.window_shapes(EUROC)))
