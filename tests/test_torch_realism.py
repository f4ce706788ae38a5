"""The port's realism_bench (isvins_tpu_torch.realism_bench) against
realism_bench.py and the JAX package on the CPU.

- realism_config() and the world's arguments against realism_bench.py:46-70,
  read from its source and evaluated with the JAX package's config classes;
- drive_realism, realism_bench.py's frame loop, through the port's
  System(pipeline=True, pg_thread=True) against realism_reference.drive
  through the JAX package's System, synchronous and with solve_async, at a
  cut (tests/test_torch_system.py's small window and 320x240 scene);
- the tracker time per frame read from the frame thread's utils.perf
  phases, which no other thread's phases reach;
- main()'s JSON line has realism_bench.py's field names.

The card run at EuRoC's 752x480 is chip_smoke.py's `realism` phase."""

import dataclasses
import json
import re
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import isvins_tpu  # noqa: F401
import realism_reference
from isvins_tpu_torch import realism_bench
from isvins_tpu_torch.geom.hostmath import mat_to_quat_np
from isvins_tpu_torch.utils import perf
from isvins_tpu_torch.utils.synthetic import RoomRenderer, make_world

import test_torch_system as small

ROOT = Path(__file__).resolve().parents[1]
CUT_FRAMES = 30  # the small scene's world at 30 frames: 18 steady frames


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: beside other test processes, torch's intra-op thread
    pools only contend with each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _realism_source():
    """realism_bench.py's configuration and world (its lines 46-70),
    evaluated with the JAX package's config classes and a make_world that
    returns its arguments: (cfg, dims, world kwargs)."""
    from isvins_tpu.config import (CameraConfig, NoiseConfig, PoseGraphConfig, TrackerConfig,
                                   WindowConfig, euroc_config)
    from isvins_tpu.solver import WindowDims

    src = (ROOT / "realism_bench.py").read_text()
    body = src[src.index("    cam = CameraConfig()"): src.index("    qic = mat_to_quat_np")]
    ns = dict(CameraConfig=CameraConfig, NoiseConfig=NoiseConfig,
              PoseGraphConfig=PoseGraphConfig, TrackerConfig=TrackerConfig,
              WindowConfig=WindowConfig, euroc_config=euroc_config, WindowDims=WindowDims,
              make_world=lambda **kw: kw, n_frames=realism_bench.N_FRAMES)
    exec(textwrap.dedent(body), ns)
    return ns["cfg"], ns["dims"], ns["world"]


def test_realism_config_matches_realism_bench_py():
    """Every field of camera, tracker, window, noise, solver and posegraph,
    and tic, ric and the window dims, of the port's realism_config() equal
    realism_bench.py's (read from its source); so do the JAX reference
    script's. The port's tracker has one field more, fused_ransac, left at
    None (the card's fused RANSAC). The world's arguments equal
    REALISM_WORLD and realism_reference.WORLD_KW."""
    cfg, dims = realism_bench.realism_config()
    jcfg, jdims, world_kw = _realism_source()
    rcfg, _ = realism_reference.realism_config()
    assert rcfg == jcfg
    for part in ("camera", "tracker", "window", "noise", "solver", "posegraph"):
        j = getattr(jcfg, part)
        for f in dataclasses.fields(j):
            assert getattr(getattr(cfg, part), f.name) == getattr(j, f.name), (part, f.name)
    assert cfg.tracker.fused_ransac is None
    assert cfg.estimate_extrinsic == jcfg.estimate_extrinsic
    np.testing.assert_array_equal(cfg.tic_np, jcfg.tic_np)
    np.testing.assert_array_equal(cfg.ric_np, jcfg.ric_np)
    assert tuple(dims) == tuple(jdims) == (18, 8, 1000, 3072)
    assert world_kw.pop("n_frames") == realism_bench.N_FRAMES
    assert world_kw == realism_bench.REALISM_WORLD == realism_reference.WORLD_KW


@pytest.fixture(scope="module")
def scene():
    """tests/test_torch_system.py's world and frames at CUT_FRAMES frames."""
    cam = small._config("torch", True).camera
    world = make_world(n_frames=CUT_FRAMES, frame_hz=10.0, imu_hz=200.0, n_landmarks=500,
                       seed=3)
    r = RoomRenderer(world, cam, np.zeros(3), mat_to_quat_np(np.array(small.R_BC)))
    return world, [r.render(k)[0] for k in range(CUT_FRAMES)]


@pytest.fixture(scope="module", params=[False, True], ids=["sync", "async"])
def drives(request, scene):
    """The cut through both packages' System(pipeline=True, pg_thread=True,
    solve_async=param), loops on: (port result, port System, JAX result)."""
    world, frames = scene
    kw = dict(pipeline=True, pg_thread=True, solve_async=request.param)
    t = small._system("torch", True, **kw)
    try:
        out = realism_bench.drive_realism(t, world, frames)
    finally:
        t.close()
    j = small._system("jax", True, **kw)
    return out, t, realism_reference.drive(j, world, frames)


def test_drive_matches_reference(drives):
    """The cut: tests/test_torch_system.py's small window and scene at
    CUT_FRAMES frames (realism_bench.py's 200 frames at 752x480 and the
    18/8/1000 window take minutes on this CPU), loops on (skip_recent 100:
    keyframes, no loop). Equal pose timestamps, poses within
    test_torch_system.POSE_TOL (the two packages' f32 solves sum in
    different orders), equal keyframe timestamps, equal counts (poses,
    keyframes, loops, timed frames, the first steady frame), ATEs within
    POSE_TOL."""
    out, t, jout = drives
    traj, jtraj = out["trajectory"], jout["trajectory"]
    assert [x[0] for x in traj] == [x[0] for x in jtraj] and len(traj) >= 15
    for (_, P, Q), (_, jP, jQ) in zip(traj, jtraj):
        np.testing.assert_allclose(P, jP, rtol=0, atol=small.POSE_TOL)
        np.testing.assert_allclose(Q, jQ, rtol=0, atol=small.POSE_TOL)
    np.testing.assert_array_equal(out["keyframe_ts"], jout["keyframe_ts"])
    for k in ("frames", "solved_poses", "keyframes", "loops_closed", "first_solved_frame"):
        assert out[k] == jout[k], k
    assert out["keyframes"] >= 10 and out["frames"] == CUT_FRAMES
    assert len(out["frame_ms"]) == len(jout["frame_ms"]) >= 8
    for k in ("ate_se3_m_vio", "ate_se3_m_kf_vio", "ate_se3_m_loop_opt"):
        assert abs(out[k] - jout[k]) <= small.POSE_TOL, k
    assert out["backend"] == "cpu" and out["window_shape"].startswith("B=10/Vo=4/F=256/N=2048")


def test_tracker_time_is_the_frame_threads(drives):
    """tracker_ms per frame is the frame thread's trk.dispatch + trk.collect
    inside the frame: positive, under the frame's time, and summed over the
    steady frames equal to those phases' totals; the median is the field."""
    out = drives[0]
    trk, frame = np.array(out["tracker_ms"]), np.array(out["frame_ms"])
    assert len(trk) == len(frame) and np.all(trk > 0) and np.all(trk < frame)
    total = sum(out["phases"][k]["total_ms"] for k in ("trk.dispatch", "trk.collect"))
    assert trk.sum() == pytest.approx(total, abs=0.02)
    assert out["tracker_ms_per_frame_median"] == pytest.approx(float(np.median(trk)))
    assert out["pipeline_ms_per_frame_median"] == pytest.approx(float(np.median(frame)))
    assert out["pipeline_fps"] == pytest.approx(1e3 / out["pipeline_ms_per_frame_median"])


def test_thread_totals_leave_out_other_threads():
    """perf.thread_total_s counts the calling thread's phases only: a phase
    of the same name recorded meanwhile on another thread (as the
    pose-graph worker records its own) does not reach it."""
    perf.reset()
    perf.enable(True)
    try:
        perf.add("trk.dispatch", 0.25)
        worker = threading.Thread(target=lambda: perf.add("trk.dispatch", 10.0))
        worker.start()
        worker.join()
        perf.add("trk.collect", 0.5)
        assert perf.thread_total_s("trk.dispatch", "trk.collect") == 0.75
        assert perf.stats()["trk.dispatch"]["count"] == 2
    finally:
        perf.enable(False)
        perf.reset()
    assert perf.thread_total_s("trk.dispatch") == 0.0


def test_main_prints_realism_bench_py_fields(drives, monkeypatch, capsys, tmp_path):
    """main() prints one JSON line whose keys are realism_bench.py's (its
    `out = {` literal, in order), every count and time a finite number, and
    writes the same object only at --out; the command line's arguments reach
    the run (--solve-async, the device, the frame count). The run is stood
    in for by the cut drive above."""
    out = drives[0]
    seen = []

    def fake(device=None, solve_async=False, frames=None, n_frames=realism_bench.N_FRAMES):
        seen.append((device, solve_async, n_frames))
        return out

    monkeypatch.setattr(realism_bench, "bench_realism", fake)
    path = tmp_path / "realism.json"
    realism_bench.cli(["30", "--solve-async", "--device", "cpu", "--out", str(path)])
    realism_bench.main(30)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    src = (ROOT / "realism_bench.py").read_text()
    body = src[src.index("    out = {"):]
    keys = re.findall(r'^        "(\w+)":', body[: body.index("\n    }")], re.M)
    assert len(lines) == 2 and list(lines[0]) == keys == list(realism_bench.FIELDS)
    assert lines[0] == lines[1] == json.loads(path.read_text())
    assert seen == [("cpu", True, 30), (None, False, 30)]
    for k in keys[4:]:
        if k not in ("loop_precision_vs_gt", "loop_rel_t_err_median_m"):  # no loop at the cut
            assert np.isfinite(lines[0][k]), k
