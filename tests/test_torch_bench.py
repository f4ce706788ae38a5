"""The port's two benches (isvins_tpu_torch.bench and
isvins_tpu_torch.retrieval_bench) against the JAX package on the CPU.

- bench: e2e_config() against bench_reference.e2e_config() (bench.py's
  configuration, field by field); the port's e2e loop (drive_e2e) through
  the port's System(pipeline=True, pg_thread=True, solve_async=True)
  against bench.py's loop (bench_reference.drive) through the JAX
  package's System at a cut; the JSON lines' field names against bench.py's
  own; the solve stage at a cut.
- retrieval_bench: the port's build_db + evaluate against retrieval_bench.py's
  on the same 80-keyframe sweep, past the vocabulary's freeze.

The card runs of both benches are chip_smoke.py's `e2e` and `retrieval`
phases; tests/test_torch_gpu.py holds the async e2e drive to the
synchronous one on the card."""

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import isvins_tpu  # noqa: F401
import bench_reference
import retrieval_bench as jax_retrieval
from isvins_tpu_torch import bench, retrieval_bench
from isvins_tpu_torch.geom.hostmath import mat_to_quat_np
from isvins_tpu_torch.utils.synthetic import RoomRenderer, make_world

import test_torch_system as small

ROOT = Path(__file__).resolve().parents[1]
E2E_CUT_FRAMES = 30  # the small scene's world at 30 frames: 17-18 steady frames
RETRIEVAL_CUT = 80  # queries at idx 51..79, all after the vocabulary freezes (idx 48)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: beside other test processes, torch's intra-op thread
    pools only contend with each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench_py_keys(block_start: str):
    """The string keys of the dict literal that opens at `block_start` in
    bench.py, in order."""
    src = (ROOT / "bench.py").read_text()
    body = src[src.index(block_start):]
    body = body[: body.index("}")]
    return re.findall(r'"(\w+)":', body)


def test_e2e_config_matches_bench_py():
    """Every field of camera, tracker, window, noise, solver and posegraph,
    and tic, ric and the window dims, of the port's e2e_config() equal
    bench.py's (bench_reference.e2e_config copies bench.py:190-208); the
    world's arguments equal too. The port's tracker has one field more,
    fused_ransac, left at None (the card's fused RANSAC)."""
    cfg, dims = bench.e2e_config()
    jcfg, jdims = bench_reference.e2e_config()
    for part in ("camera", "tracker", "window", "noise", "solver", "posegraph"):
        j = getattr(jcfg, part)
        for f in dataclasses.fields(j):
            assert getattr(getattr(cfg, part), f.name) == getattr(j, f.name), (part, f.name)
    assert cfg.tracker.fused_ransac is None
    np.testing.assert_array_equal(cfg.tic_np, jcfg.tic_np)
    np.testing.assert_array_equal(cfg.ric_np, jcfg.ric_np)
    assert tuple(dims) == tuple(jdims) == (18, 8, 1000, 3072)
    assert bench.E2E_WORLD == bench_reference.WORLD_KW


@pytest.fixture(scope="module")
def e2e_runs():
    """The small scene of tests/test_torch_system.py (its config, window
    B=10/Vo=4/F=256/N=2048 and 320x240 RoomRenderer world, loops on) at
    E2E_CUT_FRAMES frames, through both packages' System(pipeline=True,
    pg_thread=True, solve_async=True) and each package's copy of bench.py's
    loop: (port result, port System, JAX result, JAX System)."""
    cam = small._config("torch", True).camera
    world = make_world(n_frames=E2E_CUT_FRAMES, frame_hz=10.0, imu_hz=200.0, n_landmarks=500,
                       seed=3)
    r = RoomRenderer(world, cam, np.zeros(3), mat_to_quat_np(np.array(small.R_BC)))
    frames = [r.render(k)[0] for k in range(E2E_CUT_FRAMES)]
    t = small._system("torch", True, pipeline=True, pg_thread=True, solve_async=True)
    try:
        out = bench.drive_e2e(t, world, frames)
    finally:
        t.close()
    j = small._system("jax", True, pipeline=True, pg_thread=True, solve_async=True)
    jout = bench_reference.drive(j, world, frames)
    return out, t, jout, j


def test_e2e_drive_matches_reference(e2e_runs):
    """The cut: tests/test_torch_system.py's small window and scene at
    E2E_CUT_FRAMES frames (bench.py's 130 frames at the 18/8/1000 window take
    minutes on this CPU), loops on (skip_recent 100: keyframes, no loop).
    Equal pose timestamps, poses within test_torch_system.POSE_TOL (the two
    packages' f32 solves sum in different orders), equal keyframe
    timestamps, the same frames processed and measured, both ATEs within
    POSE_TOL."""
    out, t, jout, j = e2e_runs
    traj, jtraj = out["trajectory"], jout["trajectory"]
    assert [x[0] for x in traj] == [x[0] for x in jtraj] and len(traj) >= 15
    for (_, P, Q), (_, jP, jQ) in zip(traj, jtraj):
        np.testing.assert_allclose(P, jP, rtol=0, atol=small.POSE_TOL)
        np.testing.assert_allclose(Q, jQ, rtol=0, atol=small.POSE_TOL)
    n = t.pgbuilder.db.n
    assert n == j.pgbuilder.db.n >= 10
    np.testing.assert_array_equal(t.pgbuilder.db.ts[:n], j.pgbuilder.db.ts[:n])
    for k in ("e2e_frames_processed", "e2e_frames_measured", "e2e_keyframes",
              "e2e_loops_closed"):
        assert out[k] == jout[k], k
    assert out["e2e_frames_processed"] == E2E_CUT_FRAMES and out["e2e_frames_measured"] >= 8
    for k in ("e2e_ate_vio_m", "e2e_ate_loop_m"):
        assert abs(out[k] - jout[k]) <= small.POSE_TOL, k
    assert t.estimator.steady_solves == len(out["steady_ms"])  # one solve a steady frame
    assert out["phases"]["est.solve_dispatch"]["count"] > 0  # the async solve ran


def test_e2e_fields_are_bench_py_names(e2e_runs):
    """drive_e2e's e2e_* keys are bench.py's ten detail names plus
    e2e_pipeline_fps (bench.py:302-313, read from its source); every value
    is a finite number."""
    out = e2e_runs[0]
    names = set(_bench_py_keys("detail = {")) | {"e2e_pipeline_fps"}
    assert {k for k in out if k.startswith("e2e_")} == names
    assert set(bench.E2E_FIELDS) == names - {"e2e_pipeline_fps"} and len(bench.E2E_FIELDS) == 10
    assert all(np.isfinite(out[k]) for k in names)
    assert out["e2e_pipeline_fps"] == pytest.approx(1e3 / out["e2e_median_ms"])


def test_main_prints_bench_py_lines(e2e_runs, monkeypatch, capsys):
    """main() prints bench.py's headline line first (bench.py:337-346's keys
    in order, e2e_pipeline_fps null), then the final line: the headline's
    keys with e2e_pipeline_fps filled in and the ten detail fields. The two
    stages are stood in for by a solve result and the cut drive above."""
    out = e2e_runs[0]
    solve = {"vio_window_solve_frames_per_s": 10.0, "batched": {8: 80.0, 16: 150.0, 32: 300.0}}
    monkeypatch.setattr(bench, "bench_solve", lambda dev: solve)
    monkeypatch.setattr(bench, "bench_e2e", lambda dev, budget_s: out)
    bench.main(["--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 2
    keys = _bench_py_keys("result = {")
    assert list(lines[0]) == keys and lines[0]["e2e_pipeline_fps"] is None
    assert lines[0]["value"] == 10.0 and lines[0]["vs_baseline"] == 10.0 / 125.0
    assert lines[0]["batched_x16_throughput"] == 150.0
    assert list(lines[1]) == keys + list(bench.E2E_FIELDS)
    assert lines[1]["e2e_pipeline_fps"] == out["e2e_pipeline_fps"]
    assert all(lines[1][k] == out[k] for k in bench.E2E_FIELDS)


def test_bench_solve_at_a_cut(monkeypatch):
    """The solve stage on the CPU at a small window (B=6/Vo=3/F=32/N=64) in
    place of the product window, one timed solve each, batched at NB = 2:
    positive finite rates, the 20- and 10-iteration medians' difference as
    the marginal."""
    from isvins_tpu_torch.solver import WindowDims

    monkeypatch.setattr(bench, "PRODUCT_DIMS", WindowDims(6, 3, 32, 64))
    monkeypatch.setattr(bench, "SOLVE_REPS", 1)
    monkeypatch.setattr(bench, "BATCHES", (2,))
    r = bench.bench_solve("cpu")
    assert np.isfinite(r["vio_window_solve_frames_per_s"]) and r["vio_window_solve_frames_per_s"] > 0
    assert r["solve_median_ms"] == pytest.approx(1e3 / r["vio_window_solve_frames_per_s"])
    assert np.isfinite(r["per_lm_iteration_marginal_ms"])
    assert list(r["batched"]) == [2] and r["batched"][2] > 0


@pytest.fixture(scope="module")
def retrieval_runs():
    """retrieval_bench.py's sweep cut to RETRIEVAL_CUT keyframes through both
    packages on the CPU (skip_recent 50, min_loop_matches 15); the port's
    build_db takes the frames rendered once by the port's RoomRenderer (it
    renders what the JAX one renders: test_torch_posegraph.
    test_room_renderer_matches_reference)."""
    from isvins_tpu.config import PoseGraphConfig as JPG
    from isvins_tpu_torch.config import PoseGraphConfig

    world, renderer = retrieval_bench.retrieval_world(RETRIEVAL_CUT)
    frames = [renderer.render(k)[0] for k in range(RETRIEVAL_CUT)]
    db, gt_t, gt_yaw, _, _ = retrieval_bench.build_db(RETRIEVAL_CUT, device="cpu",
                                                      frames=frames)
    st = retrieval_bench.evaluate(db, gt_t, gt_yaw,
                                  PoseGraphConfig(skip_recent=50, min_loop_matches=15))
    jdb, jgt_t, jgt_yaw, _, _ = jax_retrieval.build_db(RETRIEVAL_CUT)
    jst = jax_retrieval.evaluate(jdb, jgt_t, jgt_yaw, JPG(skip_recent=50, min_loop_matches=15))
    return (db, gt_t, gt_yaw, st), (jdb, jgt_t, jgt_yaw, jst)


def test_retrieval_matches_reference(retrieval_runs):
    """The same ground truth, the same keyframes (corners exactly, BRIEF
    words but one), the same counts of queries with a true revisit,
    retrieval hits, candidates, true candidates, verified loops and good
    loops; the same loop pairs and measured relative poses within 1e-6 m
    and 1e-4 degrees, but one.

    What is exactly true at this cut: the two packages' BRIEF sums its f32
    patch products in different orders, and one bit of one descriptor
    differs (keyframe 29, keypoint 219; the first keyframe where the
    keyframes differ). That descriptor is sampled into the vocabulary at the
    freeze (word 2130), which moves a few keyframes' tf vectors, and the
    two nearly tied candidates of query 79 come out in the other order
    (14, 15 against 15, 14): both verify, so its loop goes to keyframe 14 in
    the port and 15 in the JAX package, both good loops, with another
    measured relative pose. Every other query agrees."""
    (db, gt_t, gt_yaw, st), (jdb, jgt_t, jgt_yaw, jst) = retrieval_runs
    n = RETRIEVAL_CUT
    assert db.n == jdb.n == n
    np.testing.assert_array_equal(gt_t, jgt_t)
    np.testing.assert_array_equal(gt_yaw, jgt_yaw)
    np.testing.assert_array_equal(db.kp_valid[:n], jdb.kp_valid[:n])
    np.testing.assert_array_equal(db.kp_norm[:n], jdb.kp_norm[:n])
    np.testing.assert_array_equal(db.win_pts3d[:n], jdb.win_pts3d[:n])
    diff = np.argwhere((db.kp_desc[:n] != jdb.kp_desc[:n]).any(axis=-1))
    assert diff.tolist() == [[29, 219]]
    bits = np.bitwise_count(db.kp_desc[29, 219] ^ jdb.kp_desc[29, 219]).sum()
    assert bits == 1
    for k in ("q_with_truth", "q_recall_hits", "cand_total", "cand_true", "ver_fired",
              "ver_true", "q_ver_hits"):
        assert st[k] == jst[k], k
    assert st["q_with_truth"] >= 10 and st["ver_fired"] >= 20
    fired = np.where(jdb.loop_idx[:n] >= 0)[0]
    np.testing.assert_array_equal(np.where(db.loop_idx[:n] >= 0)[0], fired)
    same = fired[fired != 79]
    np.testing.assert_array_equal(db.loop_idx[same], jdb.loop_idx[same])
    assert (db.loop_idx[79], jdb.loop_idx[79]) == (14, 15)
    errs, jerrs = np.array(st["rel_errs"]), np.array(jst["rel_errs"])
    keep = fired != 79  # rel_errs are in query order, one per fired loop
    np.testing.assert_allclose(errs[keep, 0], jerrs[keep, 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(errs[keep, 1], jerrs[keep, 1], rtol=0, atol=1e-4)
    assert len(st["find_connection_ms"]) >= st["ver_fired"]


def test_retrieval_fields_and_queries(retrieval_runs):
    """summarize() gives RETRIEVAL_r05.json's nine keys (retrieval_bench.py:
    219-229) from the counts, unrounded; no query of the sweep went through
    K6's match-count path (the vocabulary froze at the 49th keyframe, before
    the first query at idx 51), and the CPU run launched no kernel."""
    from isvins_tpu_torch import ops

    (db, _, _, st), (_, _, _, jst) = retrieval_runs
    out = retrieval_bench.summarize(st, db.n)
    ref = json.loads((ROOT / "RETRIEVAL_r05.json").read_text())
    assert list(out) == list(ref)
    assert out["retrieval_recall_at_4"] == st["q_recall_hits"] / st["q_with_truth"]
    assert out["loops_fired"] == jst["ver_fired"]
    assert db.vocab_frozen and db.match_count_queries == []
    assert ops.launch_counts()["retrieval_scores"] == 0
