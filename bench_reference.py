#!/usr/bin/env python3
"""The JAX package's run of bench.py's end-to-end stage, on the CPU: the
reference run that chip_smoke.py's `e2e` phase holds the port to.

    JAX_PLATFORMS=cpu python3 bench_reference.py

bench.py:173-324's configuration, unchanged (e2e_config: a 320x240 f = 200
camera, max_cnt 150, min_dist 10, 4 LK levels of 21x21, no CLAHE; window
18/8/1000, N = 3072; bench's noise and excitation threshold 0.08; the pose
graph on with keyframe_min_dist 0.3, skip_recent 25, min_loop_matches 15,
max_keyframes 256, max_kp_per_kf 256), its world (make_world(n_frames=130,
frame_hz=10, imu_hz=200, n_landmarks=300, seed=1, traj_r=3.0,
traj_w=0.65), 1.34 laps) and RoomRenderer, through
System(enable_loop=True, pipeline=True, pg_thread=True, solve_async=True)
with bench.py's frame loop (`drive`). Prints one JSON line: the frame whose
packet the estimator initialized on (`e2e_init_frame`, counted by packet
as chip_smoke._watch_init counts it), keyframes, loops and their precision
(a loop is correct when its relative translation is within 30 cm of
ground truth's, realism_bench.py:173-187), both ATEs and the frames
measured. Its frame times are this CPU's and are not printed as e2e
fields; the render and the drive are timed under `cpu_*` names.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_FRAMES = 130
WORLD_KW = dict(n_frames=N_FRAMES, frame_hz=10.0, imu_hz=200.0, n_landmarks=300, seed=1,
                traj_r=3.0, traj_w=0.65)


def e2e_config():
    """bench.py:190-208."""
    from isvins_tpu.config import (CameraConfig, NoiseConfig, PoseGraphConfig, TrackerConfig,
                                   WindowConfig, euroc_config)
    from isvins_tpu.solver import WindowDims

    H, W, f = 240, 320, 200.0
    cam = CameraConfig(width=W, height=H, fx=f, fy=f, cx=W / 2, cy=H / 2,
                       k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    R_bc = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
    cfg = euroc_config().replace(
        camera=cam,
        tracker=TrackerConfig(max_cnt=150, min_dist=10, freq=100, lk_levels=4,
                              lk_win=21, equalize=False, border=4),
        window=WindowConfig(vo_size=8, all_size=18, max_features=1000, max_imu_per_frame=64),
        noise=NoiseConfig(acc_n=0.05, gyr_n=0.005, acc_w=1e-4, gyr_w=1e-5, pixel_sqrt_info=f),
        solver=euroc_config().solver.__class__(excitation_threshold=0.08),
        posegraph=PoseGraphConfig(enabled=True, keyframe_min_dist=0.3, skip_recent=25,
                                  min_loop_matches=15, max_keyframes=256, max_kp_per_kf=256),
        tic=(0.0, 0.0, 0.0), ric=R_bc)
    return cfg, WindowDims(B=18, Vo=8, F=1000, N=3072)


def watch_init(est, frame_times):
    """Wrap est.process_image: the returned list receives the index of the
    frame whose packet was being processed when the estimator initialized
    (counted by packet, as chip_smoke._watch_init counts it)."""
    process_image, hit = est.process_image, []

    def watched(ids, pts, t, vels=None):
        out = process_image(ids, pts, t, vels=vels)
        if not hit and est.solver_flag == 2:
            hit.append(int(np.argmin(np.abs(np.asarray(frame_times) - t))))
        return out

    est.process_image = watched
    return hit


def drive(sys_, world, frames, budget_s=1500.0):
    """bench.py:247-313's frame loop over `frames`: after wait_pg_ready(),
    each frame's pub_imu calls and its pub_image (flush() on the last
    frame), timed whole; the median, p90 and max over the second half of
    the steady frames, both ATEs (align="se3"). Returns bench.py's ten
    detail fields (unrounded) plus the VIO trajectory and the steady frame
    times."""
    from isvins_tpu.utils.evaluation import ate_rmse

    sys_.wait_pg_ready()
    n_frames = len(frames)
    steady_dts, t_steady0, frames_done = [], None, 0
    t_wall0 = time.perf_counter()
    for k in range(n_frames):
        if time.perf_counter() - t_wall0 > budget_s:
            break
        t0 = time.perf_counter()
        if k > 0:
            n = int(np.sum(world.imu_dts[k - 1] > 0))
            acc_t = world.frame_times[k - 1]
            for s in range(n):
                acc_t += world.imu_dts[k - 1][s]
                sys_.pub_imu(acc_t, world.imu_accs[k - 1][s], world.imu_gyrs[k - 1][s])
        sys_.pub_image(world.frame_times[k], frames[k])
        if k == n_frames - 1:
            sys_.flush()
        dt = time.perf_counter() - t0
        frames_done = k + 1
        if sys_.estimator.solver_flag == 2:
            if t_steady0 is None:
                t_steady0 = time.perf_counter() - t_wall0
            steady_dts.append(dt)
    if len(steady_dts) < 8:
        raise RuntimeError(f"only {len(steady_dts)} steady frames")
    tail = np.array(steady_dts[len(steady_dts) // 2:])
    traj = sys_.vio_trajectory
    ate_vio = ate_opt = None
    if len(traj) >= 10:
        t_est = np.array([t for (t, _, _) in traj])
        p_est = np.array([P for (_, P, _) in traj])
        ate_vio = float(ate_rmse(t_est, p_est, world.frame_times, world.P, align="se3"))
        if sys_.pgbuilder is not None and sys_.pgbuilder.db.n >= 5:
            ts_k, t_opt, _ = sys_.pgbuilder.trajectory()
            ate_opt = float(ate_rmse(ts_k, t_opt, world.frame_times, world.P, align="se3"))
    pg = sys_.pgbuilder
    return {
        "e2e_ate_vio_m": ate_vio, "e2e_ate_loop_m": ate_opt,
        "e2e_median_ms": float(np.median(tail)) * 1e3,
        "e2e_p90_ms": float(np.percentile(tail, 90)) * 1e3,
        "e2e_max_ms": float(np.max(tail)) * 1e3,
        "e2e_loops_closed": int(pg.n_loops) if pg else 0,
        "e2e_keyframes": int(pg.db.n) if pg else 0,
        "e2e_ramp_to_steady_s": t_steady0,
        "e2e_frames_measured": int(len(tail)), "e2e_frames_processed": int(frames_done),
        "trajectory": list(traj), "steady_ms": [d * 1e3 for d in steady_dts],
    }


def main():
    from isvins_tpu.geom.hostmath import mat_to_quat_np
    from isvins_tpu.system import System
    from isvins_tpu.utils.synthetic import RoomRenderer, make_world
    from system_reference import loop_precision

    cfg, dims = e2e_config()
    world = make_world(**WORLD_KW)
    renderer = RoomRenderer(world, cfg.camera, np.zeros(3), mat_to_quat_np(np.asarray(cfg.ric_np)))
    t0 = time.time()
    frames = [renderer.render(k)[0] for k in range(N_FRAMES)]
    render_s = time.time() - t0
    sys_ = System(cfg, dims, enable_loop=True, pipeline=True, pg_thread=True, solve_async=True)
    init_at = watch_init(sys_.estimator, world.frame_times)
    t0 = time.time()
    out = drive(sys_, world, frames, budget_s=float("inf"))
    drive_s = time.time() - t0
    gt = {"t": world.frame_times, "p": world.P, "q": world.Q}
    n_loops, precision = loop_precision(sys_.pgbuilder.db, gt)
    print(json.dumps({
        "reference": "isvins_tpu System(solve_async=True) on the CPU, bench.py's e2e loop",
        "backend": jax.default_backend(), "e2e_init_frame": init_at[0] if init_at else None,
        "e2e_keyframes": out["e2e_keyframes"], "e2e_loops_closed": out["e2e_loops_closed"],
        "e2e_loop_precision": precision, "loops_scored": n_loops,
        "e2e_ate_vio_m": out["e2e_ate_vio_m"], "e2e_ate_loop_m": out["e2e_ate_loop_m"],
        "e2e_frames_measured": out["e2e_frames_measured"],
        "e2e_frames_processed": out["e2e_frames_processed"],
        "solved_poses": len(out["trajectory"]), "steady_frames": len(out["steady_ms"]),
        "cpu_render_s": round(render_s, 1), "cpu_drive_s": round(drive_s, 1)}))


if __name__ == "__main__":
    main()
