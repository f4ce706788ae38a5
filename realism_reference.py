#!/usr/bin/env python3
"""The JAX package's run of realism_bench.py's configuration with the async
solve, on the CPU: the reference run that chip_smoke.py's `realism` phase
holds the port to.

    JAX_PLATFORMS=cpu python3 realism_reference.py

realism_bench.py:40-74's configuration and world, unchanged (EuRoC cam0 at
752x480 with radtan distortion, max_cnt 150, min_dist 25, 4 LK levels of
21x21, CLAHE; window 18/8/1000, N = 3072; its noise and excitation
threshold 0.08; the pose graph on with keyframe_min_dist 0.3, skip_recent
25, min_loop_matches 15, max_keyframes 512, max_kp_per_kf 256;
make_world(n_frames=200, frame_hz=20, seed=7, traj_w=0.9, ...), 1.4 laps;
RoomRenderer(seed=11, tex_res=512)), rendered in memory, through
System(enable_loop=True, pipeline=True, pg_thread=True, solve_async=True)
with realism_bench.py:128-156's frame loop (`drive`). Prints one JSON line:
the frame whose packet the estimator initialized on (`init_frame`, counted
by packet as chip_smoke._watch_init counts it) and realism_bench.py's
fields that the bars read (keyframes, loops and their precision, the three
ATEs). Its frame times are this CPU's and are not printed under
realism_bench.py's names; the render and the drive are timed under `cpu_*`
names.
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

N_FRAMES = 200
WORLD_KW = dict(frame_hz=20.0, imu_hz=200.0, n_landmarks=10, seed=7, traj_r=3.0, traj_w=0.9,
                noise_acc=0.02, noise_gyr=0.002, ba=(0.02, -0.015, 0.01),
                bg=(0.002, -0.003, 0.004))


def realism_config():
    """realism_bench.py:46-64."""
    from system_reference import system_config

    return system_config()


def realism_world(n_frames=N_FRAMES):
    """realism_bench.py:66-74: (world, renderer)."""
    from isvins_tpu.frontend import make_camera
    from isvins_tpu.geom.hostmath import mat_to_quat_np
    from isvins_tpu.utils.synthetic import RoomRenderer, make_world

    cfg, _ = realism_config()
    world = make_world(n_frames=n_frames, **WORLD_KW)
    return world, RoomRenderer(world, cfg.camera, np.zeros(3),
                               mat_to_quat_np(np.asarray(cfg.ric_np)), seed=11,
                               camera_model=make_camera(cfg.camera), tex_res=512)


def drive(sys_, world, frames):
    """realism_bench.py:124-213 over `frames` through a built System:
    wait_pg_ready(), then per frame the pub_imu calls before it and its
    pub_image (flush() on the last), timed whole from the third frame on;
    the times restart at the first frame after whose pub_image the
    estimator is NON_LINEAR. Returns realism_bench.py's counts and ATEs
    (unrounded), the VIO trajectory, the keyframes' timestamps and the
    frame times (ms)."""
    from isvins_tpu.geom.hostmath import quat_to_mat_np
    from isvins_tpu.utils.evaluation import ate_rmse

    sys_.wait_pg_ready()
    n_frames, t_frame, first_solved = len(frames), [], None
    for k in range(n_frames):
        ta = time.perf_counter()
        if k > 0:
            acc_t = world.frame_times[k - 1]
            for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                acc_t += world.imu_dts[k - 1][s]
                sys_.pub_imu(acc_t, world.imu_accs[k - 1][s], world.imu_gyrs[k - 1][s])
        sys_.pub_image(world.frame_times[k], frames[k])
        if k == n_frames - 1:
            sys_.flush()
        if k >= 2:
            t_frame.append((time.perf_counter() - ta) * 1e3)
        if first_solved is None and sys_.estimator.solver_flag == 2:
            first_solved = k
            t_frame.clear()
    traj = sys_.vio_trajectory
    pg = sys_.pgbuilder
    db = pg.db
    n_kf = int(db.n)
    ate = lambda t, p: float(ate_rmse(t, p, world.frame_times, world.P, align="se3"))
    ts_kf, t_opt, _ = pg.trajectory()
    n_loops = n_correct = 0
    errs = []
    for kf in range(n_kf):
        old = int(db.loop_idx[kf])
        if old < 0:
            continue
        n_loops += 1
        gi = int(np.argmin(np.abs(world.frame_times - db.ts[kf])))
        gj = int(np.argmin(np.abs(world.frame_times - db.ts[old])))
        rel = quat_to_mat_np(world.Q[gj]).T @ (world.P[gi] - world.P[gj])
        errs.append(float(np.linalg.norm(rel - db.loop_dt[kf])))
        n_correct += errs[-1] < 0.30
    return {
        "frames": n_frames, "solved_poses": len(traj), "keyframes": n_kf,
        "loops_closed": n_loops, "loop_precision_vs_gt": n_correct / n_loops if n_loops else None,
        "loop_rel_t_err_median_m": float(np.median(errs)) if errs else None,
        "ate_se3_m_vio": ate(np.array([t for t, _, _ in traj]),
                             np.array([P for _, P, _ in traj])) if len(traj) >= 10 else None,
        "ate_se3_m_kf_vio": ate(ts_kf, db.vio_t[:n_kf]) if n_kf >= 10 else None,
        "ate_se3_m_loop_opt": ate(ts_kf, t_opt) if n_kf >= 10 else None,
        "first_solved_frame": first_solved, "trajectory": list(traj),
        "keyframe_ts": np.array(db.ts[:n_kf]), "frame_ms": t_frame,
    }


def main():
    from bench_reference import watch_init
    from isvins_tpu.system import System

    cfg, dims = realism_config()
    world, renderer = realism_world()
    t0 = time.time()
    frames = [renderer.render(k)[0] for k in range(N_FRAMES)]
    render_s = time.time() - t0
    sys_ = System(cfg, dims, enable_loop=True, pipeline=True, pg_thread=True, solve_async=True)
    init_at = watch_init(sys_.estimator, world.frame_times)
    t0 = time.time()
    out = drive(sys_, world, frames)
    drive_s = time.time() - t0
    print(json.dumps({
        "reference": "isvins_tpu System(solve_async=True) on the CPU, realism_bench.py's loop",
        "backend": jax.default_backend(), "init_frame": init_at[0] if init_at else None,
        **{k: out[k] for k in ("frames", "solved_poses", "keyframes", "loops_closed",
                               "loop_precision_vs_gt", "loop_rel_t_err_median_m",
                               "ate_se3_m_vio", "ate_se3_m_kf_vio", "ate_se3_m_loop_opt",
                               "first_solved_frame")},
        "steady_frames": len(out["frame_ms"]),
        "cpu_render_s": round(render_s, 1), "cpu_drive_s": round(drive_s, 1)}))


if __name__ == "__main__":
    main()
