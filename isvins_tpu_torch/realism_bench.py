"""Full-resolution realism run (port of realism_bench.py): 752x480 frames
with EuRoC's radtan intrinsics, CLAHE on, 20 Hz camera and 200 Hz IMU.

    python -m isvins_tpu_torch.realism_bench [n_frames] [--solve-async] [--device cpu] [--out PATH]

Renders a textured room through the distortion-aware camera model on a
1.4-lap trajectory (200 frames), then drives the whole System (tracker ->
estimator -> pose graph with loop closure; the tracker pipeline and the
pose-graph worker thread, and with `--solve-async` the steady solve on its
own stream across frames) at the reference's window (B=18/Vo=8/F=1000,
N=3072), and prints one JSON line with realism_bench.py's fields
(realism_bench.py:192-213), unrounded:

  - the tracker's time per frame (its dispatch and collect inside the
    frame, read from the frame thread's utils.perf phases `trk.dispatch`
    and `trk.collect`), the frame's time (its pub_imu calls and its
    pub_image, host clock, no synchronize()), median and p90, and their
    rates, over the frames after the estimator's first steady solve;
  - keyframes, verified loops and the share within 30 cm of ground truth's
    relative translation (`loop_precision_vs_gt`), their median error;
  - ATE (align="se3") of the VIO poses, of the keyframes' VIO poses and of
    the loop-optimized keyframes.

"backend" is the torch device type and the card's name. Runs on the CUDA
card unless `--device cpu`; writes a file only at `--out`. A failure raises:
the process exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

N_FRAMES = 200
# realism_bench.py:67-70: 1.4 laps at w = 0.9, so the revisit closes loops
# at full resolution; IMU noise and biases as EuRoC's
REALISM_WORLD = dict(frame_hz=20.0, imu_hz=200.0, n_landmarks=10, seed=7, traj_r=3.0,
                     traj_w=0.9, noise_acc=0.02, noise_gyr=0.002, ba=(0.02, -0.015, 0.01),
                     bg=(0.002, -0.003, 0.004))
FIELDS = ("metric", "backend", "frames", "window_shape", "solved_poses",
          "tracker_ms_per_frame_median", "pipeline_ms_per_frame_median",
          "pipeline_ms_per_frame_p90", "pipeline_fps", "tracking_fps", "keyframes",
          "loops_closed", "loop_precision_vs_gt", "loop_rel_t_err_median_m", "ate_se3_m_vio",
          "ate_se3_m_kf_vio", "ate_se3_m_loop_opt")


def _log(msg: str):
    print(f"# {msg}", file=sys.stderr, flush=True)


def realism_config(fused_ransac=None):
    """realism_bench.py:46-64: EuRoC cam0 at 752x480 with radtan
    distortion; TrackerConfig(max_cnt=150, min_dist=25, freq=100,
    lk_levels=4, lk_win=21, equalize=True, border=4); window 18/8/1000 with
    64 IMU samples a frame, N = 3072; its noise and excitation threshold
    0.08; the pose graph at 0.3 m, skip_recent 25, 15 loop matches, 512
    keyframes and 256 keypoints; the extrinsic R_bc. `fused_ransac` is the
    port's tracker option (None: the card's fused RANSAC)."""
    from .config import (CameraConfig, NoiseConfig, PoseGraphConfig, TrackerConfig,
                         WindowConfig, euroc_config)
    from .bench import PRODUCT_DIMS

    R_bc = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
    cfg = euroc_config().replace(
        camera=CameraConfig(),  # the defaults are EuRoC's cam0
        tracker=TrackerConfig(max_cnt=150, min_dist=25, freq=100, lk_levels=4, lk_win=21,
                              equalize=True, border=4, fused_ransac=fused_ransac),
        window=WindowConfig(vo_size=8, all_size=18, max_features=1000, max_imu_per_frame=64),
        noise=NoiseConfig(acc_n=0.02, gyr_n=0.002, acc_w=1e-4, gyr_w=1e-5, pixel_sqrt_info=460.0),
        solver=euroc_config().solver.__class__(excitation_threshold=0.08),
        posegraph=PoseGraphConfig(enabled=True, keyframe_min_dist=0.3, skip_recent=25,
                                  min_loop_matches=15, max_keyframes=512, max_kp_per_kf=256),
        tic=(0.0, 0.0, 0.0), ric=R_bc)
    return cfg, PRODUCT_DIMS


def realism_world(n_frames: int = N_FRAMES):
    """realism_bench.py:66-74's world (REALISM_WORLD) and its RoomRenderer
    (textures seeded 11 at tex_res 512, the camera's radtan model):
    (world, renderer)."""
    from .frontend import make_camera
    from .geom.hostmath import mat_to_quat_np
    from .utils.synthetic import RoomRenderer, make_world

    cfg, _ = realism_config()
    world = make_world(n_frames=n_frames, **REALISM_WORLD)
    return world, RoomRenderer(world, cfg.camera, np.zeros(3),
                               mat_to_quat_np(np.asarray(cfg.ric_np)), seed=11,
                               camera_model=make_camera(cfg.camera), tex_res=512)


def _render_share(n_frames, ks):
    renderer = realism_world(n_frames)[1]
    return [renderer.render(k)[0] for k in ks]


def render_frames(n_frames: int = N_FRAMES):
    """realism_world(n_frames)'s frames, rendered in memory by
    utils.synthetic.RENDER_PROCS processes."""
    from .utils.synthetic import render_in_processes

    return render_in_processes(_render_share, n_frames, n_frames)


def drive_realism(system, world, frames) -> dict:
    """realism_bench.py:124-213 over `frames` through a built System:
    wait_pg_ready(), then per frame the pub_imu calls before it and its
    pub_image (flush() on the last). From the third frame on each frame's
    wall time and its tracker time (the frame thread's `trk.dispatch` +
    `trk.collect` inside it) are kept; both lists restart at the first frame
    after whose pub_image the estimator is NON_LINEAR. Returns
    realism_bench.py's fields (FIELDS, unrounded), and for callers that hold
    or break them down: the VIO trajectory, the keyframes' timestamps, the
    per-frame times (`frame_ms`, `tracker_ms`) and whether the pose-graph
    worker added a keyframe during each (`worker_kf`), the frame index of
    the first steady solve and utils.perf's phases over the steady frames."""
    import torch

    from .estimator.estimator import NON_LINEAR
    from .geom.hostmath import quat_to_mat_np
    from .utils import perf
    from .utils.evaluation import ate_rmse

    system.wait_pg_ready()
    n_frames = len(frames)
    t_track, t_frame, worker_kf, first_solved = [], [], [], None
    db = system.pgbuilder.db
    perf.reset()
    perf.enable(True)
    try:
        for k in range(n_frames):
            ta = time.perf_counter()
            trk0, kf0 = perf.thread_total_s("trk.dispatch", "trk.collect"), db.n
            if k > 0:
                acc_t = world.frame_times[k - 1]
                for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                    acc_t += world.imu_dts[k - 1][s]
                    system.pub_imu(acc_t, world.imu_accs[k - 1][s], world.imu_gyrs[k - 1][s])
            system.pub_image(world.frame_times[k], frames[k])
            if k == n_frames - 1:
                system.flush()
            tc = time.perf_counter()
            if k % 20 == 0:
                _log(f"frame {k}/{n_frames} flag={system.estimator.solver_flag} kfs={db.n} "
                     f"loops={system.pgbuilder.n_loops}")
            if k >= 2:
                t_track.append(perf.thread_total_s("trk.dispatch", "trk.collect") - trk0)
                t_frame.append(tc - ta)
                # read while the worker may be writing: a keyframe counted a
                # frame late only moves a frame between the two groups
                worker_kf.append(db.n > kf0)
            if first_solved is None and system.estimator.solver_flag == NON_LINEAR:
                first_solved = k
                t_track.clear()
                t_frame.clear()
                worker_kf.clear()
                perf.reset()  # attribute only the steady frames
        phases = perf.stats()
    finally:
        perf.enable(False)

    traj = system.vio_trajectory
    ate = lambda t, p: float(ate_rmse(t, p, world.frame_times, world.P, align="se3"))
    rmse = ate(np.array([t for t, _, _ in traj]),
               np.array([P for _, P, _ in traj])) if len(traj) >= 10 else None
    n_kf = int(db.n)
    ts_kf, t_opt, _ = system.pgbuilder.trajectory()
    rmse_opt = ate(ts_kf, t_opt) if n_kf >= 10 else None
    rmse_kf_vio = ate(ts_kf, db.vio_t[:n_kf]) if n_kf >= 10 else None
    # a verified loop (cur -> old) is correct when its measured relative
    # translation is within 30 cm of ground truth's
    n_loops = n_correct = 0
    loop_t_errs = []
    for kf in range(n_kf):
        old = int(db.loop_idx[kf])
        if old < 0:
            continue
        n_loops += 1
        gi = int(np.argmin(np.abs(world.frame_times - db.ts[kf])))
        gj = int(np.argmin(np.abs(world.frame_times - db.ts[old])))
        rel_t_gt = quat_to_mat_np(world.Q[gj]).T @ (world.P[gi] - world.P[gj])
        loop_t_errs.append(float(np.linalg.norm(rel_t_gt - db.loop_dt[kf])))
        n_correct += loop_t_errs[-1] < 0.30
    track_ms = float(np.median(t_track) * 1e3) if t_track else None
    frame_ms = float(np.median(t_frame) * 1e3) if t_frame else None
    dims = system.estimator.dims
    return {
        "metric": "realism_752x480_radtan_clahe_loops",
        "backend": (f"cuda ({torch.cuda.get_device_name(system.device)})"
                    if system.device.type == "cuda" else system.device.type),
        "frames": n_frames,
        "window_shape": f"B={dims.B}/Vo={dims.Vo}/F={dims.F}/N={dims.N} "
                        "(reference parameters.h:35-40)",
        "solved_poses": len(traj),
        "tracker_ms_per_frame_median": track_ms,
        "pipeline_ms_per_frame_median": frame_ms,
        "pipeline_ms_per_frame_p90": float(np.percentile(t_frame, 90) * 1e3) if t_frame else None,
        "pipeline_fps": 1e3 / frame_ms if frame_ms else None,
        "tracking_fps": 1e3 / track_ms if track_ms else None,
        "keyframes": n_kf,
        "loops_closed": n_loops,
        "loop_precision_vs_gt": n_correct / n_loops if n_loops else None,
        "loop_rel_t_err_median_m": float(np.median(loop_t_errs)) if loop_t_errs else None,
        "ate_se3_m_vio": rmse,
        "ate_se3_m_kf_vio": rmse_kf_vio,
        "ate_se3_m_loop_opt": rmse_opt,
        "trajectory": list(traj), "keyframe_ts": np.array(db.ts[:n_kf]),
        "frame_ms": [t * 1e3 for t in t_frame], "tracker_ms": [t * 1e3 for t in t_track],
        "worker_kf": worker_kf, "first_solved_frame": first_solved, "phases": phases,
    }


def bench_realism(device=None, solve_async: bool = False, frames=None, n_frames=N_FRAMES):
    """realism_config() on realism_world(n_frames) (`frames`: its rendered
    frames, rendered here when None) through System(enable_loop=True,
    pipeline=True, pg_thread=True, solve_async=solve_async):
    drive_realism's result, plus the closed System under "system"."""
    from .system import System
    from .utils.synthetic import RENDER_PROCS

    cfg, dims = realism_config()
    world, _ = realism_world(n_frames)
    if frames is None:
        _log(f"rendering {n_frames} frames at {cfg.camera.width}x{cfg.camera.height} with "
             f"radtan distortion in {RENDER_PROCS} processes...")
        t0 = time.perf_counter()
        frames = render_frames(n_frames)
        _log(f"rendered in {time.perf_counter() - t0:.1f} s")
    sys_ = System(cfg, dims, enable_loop=True, pipeline=True, pg_thread=True,
                  solve_async=solve_async, device=device)
    try:
        out = drive_realism(sys_, world, frames)
    finally:
        sys_.close()
    out["system"] = sys_
    return out


def main(n_frames: int = N_FRAMES, out_path=None, device=None, solve_async: bool = False):
    """The run at n_frames: prints the FIELDS as one JSON line, writes them
    to `out_path` when given, and returns them."""
    res = bench_realism(device, solve_async=solve_async, n_frames=n_frames)
    out = {k: res[k] for k in FIELDS}
    print(json.dumps(out), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    return out


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=N_FRAMES)
    ap.add_argument("--solve-async", action="store_true",
                    help="the steady solve on its own stream across frames")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="also write the JSON object to this path")
    args = ap.parse_args(argv)
    return main(args.n_frames, args.out, args.device, args.solve_async)


if __name__ == "__main__":
    cli()
