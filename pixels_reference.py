#!/usr/bin/env python3
"""The JAX package's pixels-to-poses drive at EuRoC's 752x480, on the CPU:
the reference run that chip_smoke.py's `pixels` phase holds the port to.

    JAX_PLATFORMS=cpu python3 pixels_reference.py

realism_bench.py's full-resolution configuration (EuRoC cam0 with radtan
distortion, max_cnt 150, min_dist 25, 4 LK levels, CLAHE; window
18/8/1000, N = 3072; its noise, world and RoomRenderer), cut to
N_FRAMES = 60 frames (chip_smoke.py's PIXELS_FRAMES), with the pose graph
off and no ground-truth hook: the estimator self-initializes. Frames are
rendered before the drive, which goes through System(cfg, dims,
enable_loop=False). Prints one JSON line: the frame at which
initialization succeeded (`pix_init_frame`), the solved poses,
`ate_rmse(align="se3")` of them against ground truth, and the
median count of features published per frame.
"""

from __future__ import annotations

import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

N_FRAMES = 60


def pixels_config():
    """realism_bench.py:47-74 with the pose graph off."""
    from isvins_tpu.config import (CameraConfig, NoiseConfig, PoseGraphConfig, TrackerConfig,
                                   WindowConfig, euroc_config)
    from isvins_tpu.solver import WindowDims

    R_bc = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
    cfg = euroc_config().replace(
        camera=CameraConfig(),
        tracker=TrackerConfig(max_cnt=150, min_dist=25, freq=100, lk_levels=4,
                              lk_win=21, equalize=True, border=4),
        window=WindowConfig(vo_size=8, all_size=18, max_features=1000, max_imu_per_frame=64),
        noise=NoiseConfig(acc_n=0.02, gyr_n=0.002, acc_w=1e-4, gyr_w=1e-5,
                          pixel_sqrt_info=460.0),
        solver=euroc_config().solver.__class__(excitation_threshold=0.08),
        posegraph=PoseGraphConfig(enabled=False),
        tic=(0.0, 0.0, 0.0), ric=R_bc)
    return cfg, WindowDims(B=18, Vo=8, F=1000, N=3072)


def main():
    from isvins_tpu.frontend import make_camera
    from isvins_tpu.frontend.tracker import FeatureTracker
    from isvins_tpu.geom.hostmath import mat_to_quat_np
    from isvins_tpu.system import System
    from isvins_tpu.utils.evaluation import ate_rmse
    from isvins_tpu.utils.synthetic import RoomRenderer, make_world

    cfg, dims = pixels_config()
    world = make_world(n_frames=N_FRAMES, frame_hz=20.0, imu_hz=200.0, n_landmarks=10, seed=7,
                       traj_r=3.0, traj_w=0.9, noise_acc=0.02, noise_gyr=0.002,
                       ba=(0.02, -0.015, 0.01), bg=(0.002, -0.003, 0.004))
    qic = mat_to_quat_np(np.asarray(cfg.ric_np))
    renderer = RoomRenderer(world, cfg.camera, np.zeros(3), qic, seed=11,
                            camera_model=make_camera(cfg.camera), tex_res=512)
    t0 = time.time()
    frames = [renderer.render(k)[0] for k in range(N_FRAMES)]
    render_s = time.time() - t0

    published = []
    read_image = FeatureTracker.read_image

    def counted(self, img, t):
        out = read_image(self, img, t)
        published.append(int((out["track_cnt"] > 1).sum()))
        return out

    FeatureTracker.read_image = counted
    sys_ = System(cfg, dims, enable_loop=False)
    init_frame = None
    t0 = time.time()
    try:
        for k in range(N_FRAMES):
            if k > 0:
                acc_t = world.frame_times[k - 1]
                for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                    acc_t += world.imu_dts[k - 1][s]
                    sys_.pub_imu(acc_t, world.imu_accs[k - 1][s], world.imu_gyrs[k - 1][s])
            sys_.pub_image(world.frame_times[k], frames[k])
            if init_frame is None and sys_.estimator.solver_flag == 2:
                init_frame = k
        sys_.flush()
    finally:
        FeatureTracker.read_image = read_image
    traj = sys_.vio_trajectory
    t_est = np.array([t for (t, _, _) in traj])
    p_est = np.array([P for (_, P, _) in traj])
    ate = float(ate_rmse(t_est, p_est, world.frame_times, world.P, align="se3")) \
        if len(traj) >= 3 else None
    print(json.dumps({
        "reference": "isvins_tpu System on the CPU", "backend": jax.default_backend(),
        "frames": N_FRAMES, "pix_init_frame": init_frame, "solved_poses": len(traj),
        "pix_ate_vio_m": ate, "pix_tracks_median": float(np.median(published[1:])),
        "failure_count": int(sys_.estimator.failure_count),
        "render_s": round(render_s, 1), "drive_s": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    main()
