#!/usr/bin/env python3
"""The JAX package's whole pipeline with loops on at EuRoC's 752x480, on the
CPU: the reference run that chip_smoke.py's `system` phase holds the port to.

    JAX_PLATFORMS=cpu python3 system_reference.py

realism_bench.py's configuration (EuRoC cam0 with radtan distortion,
max_cnt 150, min_dist 25, 4 LK levels, CLAHE; window 18/8/1000, N = 3072;
the pose graph on with keyframe_min_dist 0.3, skip_recent 25,
min_loop_matches 15, max_keyframes 512, max_kp_per_kf 256), its world
(make_world(n_frames=200, ...), 1.4 laps) and RoomRenderer. The frames are
written as a EuRoC `mav0/` tree (utils.euroc_fixture) into a temporary
directory and replayed by the JAX package's `run_euroc.main`: the loader,
the native CSV parser, PNG decode, System(pipeline=True, pg_thread=True),
the TUM writers and ATE. Prints one JSON line with realism_bench.py's field
names (ATE and loop precision against the tree's ground-truth CSV) and the
frame whose packet the estimator initialized on (`sys_init_frame`), with how
long the render and the drive took.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_FRAMES = 200


def system_config():
    """realism_bench.py:47-64."""
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
        posegraph=PoseGraphConfig(enabled=True, keyframe_min_dist=0.3, skip_recent=25,
                                  min_loop_matches=15, max_keyframes=512, max_kp_per_kf=256),
        tic=(0.0, 0.0, 0.0), ric=R_bc)
    return cfg, WindowDims(B=18, Vo=8, F=1000, N=3072)


def loop_precision(db, gt):
    """realism_bench.py:173-187: a verified loop (cur -> old) is correct
    when its measured relative translation is within 30 cm of ground
    truth's."""
    from isvins_tpu.geom.hostmath import quat_to_mat_np

    n_loops = n_correct = 0
    for kf in range(db.n):
        old = int(db.loop_idx[kf])
        if old < 0:
            continue
        n_loops += 1
        gi = int(np.argmin(np.abs(gt["t"] - db.ts[kf])))
        gj = int(np.argmin(np.abs(gt["t"] - db.ts[old])))
        rel_t_gt = quat_to_mat_np(gt["q"][gj]).T @ (gt["p"][gi] - gt["p"][gj])
        n_correct += float(np.linalg.norm(rel_t_gt - db.loop_dt[kf])) < 0.30
    return n_loops, (n_correct / n_loops if n_loops else None)


def main():
    import run_euroc
    from isvins_tpu import native
    from isvins_tpu.data import EurocDataset
    from isvins_tpu.frontend import make_camera
    from isvins_tpu.geom.hostmath import mat_to_quat_np
    from isvins_tpu.system import System
    from isvins_tpu.utils.euroc_fixture import write_euroc_fixture
    from isvins_tpu.utils.evaluation import ate_rmse
    from isvins_tpu.utils.synthetic import RoomRenderer, make_world

    cfg, dims = system_config()
    world = make_world(n_frames=N_FRAMES, frame_hz=20.0, imu_hz=200.0, n_landmarks=10, seed=7,
                       traj_r=3.0, traj_w=0.9, noise_acc=0.02, noise_gyr=0.002,
                       ba=(0.02, -0.015, 0.01), bg=(0.002, -0.003, 0.004))
    renderer = RoomRenderer(world, cfg.camera, np.zeros(3), mat_to_quat_np(np.asarray(cfg.ric_np)),
                            seed=11, camera_model=make_camera(cfg.camera), tex_res=512)
    t0 = time.time()
    frames = [renderer.render(k)[0] for k in range(N_FRAMES)]
    render_s = time.time() - t0

    made, init_at = [], []
    init = System.__init__

    def capture(self, *a, **k):
        """Keep the driver's System, and note the frame whose packet was
        being processed when the estimator initialized (by packet, as
        chip_smoke._watch_init counts it)."""
        init(self, *a, **k)
        made.append(self)
        est, process_image = self.estimator, self.estimator.process_image

        def watched(ids, pts, t, vels=None):
            out = process_image(ids, pts, t, vels=vels)
            if not init_at and est.solver_flag == 2:
                init_at.append(int(np.argmin(np.abs(image_ts - t))))
            return out

        est.process_image = watched

    System.__init__ = capture
    try:
        with tempfile.TemporaryDirectory() as root:
            mav0 = write_euroc_fixture(root, world, frames)
            image_ts = np.array([m.t for m in EurocDataset(mav0).images])
            t0 = time.time()
            res = run_euroc.main([mav0, "--out-dir", os.path.join(root, "out")],
                                 cfg=cfg, dims=dims)
            drive_s = time.time() - t0
            gt = EurocDataset(mav0).ground_truth
    finally:
        System.__init__ = init
    sys_ = made[0]
    pg = sys_.pgbuilder
    db = pg.db
    traj = sys_.vio_trajectory
    t_est = np.array([t for (t, _, _) in traj])
    p_est = np.array([P for (_, P, _) in traj])
    ts_kf, t_opt, _ = pg.trajectory()
    n_loops, precision = loop_precision(db, gt)
    ate = lambda t, p: float(ate_rmse(t, p, gt["t"], gt["p"], align="se3"))
    print(json.dumps({
        "reference": "isvins_tpu run_euroc.main on the CPU", "backend": jax.default_backend(),
        "frames": res["n_frames"], "sys_init_frame": init_at[0] if init_at else None,
        "solved_poses": len(traj), "keyframes": int(db.n), "loops_closed": n_loops,
        "loop_precision_vs_gt": precision, "n_async_collects": int(pg.n_async_collects),
        "ate_se3_m_vio": ate(t_est, p_est), "ate_se3_m_kf_vio": ate(ts_kf, db.vio_t[: db.n]),
        "ate_se3_m_loop_opt": ate(ts_kf, t_opt),
        "csv_parser": "native" if native.available() else "numpy",
        "render_s": round(render_s, 1), "drive_s": round(drive_s, 1)}))


if __name__ == "__main__":
    main()
