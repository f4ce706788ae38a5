"""EuRoC replay driver of the port (replaces test/run_euroc.cpp, without its
real-time throttle sleeps).

    python -m isvins_tpu_torch.run_euroc PATH_TO_SEQUENCE/mav0 [--out-dir OUT]
        [--no-loop] [--max-frames N] [--device cpu]

Writes pose_output.txt (VIO, TUM format), loop_pose_output.txt (the
optimized keyframe trajectory) and loop_cov_output.txt (per-keyframe 6x6
covariances; with matplotlib also loop_cov_ellipses.png), and prints the
ATE RMSE against ground truth when the sequence ships
state_groundtruth_estimate0. Runs on the CUDA card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None, cfg=None, dims=None):
    """Replay a mav0 sequence. `cfg` and `dims` override the EuRoC
    configuration (a fixture rendered at another resolution); the command
    line always runs euroc_config(). Returns a result dict (n_frames,
    n_vio_poses, n_keyframes, ate_rmse when ground truth is present, output
    paths)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("mav0", help="path to the sequence's mav0 directory")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from .config import euroc_config
    from .data import EurocDataset
    from .system import System
    from .utils.evaluation import ate_rmse

    cfg = cfg or euroc_config()
    # the production threading topology: the tracker's dispatch pipeline
    # and the pose-graph worker thread; the cross-frame solve pipeline off
    sys_ = System(cfg, dims, enable_loop=not args.no_loop, pipeline=True, pg_thread=True,
                  device=args.device)
    try:
        sys_.wait_pg_ready()  # the worker's prewarm ends before the replay starts
        ds = EurocDataset(args.mav0)
        t0 = time.time()
        n_img = 0
        for kind, m in ds.stream():
            if kind == "imu":
                sys_.pub_imu(m.t, m.acc, m.gyr)
            else:
                sys_.pub_image(m.t, m.load())
                n_img += 1
                if args.max_frames and n_img >= args.max_frames:
                    break
                if n_img % 100 == 0:
                    el = time.time() - t0
                    print(f"[{n_img} frames, {el:.1f}s, {n_img / el:.1f} fps]", flush=True)
        sys_.flush()

        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "pose_output.txt"), "w") as f:
            f.write(sys_.vio_tum())
        with open(os.path.join(args.out_dir, "loop_pose_output.txt"), "w") as f:
            f.write(sys_.loop_tum())
        # per-keyframe 6x6 covariances and the offline ellipse plot (the
        # reference's live Pangolin ellipses, pose_graph_builder.cpp:272-301)
        if sys_.pgbuilder is not None and sys_.pgbuilder.db.n > 0:
            with open(os.path.join(args.out_dir, "loop_cov_output.txt"), "w") as f:
                f.write(sys_.covariance_tum())
            try:
                from .utils.visualization import plot_covariance_ellipses

                ts, t_opt, cov = sys_.pgbuilder.covariances()
                plot_covariance_ellipses(ts, t_opt, cov,
                                         os.path.join(args.out_dir, "loop_cov_ellipses.png"))
            except ImportError as e:  # matplotlib is optional
                print(f"covariance plot skipped: {e}")
    finally:
        sys_.close()

    rmse = None
    if ds.ground_truth is not None and sys_.vio_trajectory:
        traj = np.array([[t, *P] for (t, P, Q) in sys_.vio_trajectory])
        rmse = ate_rmse(traj[:, 0], traj[:, 1:4], ds.ground_truth["t"], ds.ground_truth["p"])
        print(f"ATE RMSE (SE3-aligned): {rmse:.4f} m over {len(traj)} poses")
    return {
        "n_frames": n_img,
        "n_vio_poses": len(sys_.vio_trajectory),
        "n_keyframes": (sys_.pgbuilder.db.n if sys_.pgbuilder else 0),
        "ate_rmse": rmse,
        "pose_output": os.path.join(args.out_dir, "pose_output.txt"),
        "loop_pose_output": os.path.join(args.out_dir, "loop_pose_output.txt"),
    }


if __name__ == "__main__":
    main()
