"""Snapshots (port of isvins_tpu/utils/checkpoint.py `load_estimator` and
`load_pose_graph`). The npz files written by the JAX package's
`save_estimator` and `save_pose_graph` are the contract: their keys are
read unchanged, so a JAX run or map can be resumed by the port. Saving is
not ported yet."""

from __future__ import annotations

import numpy as np

_DB_FIELDS = [
    "ts", "seq", "vio_t", "vio_q", "opt_t", "opt_q", "cov",
    "edge_dt", "edge_dq", "edge_sqrt", "edge_valid",
    "rp_q", "rp_sqrt", "rp_valid",
    "loop_idx", "loop_dt", "loop_dq", "loop_weight",
    "kp_desc", "kp_norm", "kp_valid",
    "win_pts3d", "win_desc", "win_valid",
    "ret_desc", "ret_valid",
]


def load_pose_graph(path: str, capacity: int = 0, device=None):
    """A KeyframeDB on `device` (None: the CUDA card) from a pose-graph snapshot. The BoW state
    is restored when the snapshot has it (older ones re-freeze the
    vocabulary from the loaded keyframes on the next adds); the snapshot's
    vocabulary width wins."""
    from ..device import resolve_device
    from ..posegraph.keyframe_db import KeyframeDB

    device = resolve_device(device)
    z = np.load(path, allow_pickle=False)
    n = int(z["n"])
    db = KeyframeDB(max(int(z["K"]), capacity), int(z["D"]), int(z["P"]), device=device)
    for f in _DB_FIELDS:
        getattr(db, f)[:n] = z[f]
    for i in range(n):
        db.sync_ret_row(i)
    if "vocab" in z.files:
        db.vocab = np.array(z["vocab"])
        db.W = db.vocab.shape[0]
        db.vocab_frozen = bool(z["vocab_frozen"])
        db.df = np.array(z["df"])
        db.tf = np.zeros((db.K, db.W), np.float32)
        db.tf[:n] = z["tf"]
        db._wg_centers = None  # the 2-level word index rebuilds lazily
    db.n = n
    return db


def load_estimator(est, path: str):
    """Restore a snapshot into an Estimator constructed with the same config.
    Host state stays f64 numpy; priors are restored as host numpy trees."""
    from ..solver import PriorState, RollPitchFactors

    z = np.load(path, allow_pickle=False)
    for name in ["Ps", "Qs", "Vs", "Bas", "Bgs", "Headers", "tic", "qic",
                 "imu_dt", "imu_acc", "imu_gyr", "imu_acc0", "imu_gyr0", "imu_cnt"]:
        setattr(est, name, np.array(z[name]))  # fresh writable arrays
    if "imu_overflow" in z.files:
        est.imu_overflow = np.array(z["imu_overflow"])
    est.frame_count = int(z["frame_count"])
    est.solver_flag = int(z["solver_flag"])
    est.acc_0 = np.array(z["acc_0"])
    est.gyr_0 = np.array(z["gyr_0"])
    est.first_imu = bool(z["first_imu"])
    est.marginalization_flag = int(z["marginalization_flag"])
    fm = est.f_manager
    for src, dst in [("fm_ids", "ids"), ("fm_start", "start"), ("fm_obs", "obs"),
                     ("fm_vel", "vel"), ("fm_has_obs", "has_obs"),
                     ("fm_depth", "depth"), ("fm_solve_flag", "solve_flag"),
                     ("fm_outlier", "outlier")]:
        getattr(fm, dst)[:] = z[src]
    if bool(z["has_priors"]):
        a = lambda k: np.array(z[k])
        est.priors = PriorState(
            se3_t=a("pr_se3_t"), se3_q=a("pr_se3_q"), se3_sqrt=a("pr_se3_sqrt"),
            se3_valid=np.asarray(bool(z["pr_se3_valid"])),
            vb=a("pr_vb"), vb_sqrt=a("pr_vb_sqrt"),
            vb_valid=np.asarray(bool(z["pr_vb_valid"])),
            rel_dt=a("pr_rel_dt"), rel_dq=a("pr_rel_dq"), rel_sqrt=a("pr_rel_sqrt"),
            rel_valid=a("pr_rel_valid"),
            rp=RollPitchFactors(q_meas=a("pr_rp_q"), sqrt_info=a("pr_rp_sqrt"),
                                idx=a("pr_rp_idx"), valid=a("pr_rp_valid")),
        )
    return est
