"""Snapshots of the pose graph and of the estimator (port of
isvins_tpu/utils/checkpoint.py): flat npz files of the keyframe database
(its SoA arrays, loop edges, descriptors and bag-of-words state) and of the
estimator's window state and prior set, so that a session can resume or
relocalize against a prior map. The keys are the JAX package's: each
package loads the other's files.

Two faults of the reference are not copied. `save_estimator` collects a
pending async solve before the pending marginalization (the reference
quiesces only the latter, so a snapshot taken between a dispatch and its
collect lost the frame's solve). `save_pose_graph` completes the
amortized bag-of-words backfill on copies of `tf` and `df`, leaving the
live database as it was (the reference ran `flush_bow()` on the database
itself, which a pose-graph worker thread may be writing).
"""

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


def save_pose_graph(db, path: str):
    """Write the keyframe database to `path` (npz). Reads the database and
    writes nothing to it; a System running its pose graph on a worker
    (`pg_thread=True`) is saved after `System.wait_pg_ready()`, when the
    worker is idle."""
    n = db.n
    tf, df = db.flushed_bow()
    arrays = {f: getattr(db, f)[:n] for f in _DB_FIELDS}
    np.savez_compressed(path, n=n, K=db.K, D=db.D, P=db.P, tf=tf[:n], df=df, vocab=db.vocab,
                        vocab_frozen=db.vocab_frozen, **arrays)


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


def save_estimator(est, path: str):
    """Write the estimator's state to `path` (npz). A pending async solve is
    collected first, then a pending marginalization, so the snapshot holds
    the slid window and its post-slide priors (a pending future cannot be
    serialized, and dropping it would fork the resumed trajectory)."""
    est.collect_solve()
    est.collect_marg()
    pr = est.priors
    prior_arrays = {}
    if pr is not None:
        prior_arrays = {
            "pr_se3_t": pr.se3_t, "pr_se3_q": pr.se3_q, "pr_se3_sqrt": pr.se3_sqrt,
            "pr_se3_valid": pr.se3_valid, "pr_vb": pr.vb, "pr_vb_sqrt": pr.vb_sqrt,
            "pr_vb_valid": pr.vb_valid, "pr_rel_dt": pr.rel_dt, "pr_rel_dq": pr.rel_dq,
            "pr_rel_sqrt": pr.rel_sqrt, "pr_rel_valid": pr.rel_valid,
            "pr_rp_q": pr.rp.q_meas, "pr_rp_sqrt": pr.rp.sqrt_info,
            "pr_rp_idx": pr.rp.idx, "pr_rp_valid": pr.rp.valid,
        }
        prior_arrays = {k: np.asarray(v) for k, v in prior_arrays.items()}
    fm = est.f_manager
    np.savez_compressed(
        path,
        Ps=est.Ps, Qs=est.Qs, Vs=est.Vs, Bas=est.Bas, Bgs=est.Bgs,
        Headers=est.Headers, tic=est.tic, qic=est.qic,
        imu_dt=est.imu_dt, imu_acc=est.imu_acc, imu_gyr=est.imu_gyr,
        imu_acc0=est.imu_acc0, imu_gyr0=est.imu_gyr0, imu_cnt=est.imu_cnt,
        imu_overflow=est.imu_overflow,
        frame_count=est.frame_count, solver_flag=est.solver_flag,
        acc_0=est.acc_0, gyr_0=est.gyr_0, first_imu=est.first_imu,
        marginalization_flag=est.marginalization_flag,
        has_priors=pr is not None,
        fm_ids=fm.ids, fm_start=fm.start, fm_obs=fm.obs, fm_vel=fm.vel,
        fm_has_obs=fm.has_obs, fm_depth=fm.depth, fm_solve_flag=fm.solve_flag,
        fm_outlier=fm.outlier,
        **prior_arrays,
    )


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
