"""Estimator snapshots (port of isvins_tpu/utils/checkpoint.py
`load_estimator`). The npz written by the JAX package's `save_estimator` is
the contract: its keys are read unchanged, so a JAX run can be resumed by
the port. Saving and the pose-graph snapshot are not ported yet."""

from __future__ import annotations

import numpy as np


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
