"""Online camera-IMU extrinsic rotation calibration (hand-eye; torch port of
isvins_tpu/initial/ex_rotation.py, host f64 numpy).

Replaces InitialEXRotation (src/initial/initial_ex_rotation.cpp:11-66): per
frame pair, the camera rotation (from the essential matrix) and the IMU
preintegrated rotation constrain q_cam * q_ic = q_ic * q_imu; the stacked
quaternion-product-matrix system is solved by SVD with Huber-style angular
weights, accepted once the second-smallest singular value shows the
rotation is well-observed (frame_count >= Vo_SIZE && sigma[2] > 0.25).
Used only when estimate_extrinsic == 2 (estimator.cpp:139-153). The
quaternion conversions are the port's geom ops on f64 CPU tensors, the
reference's branchless forms.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..geom import mat_to_quat, quat_to_mat
from ..geom.hostmath import skew_np
from .five_point import solve_relative_pose


def _m2q(R):
    return mat_to_quat(torch.as_tensor(np.asarray(R, np.float64))).numpy()


def _q2m(q):
    return quat_to_mat(torch.as_tensor(np.asarray(q, np.float64))).numpy()


def _qleft_mat(q):
    """Eigen-vec-last-layout left-product matrix (x, y, z, w ordering like
    the reference's stacked system)."""
    w, x, y, z = q
    v = np.array([x, y, z])
    L = np.zeros((4, 4))
    L[:3, :3] = w * np.eye(3) + skew_np(v)
    L[:3, 3] = v
    L[3, :3] = -v
    L[3, 3] = w
    return L


def _qright_mat(q):
    w, x, y, z = q
    v = np.array([x, y, z])
    R = np.zeros((4, 4))
    R[:3, :3] = w * np.eye(3) - skew_np(v)
    R[:3, 3] = v
    R[3, :3] = -v
    R[3, 3] = w
    return R


class ExtrinsicRotationCalibrator:
    def __init__(self, vo_size: int = 8):
        self.vo_size = vo_size
        self.Rc: List[np.ndarray] = []
        self.Rimu: List[np.ndarray] = []
        self.ric = np.eye(3)
        self.last_S = np.zeros(4)  # singular values of the last stacked solve

    def push(self, corres_i, corres_j, delta_q_imu) -> Optional[np.ndarray]:
        """corres_*: (n, 2|3) normalized correspondences between consecutive
        frames; delta_q_imu: (4,) wxyz preintegrated rotation. Returns the
        calibrated R_ic once confident, else None."""
        R_imu = _q2m(np.asarray(delta_q_imu))
        ok, R_rel, _, _ = solve_relative_pose(corres_i, corres_j)
        if not ok:
            # fall back: pure rotation guess from the IMU via the current ric
            R_rel = self.ric.T @ R_imu @ self.ric
        # solve_relative_pose's R (pose of cam_j in cam_i) satisfies
        # R_c = R_ic^T R_imu R_ic directly: the hand-eye stack's R_c
        self.Rc.append(np.asarray(R_rel))
        self.Rimu.append(R_imu)

        n = len(self.Rc)
        A = np.zeros((4 * n, 4))
        for i in range(n):
            q_c = _m2q(self.Rc[i])
            # predicted camera rotation through the current extrinsic
            q_cg = _m2q(self.ric.T @ self.Rimu[i] @ self.ric)
            ang = 2 * np.degrees(np.arccos(np.clip(abs(float(np.dot(q_c, q_cg))), -1, 1)))
            huber = 5.0 / ang if ang > 5.0 else 1.0
            A[4 * i: 4 * i + 4] = huber * (_qleft_mat(q_c) - _qright_mat(_m2q(self.Rimu[i])))

        _, S, Vt = np.linalg.svd(A)
        self.last_S = S
        x = Vt[-1]  # (x, y, z, w) layout
        q_ic = np.array([x[3], x[0], x[1], x[2]])
        self.ric = _q2m(q_ic).T

        # ref gate: singularValues().tail<3>()(1) == S[2], the second-smallest
        # (initial_ex_rotation.cpp:60-63): accepts only once the rotation is
        # observed in all directions
        if n >= self.vo_size and S[2] > 0.25:
            return self.ric.copy()
        return None
