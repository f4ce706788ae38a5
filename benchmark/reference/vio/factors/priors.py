"""Sparse nonlinear prior (pseudo-measurement) factors of the IS scheme
(torch port of isvins_tpu/factors/priors.py): relative pose, SE3 absolute,
speed/bias, roll-pitch and yaw (yaw only for information accounting). All
functions broadcast over leading dims and are unweighted. The `*_np`
drags run per frame on the host state machine, in f64 numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_const
from ..geom import (
    quat_conj,
    quat_log,
    quat_mul,
    quat_rotate,
    quat_to_mat,
    right_jacobian_inv_so3,
    skew,
)
from ..geom.hostmath import quat_conj_np, quat_mul_np, quat_normalize_np, quat_to_mat_np


def _blocks(rows):
    """[[(...,a,b) ...] ...] -> (..., sum a, sum b)."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


# ---------------------------------------------------------------- relative pose
def relpose_residual(delta_t, delta_q, Pi, Qi, Pj, Qj):
    """(...,6) [delta_t - Ri^T (Pj - Pi); Log(delta_R Rj^T Ri)]."""
    res_t = delta_t - quat_rotate(quat_conj(Qi), Pj - Pi)
    res_q = quat_log(quat_mul(delta_q, quat_mul(quat_conj(Qj), Qi)))
    return torch.cat([res_t, res_q], dim=-1)


def relpose_residual_jacobians(delta_t, delta_q, Pi, Qi, Pj, Qj):
    """Residual + (...,6,6) Jacobians wrt pose_i, pose_j
    (relative_pose_factor.h:46–66)."""
    r = relpose_residual(delta_t, delta_q, Pi, Qi, Pj, Qj)
    phi = r[..., 3:]
    RiT = quat_to_mat(Qi).transpose(-1, -2)
    Rj = quat_to_mat(Qj)
    Jinv = right_jacobian_inv_so3(phi)
    Z = torch.zeros_like(RiT)
    J_i = _blocks([[RiT, -skew(quat_rotate(quat_conj(Qi), Pj - Pi))], [Z, Jinv]])
    J_j = _blocks([[-RiT, Z], [Z, -Jinv @ RiT @ Rj]])
    return r, J_i, J_j


# ---------------------------------------------------------------- SE3 prior
def se3_prior_residual(t_meas, q_meas, Pi, Qi):
    """(...,6) [Pi - t; Log(R_meas^{-1} Ri)]."""
    res_r = quat_log(quat_mul(quat_conj(q_meas), Qi))
    return torch.cat([Pi - t_meas, res_r], dim=-1)


def se3_prior_residual_jacobians(t_meas, q_meas, Pi, Qi):
    r = se3_prior_residual(t_meas, q_meas, Pi, Qi)
    Jinv = right_jacobian_inv_so3(r[..., 3:])
    I3 = torch.eye(3, dtype=Pi.dtype, device=Pi.device).expand(Jinv.shape)
    Z = torch.zeros_like(Jinv)
    return r, _blocks([[I3, Z], [Z, Jinv]])


# ---------------------------------------------------------------- speed/bias
def linear9_residual_jacobians(vb_meas, V, Ba, Bg):
    """(...,9) residual [V;Ba;Bg] - meas, identity Jacobian."""
    r = torch.cat([V, Ba, Bg], dim=-1) - vb_meas
    return r, torch.eye(9, dtype=V.dtype, device=V.device).expand(r.shape + (9,))


# ---------------------------------------------------------------- roll-pitch
def _nz(Qi):
    return device_const([0.0, 0.0, -1.0], Qi.dtype, Qi.device).expand(
        Qi.shape[:-1] + (3,))


def rollpitch_residual(q_meas, Qi):
    """(...,2) first two rows of R_meas Ri^T (-e_z)."""
    return quat_rotate(q_meas, quat_rotate(quat_conj(Qi), _nz(Qi)))[..., :2]


def rollpitch_residual_jacobians(q_meas, Qi):
    res3 = quat_rotate(q_meas, quat_rotate(quat_conj(Qi), _nz(Qi)))
    J_rot = skew(res3) @ quat_to_mat(q_meas)
    J = torch.cat([torch.zeros_like(J_rot[..., :2, :]), J_rot[..., :2, :]], dim=-1)
    return res3[..., :2], J


# ---------------------------------------------------------------- yaw
def yaw_residual_jacobians(q_meas, Qi):
    """(...,1) y-component of Ri (R_meas^{-1} e_x); information accounting
    only during backward sparsification."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=Qi.dtype, device=Qi.device).expand(
        Qi.shape[:-1] + (3,))
    yaw_meas = quat_rotate(quat_conj(q_meas), ex)
    res3 = quat_rotate(Qi, yaw_meas)
    J_rot = -quat_to_mat(Qi) @ skew(yaw_meas)
    J = torch.cat([torch.zeros_like(J_rot[..., 1:2, :]), J_rot[..., 1:2, :]], dim=-1)
    return res3[..., 1:2], J


# -------------------------------------------------- numpy host-path drags
def relpose_update_np(delta_t, delta_q, ti, Ri_q, tj, Rj_q,
                      Pi_new, Qi_new, Pj_new, Qj_new):
    """Exact residual-preserving drag of a relative-pose measurement from the
    old states to the post-solve states (see the JAX reference's note on the
    deviation from the research code's first-order form)."""
    Ri = quat_to_mat_np(Ri_q)
    r_t = np.asarray(delta_t) - Ri.T @ (np.asarray(tj) - np.asarray(ti))
    r_q = quat_mul_np(delta_q, quat_mul_np(quat_conj_np(np.asarray(Rj_q)), Ri_q))
    Qi_new = np.asarray(Qi_new)
    delta_t_new = r_t + quat_to_mat_np(Qi_new).T @ (np.asarray(Pj_new) - np.asarray(Pi_new))
    delta_q_new = quat_normalize_np(
        quat_mul_np(r_q, quat_mul_np(quat_conj_np(Qi_new), np.asarray(Qj_new)))
    )
    return delta_t_new, delta_q_new


def relpose_update_anchor_np(delta_t, delta_q, ti, Ri_q, tj, Rj_q, Pj_new, Qj_new):
    """The drag with frame i held at (ti, Ri_q) and only frame j moved, as
    when a pose-graph edge is re-anchored (relative_pose_factor.h:119-124)."""
    return relpose_update_np(delta_t, delta_q, ti, Ri_q, tj, Rj_q, ti, Ri_q, Pj_new, Qj_new)


def se3_prior_update_np(t_meas, q_meas, Pi_old, Qi_old, Pi_new, Qi_new):
    r_t = np.asarray(Pi_old) - np.asarray(t_meas)
    r_q = quat_mul_np(quat_conj_np(np.asarray(q_meas)), np.asarray(Qi_old))
    t_new = np.asarray(Pi_new) - r_t
    q_new = quat_normalize_np(quat_mul_np(np.asarray(Qi_new), quat_conj_np(r_q)))
    return t_new, q_new


def rollpitch_update_np(q_meas, Qi_old, Qi_new):
    d = quat_mul_np(quat_conj_np(np.asarray(Qi_old)), np.asarray(Qi_new))
    return quat_normalize_np(quat_mul_np(np.asarray(q_meas), d))
