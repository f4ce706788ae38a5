"""Inverse-depth reprojection factor i -> j through the IMU-camera extrinsic
(torch port of isvins_tpu/factors/projection.py; projection_factor.cpp:24–122).

Unweighted; the solver applies the pixel sqrt-info and the Cauchy weight.
Every function broadcasts over a leading observation dimension.
"""

from __future__ import annotations

import torch

from ..geom import quat_conj, quat_rotate, quat_to_mat, skew


def _safe_depth(d, eps=1e-6):
    """Sign-preserving clamp away from zero (large finite residual, not NaN,
    for a landmark crossing the camera plane during a trial step)."""
    return torch.where(d.abs() > eps, d,
                       torch.where(d >= 0, torch.full_like(d, eps), torch.full_like(d, -eps)))


def _chain(pts_i, Pi, Qi, Pj, Qj, tic, qic, inv_dep_i):
    pts_cam_i = pts_i / inv_dep_i[..., None]
    pts_imu_i = quat_rotate(qic, pts_cam_i) + tic
    pts_w = quat_rotate(Qi, pts_imu_i) + Pi
    pts_imu_j = quat_rotate(quat_conj(Qj), pts_w - Pj)
    pts_cam_j = quat_rotate(quat_conj(qic), pts_imu_j - tic)
    return pts_cam_i, pts_imu_i, pts_imu_j, pts_cam_j


def projection_residual(pts_i, pts_j, Pi, Qi, Pj, Qj, tic, qic, inv_dep_i):
    """pts_i, pts_j: (...,3) normalized bearings; returns (...,2)."""
    *_, pts_cam_j = _chain(pts_i, Pi, Qi, Pj, Qj, tic, qic, inv_dep_i)
    dep_j = _safe_depth(pts_cam_j[..., 2])
    return pts_cam_j[..., :2] / dep_j[..., None] - pts_j[..., :2]


def projection_residual_jacobians(pts_i, pts_j, Pi, Qi, Pj, Qj, tic, qic, inv_dep_i):
    """Residual (...,2) + minimal Jacobians wrt pose_i (...,2,6), pose_j
    (...,2,6), extrinsic (...,2,6), inverse depth (...,2)
    (projection_factor.cpp:54–118)."""
    pts_cam_i, pts_imu_i, pts_imu_j, pts_cam_j = _chain(
        pts_i, Pi, Qi, Pj, Qj, tic, qic, inv_dep_i)
    dep_j = _safe_depth(pts_cam_j[..., 2])
    r = pts_cam_j[..., :2] / dep_j[..., None] - pts_j[..., :2]

    Ri = quat_to_mat(Qi)
    Rj = quat_to_mat(Qj)
    ric = quat_to_mat(qic)
    ricT = ric.transpose(-1, -2)
    RjT = Rj.transpose(-1, -2)

    zero = torch.zeros_like(dep_j)
    inv = 1.0 / dep_j
    reduce = torch.stack([
        torch.stack([inv, zero, -pts_cam_j[..., 0] * inv * inv], -1),
        torch.stack([zero, inv, -pts_cam_j[..., 1] * inv * inv], -1),
    ], -2)  # (...,2,3)

    ricT_RjT = ricT @ RjT
    J_pi = torch.cat([ricT_RjT, ricT_RjT @ Ri @ (-skew(pts_imu_i))], dim=-1)
    J_pj = torch.cat([-ricT_RjT, ricT @ skew(pts_imu_j)], dim=-1)

    mv = lambda M, v: (M @ v[..., None])[..., 0]
    tmp_r = ricT_RjT @ Ri @ ric
    J_ex_rot = (
        -tmp_r @ skew(pts_cam_i)
        + skew(mv(tmp_r, pts_cam_i))
        + skew(mv(ricT, mv(RjT, mv(Ri, tic.expand(Pi.shape)) + Pi - Pj) - tic))
    )
    eye = torch.eye(3, dtype=Pi.dtype, device=Pi.device)
    J_ex = torch.cat([ricT @ (RjT @ Ri - eye), J_ex_rot], dim=-1)

    J_dep = mv(tmp_r, pts_i) * (-1.0 / (inv_dep_i * inv_dep_i))[..., None]
    return r, reduce @ J_pi, reduce @ J_pj, reduce @ J_ex, mv(reduce, J_dep)
