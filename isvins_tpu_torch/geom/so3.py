"""SO(3) operations on quaternions and rotation matrices (torch port of
isvins_tpu/geom/so3.py).

Quaternion convention: Hamilton, stored **wxyz** as shape (..., 4) tensors.
All functions broadcast over leading batch dimensions and preserve the
input dtype and device. Small-angle branches use Taylor expansions selected
with `torch.where` on *safe* arguments, exactly as the reference does, so
no inf/NaN is produced in the unselected branch.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def skew(v):
    """(...,3) -> (...,3,3) cross-product matrix [v]x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def unskew(M):
    """(...,3,3) -> (...,3), inverse of skew (antisymmetric part)."""
    return torch.stack(
        [M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0], M[..., 1, 0] - M[..., 0, 1]],
        dim=-1,
    ) * 0.5


def quat_identity(dtype=torch.float64, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_mul(q, p):
    """Hamilton product q*p, both (...,4) wxyz."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q):
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp(n, min=_EPS)
    # canonicalize sign (w >= 0) so log/interp are stable
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)


def quat_rotate(q, v):
    """Rotate vector(s) v (...,3) by quaternion(s) q (...,4): R(q) @ v."""
    qv = q[..., 1:]
    w = q[..., :1]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def quat_to_mat(q):
    """(...,4) wxyz -> (...,3,3) rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def mat_to_quat(R):
    """(...,3,3) -> (...,4) wxyz. Branchless Shepperd: all four candidate
    quaternions, selected by the largest diagonal combination."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def cand(a2, comps):
        s = torch.sqrt(torch.clamp(a2, min=0.0)) * 2.0
        return torch.stack(comps, dim=-1) / torch.clamp(s, min=_EPS)[..., None]

    cw = cand(qw2, [qw2, m21 - m12, m02 - m20, m10 - m01])
    cx = cand(qx2, [m21 - m12, qx2, m01 + m10, m02 + m20])
    cy = cand(qy2, [m02 - m20, m01 + m10, qy2, m12 + m21])
    cz = cand(qz2, [m10 - m01, m02 + m20, m12 + m21, qz2])

    vals = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    idx = torch.argmax(vals, dim=-1)
    cands = torch.stack([cw, cx, cy, cz], dim=-2)  # (...,4cand,4)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    return quat_normalize(q)


def _safe_angle_terms(theta_sq):
    """(small, theta, theta_sq_safe); exact-branch expressions use the safe
    values so the unselected branch never produces inf/NaN."""
    small = theta_sq < _EPS
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(theta_sq_safe)
    return small, theta, theta_sq_safe


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp_quat(phi):
    """Exponential map (...,3) -> unit quaternion (...,4)."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    small, theta, _ = _safe_angle_terms(theta_sq)
    half = theta * 0.5
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([w[..., None], k[..., None] * phi], dim=-1)


def so3_exp_mat(phi):
    """Rodrigues: (...,3) -> (...,3,3)."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    small, theta, theta_sq_safe = _safe_angle_terms(theta_sq)
    W = skew(phi)
    W2 = W @ W
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / theta_sq_safe)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def quat_log(q):
    """Log map (...,4) -> (...,3). Handles double cover by sign fix."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn_sq = torch.sum(v * v, dim=-1)
    small = vn_sq < _EPS
    vn = torch.sqrt(torch.where(small, torch.ones_like(vn_sq), vn_sq))
    angle = 2.0 * torch.atan2(vn, w)
    k_exact = angle / vn
    k_taylor = 2.0 / torch.clamp(w, min=_EPS) * (
        1.0 - vn_sq / (3.0 * torch.clamp(w * w, min=_EPS)))
    k = torch.where(small, k_taylor, k_exact)
    return k[..., None] * v


def so3_log_mat(R):
    return quat_log(mat_to_quat(R))


def right_jacobian_so3(phi):
    """Jr(phi): Exp(phi + dphi) ~= Exp(phi) Exp(Jr dphi)."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    small, theta, theta_sq_safe = _safe_angle_terms(theta_sq)
    W = skew(phi)
    W2 = W @ W
    c1 = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / theta_sq_safe)
    c2 = torch.where(
        small, 1.0 / 6.0 - theta_sq / 120.0, (theta - torch.sin(theta)) / (theta_sq_safe * theta)
    )
    return _eye_like(W) - c1[..., None, None] * W + c2[..., None, None] * W2


def right_jacobian_inv_so3(phi):
    """Jr^{-1}(phi)."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    small, theta, theta_sq_safe = _safe_angle_terms(theta_sq)
    W = skew(phi)
    W2 = W @ W
    sin_safe = torch.where(small, torch.ones_like(theta), torch.sin(theta))
    c_exact = 1.0 / theta_sq_safe - (1.0 + torch.cos(theta)) / (2.0 * theta * sin_safe)
    c_taylor = 1.0 / 12.0 + theta_sq / 720.0
    c = torch.where(small, c_taylor, c_exact)
    return _eye_like(W) + 0.5 * W + c[..., None, None] * W2


def left_jacobian_so3(phi):
    return right_jacobian_so3(-phi)


def left_jacobian_inv_so3(phi):
    return right_jacobian_inv_so3(-phi)


def ypr_to_mat(ypr_deg):
    """(...,3) yaw,pitch,roll in degrees -> (...,3,3) = Rz(y)Ry(p)Rx(r)."""
    ypr = ypr_deg * (math.pi / 180.0)
    y, p, r = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    zero = torch.zeros_like(y)
    one = torch.ones_like(y)

    def m(rows):
        return torch.stack([torch.stack(r_, -1) for r_ in rows], -2)

    Rz = m([[cy, -sy, zero], [sy, cy, zero], [zero, zero, one]])
    Ry = m([[cp, zero, sp], [zero, one, zero], [-sp, zero, cp]])
    Rx = m([[one, zero, zero], [zero, cr, -sr], [zero, sr, cr]])
    return Rz @ Ry @ Rx


def mat_to_ypr(R):
    """(...,3,3) -> (...,3) yaw,pitch,roll in degrees."""
    n = R[..., :, 0]
    o = R[..., :, 1]
    a = R[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    r = torch.atan2(
        a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
        -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y),
    )
    return torch.stack([y, p, r], dim=-1) * (180.0 / math.pi)


def g2R(g):
    """Gravity-aligning rotation with yaw zeroed: R0 @ g.normalized() =
    [0,0,1] and yaw(R0) = 0."""
    ng1 = g / torch.linalg.norm(g, dim=-1, keepdim=True)
    ng2 = torch.tensor([0.0, 0.0, 1.0], dtype=g.dtype, device=g.device).expand(ng1.shape)
    axis = torch.linalg.cross(ng1, ng2, dim=-1)
    s = torch.linalg.norm(axis, dim=-1)
    c = torch.sum(ng1 * ng2, dim=-1)
    angle = torch.atan2(s, c)
    axis = axis / torch.clamp(s, min=_EPS)[..., None]
    R0 = so3_exp_mat(axis * angle[..., None])
    yaw = mat_to_ypr(R0)[..., 0]
    zero = torch.zeros_like(yaw)
    Ryaw = ypr_to_mat(torch.stack([-yaw, zero, zero], dim=-1))
    return Ryaw @ R0
