"""Component-planes projection-factor evaluation (torch port of
isvins_tpu/solver/proj_fast.py) — the plain version of kernel K1
(ops/proj.py).

The same math as factors.projection.projection_residual_jacobians as
elementwise chains over (N,) component planes, with every rotation of the
Jacobian chain formed as a quaternion product:

    A = Ric^T Rj^T = R(conj(Qj ⊗ qic))
    B = A Ri       = R(conj(Qj ⊗ qic) ⊗ Qi)
    C = B Ric      = R(conj(Qj ⊗ qic) ⊗ Qi ⊗ qic)

The extrinsic Jacobian block is omitted (fixed extrinsic).
"""

from __future__ import annotations

import torch


def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def _qconj(a):
    aw, ax, ay, az = a
    return (aw, -ax, -ay, -az)


def _qrot(q, v):
    w, x, y, z = q
    vx, vy, vz = v
    tx = 2.0 * (y * vz - z * vy)
    ty = 2.0 * (z * vx - x * vz)
    tz = 2.0 * (x * vy - y * vx)
    return (
        vx + w * tx + (y * tz - z * ty),
        vy + w * ty + (z * tx - x * tz),
        vz + w * tz + (x * ty - y * tx),
    )


def _qmat(q):
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return (
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    )


def _cross(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def eval_proj_rows(pts_i, pts_j, Pi, Qi, Pj, Qj, tic, qic, dep, valid):
    """pts_i/pts_j (N,3), Pi/Pj (N,3), Qi/Qj (N,4) wxyz, tic (3,) or (N,3),
    qic (4,) or (N,4), dep (N,), valid (N,) bool. Returns (r (N,2), J_pi (N,2,6), J_pj (N,2,6),
    J_dep (N,2)), unweighted."""
    one = torch.ones_like(dep)
    d = torch.where(valid & (dep.abs() > 1e-8), dep, one)

    qi = tuple(Qi[:, k] for k in range(4))
    qj = tuple(Qj[:, k] for k in range(4))
    qc = tuple(qic[..., k] * one for k in range(4))
    tc = tuple(tic[..., k] * one for k in range(3))

    pi = tuple(pts_i[:, k] / d for k in range(3))
    bi = _qrot(qc, pi)
    bi = (bi[0] + tc[0], bi[1] + tc[1], bi[2] + tc[2])
    wpt = _qrot(qi, bi)
    wpt = (wpt[0] + Pi[:, 0], wpt[1] + Pi[:, 1], wpt[2] + Pi[:, 2])
    bj = _qrot(_qconj(qj), (wpt[0] - Pj[:, 0], wpt[1] - Pj[:, 1], wpt[2] - Pj[:, 2]))
    cj = _qrot(_qconj(qc), (bj[0] - tc[0], bj[1] - tc[1], bj[2] - tc[2]))

    z = cj[2]
    z = torch.where(z.abs() > 1e-6, z,
                    torch.where(z >= 0, torch.full_like(z, 1e-6), torch.full_like(z, -1e-6)))
    inv_z = 1.0 / z
    u = cj[0] * inv_z
    v = cj[1] * inv_z
    r = torch.stack([u - pts_j[:, 0], v - pts_j[:, 1]], dim=-1)

    q_a = _qconj(_qmul(qj, qc))
    q_b = _qmul(q_a, qi)
    q_c = _qmul(q_b, qc)
    A, B, Cm = _qmat(q_a), _qmat(q_b), _qmat(q_c)

    def reduce_rows(M):
        m00, m01, m02, m10, m11, m12, m20, m21, m22 = M
        r0 = ((m00 - u * m20) * inv_z, (m01 - u * m21) * inv_z, (m02 - u * m22) * inv_z)
        r1 = ((m10 - v * m20) * inv_z, (m11 - v * m21) * inv_z, (m12 - v * m22) * inv_z)
        return r0, r1

    RA0, RA1 = reduce_rows(A)
    RB0, RB1 = reduce_rows(B)
    JpiR0 = _cross(bi, RB0)
    JpiR1 = _cross(bi, RB1)
    J_pi = torch.stack(
        [torch.stack(RA0 + JpiR0, dim=-1), torch.stack(RA1 + JpiR1, dim=-1)], dim=1)

    RC0, RC1 = reduce_rows(_qmat(_qconj(qc)))
    JpjR0 = _cross(bj, RC0)
    JpjR1 = _cross(bj, RC1)
    J_pj = -torch.stack(
        [torch.stack(RA0 + JpjR0, dim=-1), torch.stack(RA1 + JpjR1, dim=-1)], dim=1)

    c00, c01, c02, c10, c11, c12, c20, c21, c22 = Cm
    px, py, pz = pts_i[:, 0], pts_i[:, 1], pts_i[:, 2]
    w0 = c00 * px + c01 * py + c02 * pz
    w1 = c10 * px + c11 * py + c12 * pz
    w2 = c20 * px + c21 * py + c22 * pz
    s = -1.0 / (d * d)
    J_dep = torch.stack([(w0 - u * w2) * inv_z * s, (w1 - v * w2) * inv_z * s], dim=-1)
    return r, J_pi, J_pj, J_dep
