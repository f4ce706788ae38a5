"""Pure-numpy twins of the small geometry ops used on the HOST state-machine
paths (estimator bookkeeping, IMU propagation). Copied from the JAX
package's geom/hostmath.py, which imports no jax.

Conventions identical to so3.py/se3.py: quaternions wxyz, rotations
body-to-world, ypr in degrees (Z-Y-X).
"""

from __future__ import annotations

import numpy as np


def quat_mul_np(q, p):
    w0, x0, y0, z0 = q
    w1, x1, y1, z1 = p
    return np.array([
        w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
        w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
        w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
        w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1,
    ])


def quat_conj_np(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def quat_normalize_np(q):
    q = q / max(np.linalg.norm(q), 1e-300)
    # canonicalize sign (w >= 0), matching so3.quat_normalize
    return -q if q[0] < 0 else q


def quat_rotate_np(q, v):
    return quat_to_mat_np(q) @ np.asarray(v)


def quat_to_mat_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def mat_to_quat_np(R):
    """Shepperd's method (branchy — host only)."""
    R = np.asarray(R)
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([
            0.25 * s,
            (R[2, 1] - R[1, 2]) / s,
            (R[0, 2] - R[2, 0]) / s,
            (R[1, 0] - R[0, 1]) / s,
        ])
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array([
            (R[2, 1] - R[1, 2]) / s,
            0.25 * s,
            (R[0, 1] + R[1, 0]) / s,
            (R[0, 2] + R[2, 0]) / s,
        ])
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = np.array([
            (R[0, 2] - R[2, 0]) / s,
            (R[0, 1] + R[1, 0]) / s,
            0.25 * s,
            (R[1, 2] + R[2, 1]) / s,
        ])
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = np.array([
            (R[1, 0] - R[0, 1]) / s,
            (R[0, 2] + R[2, 0]) / s,
            (R[1, 2] + R[2, 1]) / s,
            0.25 * s,
        ])
    if q[0] < 0:
        q = -q
    return quat_normalize_np(q)


def so3_exp_quat_np(phi):
    phi = np.asarray(phi)
    th = np.linalg.norm(phi)
    if th < 1e-12:
        q = np.concatenate([[1.0], 0.5 * phi])
        return quat_normalize_np(q)
    axis = phi / th
    return np.concatenate([[np.cos(th / 2)], axis * np.sin(th / 2)])


def mat_to_ypr_np(R):
    """Z-Y-X euler in DEGREES (utility.h R2ypr)."""
    R = np.asarray(R)
    y = np.arctan2(R[1, 0], R[0, 0])
    p = np.arctan2(-R[2, 0], R[0, 0] * np.cos(y) + R[1, 0] * np.sin(y))
    r = np.arctan2(
        R[0, 2] * np.sin(y) - R[1, 2] * np.cos(y),
        -R[0, 1] * np.sin(y) + R[1, 1] * np.cos(y),
    )
    return np.degrees(np.array([y, p, r]))


def ypr_to_mat_np(ypr_deg):
    y, p, r = np.radians(np.asarray(ypr_deg, dtype=float))
    cy, sy = np.cos(y), np.sin(y)
    cp, sp = np.cos(p), np.sin(p)
    cr, sr = np.cos(r), np.sin(r)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    Ry = np.array([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]])
    Rx = np.array([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def se3_compose_np(p1, q1, p2, q2):
    """T = T1 * T2."""
    return quat_to_mat_np(q1) @ np.asarray(p2) + np.asarray(p1), quat_normalize_np(
        quat_mul_np(q1, q2)
    )


def skew_np(v):
    x, y, z = v
    return np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])


def se3_adjoint_np(p, q):
    """Adjoint of (R, p) on [rho, phi] twists, matching se3.se3_adjoint."""
    R = quat_to_mat_np(q)
    A = np.zeros((6, 6))
    A[:3, :3] = R
    A[:3, 3:] = skew_np(p) @ R
    A[3:, 3:] = R
    return A
