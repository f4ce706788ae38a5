"""SE(3) poses as (p, q) pairs: translation (...,3) + unit quaternion (...,4)
wxyz (torch port of isvins_tpu/geom/se3.py).

Tangent ordering is **[translation(3); rotation(3)]** throughout the engine.
"""

from __future__ import annotations

import torch

from .so3 import (
    left_jacobian_inv_so3,
    left_jacobian_so3,
    quat_conj,
    quat_log,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_mat,
    skew,
    so3_exp_quat,
)


def se3_compose(p1, q1, p2, q2):
    """T1 * T2."""
    return p1 + quat_rotate(q1, p2), quat_normalize(quat_mul(q1, q2))


def se3_inverse(p, q):
    qi = quat_conj(q)
    return -quat_rotate(qi, p), qi


def se3_apply(p, q, x):
    return p + quat_rotate(q, x)


def se3_relative(p1, q1, p2, q2):
    """T1^{-1} * T2 = (R1^T (p2-p1), q1^{-1} q2)."""
    qi = quat_conj(q1)
    return quat_rotate(qi, p2 - p1), quat_normalize(quat_mul(qi, q2))


def se3_adjoint(p, q):
    """6x6 adjoint of T=(p,q) in [trans; rot] ordering:
    Adj = [[R, [p]x R], [0, R]]."""
    R = quat_to_mat(q)
    top = torch.cat([R, skew(p) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_exp(xi):
    """SE(3) exp, xi = (...,6) [v; w] -> (p, q)."""
    v, w = xi[..., :3], xi[..., 3:]
    q = so3_exp_quat(w)
    p = torch.einsum("...ij,...j->...i", left_jacobian_so3(w), v)
    return p, q


def se3_log(p, q):
    """Inverse of se3_exp: (p,q) -> (...,6) [v; w]."""
    w = quat_log(q)
    v = torch.einsum("...ij,...j->...i", left_jacobian_inv_so3(w), p)
    return torch.cat([v, w], dim=-1)

