"""Visual-inertial alignment (numpy port of isvins_tpu/initial/alignment.py): gyroscope bias, then velocities + gravity +
scale from the linear system, then 2-dof gravity refinement.

Math contract: src/initial/initial_aligment.cpp (solveGyroscopeBias :3–37,
LinearAlignment :125–198 with the /100 scale conditioning, RefineGravity
:40–123 on the tangent basis, 4 iterations). Frame inputs follow the
reference's ImageFrame convention: R_i = body-to-c0 rotation, T_i = *camera*
position in c0 (estimator.cpp:292–293).
"""

from __future__ import annotations

import numpy as np

from ..geom.hostmath import mat_to_quat_np, quat_conj_np, quat_mul_np


def solve_gyroscope_bias(R_bodies, preints, trim: bool = True):
    """R_bodies: (B,3,3) body-to-c0 rotations; preints: list of per-segment
    Preintegration pytrees (segment k: frame k -> k+1). Returns delta_bg (3,).

    Least squares on the rotation constraint q_preint^{-1} (q_bk^-1 q_bk+1)
    ~ Exp(J_q_bg dbg) (initial_aligment.cpp:12–26).

    trim=True adds a consensus pass the reference lacks. The chained-PnP SfM
    rotations feeding this are only as good as their weakest sub-chain — at
    the product window (B=18) the frames behind the seed pair carried a
    consistent ~2.2 deg/frame warp on the synthetic bench world, which the
    plain least squares aliased into a 0.14 rad/s bias (poisoning the whole
    run; a post-fit residual trim cannot separate the populations because
    the compromise fit spreads the error over all segments). Instead each
    segment yields its own 3-dof closed-form estimate J_k^-1 tb_k; the
    componentwise MEDIAN of those is robust to just under half the segments
    being chain-warped, and a final least squares over the segments that
    agree with the median (within max(3 MAD, 0.25 deg)) restores the
    noise-optimal estimate."""
    Js, tbs = [], []
    for k, pre in enumerate(preints):
        Ri = R_bodies[k]
        Rj = R_bodies[k + 1]
        q_ij = mat_to_quat_np(Ri.T @ Rj)
        J = np.asarray(pre.jac)[3:6, 12:15]
        dq = np.asarray(pre.delta_q)
        # tmp_b = -2 (q_ij^-1 ⊗ delta_q).vec (:21); solve A dbg = b
        q = quat_mul_np(quat_conj_np(q_ij), dq)
        tbs.append(-2.0 * q[1:])
        Js.append(J)

    def _solve(keep):
        A = np.zeros((3, 3))
        b = np.zeros(3)
        for k in keep:
            A += Js[k].T @ Js[k]
            b += Js[k].T @ tbs[k]
        return np.linalg.solve(A + 1e-12 * np.eye(3), b)

    keep = list(range(len(preints)))
    if not trim or len(preints) < 6:
        return _solve(keep)
    per_seg = []
    for k in keep:
        try:
            per_seg.append(np.linalg.solve(
                Js[k] + 1e-12 * np.eye(3), tbs[k]))
        except np.linalg.LinAlgError:
            per_seg.append(np.full(3, np.nan))
    per_seg = np.asarray(per_seg)
    ok = np.isfinite(per_seg).all(axis=1)
    if ok.sum() < 3:
        return _solve(keep)
    med = np.median(per_seg[ok], axis=0)
    dev = np.linalg.norm(per_seg - med[None, :], axis=1)
    mad = float(np.median(dev[ok]))
    thresh = max(3.0 * mad, np.radians(0.25) / max(
        float(np.median([np.asarray(p.sum_dt) for p in preints])), 1e-3))
    inl = [k for k in keep if ok[k] and dev[k] <= thresh]
    if len(inl) >= 3:
        return _solve(inl)
    return _solve(keep)


def linear_alignment(R_bodies, T_cams, preints, tic, g_norm):
    """LinearAlignment (:125–198): solve per-frame body velocities, gravity in
    c0, and scale. Returns (ok, g (3,), x ((3B+4,) with scale at tail))."""
    B = len(R_bodies)
    n_state = B * 3 + 3 + 1
    A = np.zeros((n_state, n_state))
    b = np.zeros(n_state)
    for i, pre in enumerate(preints):
        Ri = R_bodies[i]
        Rj = R_bodies[i + 1]
        dt = float(np.asarray(pre.sum_dt))
        tmp_A = np.zeros((6, 10))
        tmp_b = np.zeros(6)
        tmp_A[0:3, 0:3] = -dt * np.eye(3)
        tmp_A[0:3, 6:9] = Ri.T * dt * dt / 2
        tmp_A[0:3, 9] = Ri.T @ (T_cams[i + 1] - T_cams[i]) / 100.0
        tmp_b[0:3] = np.asarray(pre.delta_p) + Ri.T @ Rj @ tic - tic
        tmp_A[3:6, 0:3] = -np.eye(3)
        tmp_A[3:6, 3:6] = Ri.T @ Rj
        tmp_A[3:6, 6:9] = Ri.T * dt
        tmp_b[3:6] = np.asarray(pre.delta_v)

        r_A = tmp_A.T @ tmp_A
        r_b = tmp_A.T @ tmp_b
        A[i * 3 : i * 3 + 6, i * 3 : i * 3 + 6] += r_A[:6, :6]
        b[i * 3 : i * 3 + 6] += r_b[:6]
        A[-4:, -4:] += r_A[-4:, -4:]
        b[-4:] += r_b[-4:]
        A[i * 3 : i * 3 + 6, -4:] += r_A[:6, -4:]
        A[-4:, i * 3 : i * 3 + 6] += r_A[-4:, :6]

    A *= 1000.0
    b *= 1000.0
    x = np.linalg.solve(A + 1e-10 * np.eye(n_state), b)
    s = x[-1] / 100.0
    g = x[n_state - 4 : n_state - 1].copy()
    if abs(np.linalg.norm(g) - g_norm) > 1.0 or s < 0:
        return False, g, x
    g, x = refine_gravity(R_bodies, T_cams, preints, tic, g, g_norm)
    s = x[-1] / 100.0
    x[-1] = s
    return s >= 0, g, x


def refine_gravity(R_bodies, T_cams, preints, tic, g, g_norm):
    """RefineGravity (:55–123): re-solve with gravity constrained to the
    2-sphere tangent, 4 iterations."""
    g0 = g / np.linalg.norm(g) * g_norm
    B = len(R_bodies)
    n_state = B * 3 + 2 + 1
    x = None
    for _ in range(4):
        lxly = _tangent_basis(g0)
        A = np.zeros((n_state, n_state))
        b = np.zeros(n_state)
        for i, pre in enumerate(preints):
            Ri = R_bodies[i]
            Rj = R_bodies[i + 1]
            dt = float(np.asarray(pre.sum_dt))
            tmp_A = np.zeros((6, 9))
            tmp_b = np.zeros(6)
            tmp_A[0:3, 0:3] = -dt * np.eye(3)
            tmp_A[0:3, 6:8] = Ri.T @ (np.eye(3) * dt * dt / 2) @ lxly
            tmp_A[0:3, 8] = Ri.T @ (T_cams[i + 1] - T_cams[i]) / 100.0
            tmp_b[0:3] = (
                np.asarray(pre.delta_p)
                + Ri.T @ Rj @ tic
                - tic
                - Ri.T @ (np.eye(3) * dt * dt / 2) @ g0
            )
            tmp_A[3:6, 0:3] = -np.eye(3)
            tmp_A[3:6, 3:6] = Ri.T @ Rj
            tmp_A[3:6, 6:8] = Ri.T @ (np.eye(3) * dt) @ lxly
            tmp_b[3:6] = np.asarray(pre.delta_v) - Ri.T @ (np.eye(3) * dt) @ g0

            r_A = tmp_A.T @ tmp_A
            r_b = tmp_A.T @ tmp_b
            A[i * 3 : i * 3 + 6, i * 3 : i * 3 + 6] += r_A[:6, :6]
            b[i * 3 : i * 3 + 6] += r_b[:6]
            A[-3:, -3:] += r_A[-3:, -3:]
            b[-3:] += r_b[-3:]
            A[i * 3 : i * 3 + 6, -3:] += r_A[:6, -3:]
            A[-3:, i * 3 : i * 3 + 6] += r_A[-3:, :6]
        A *= 1000.0
        b *= 1000.0
        x = np.linalg.solve(A + 1e-10 * np.eye(n_state), b)
        dg = x[n_state - 3 : n_state - 1]
        g0 = (g0 + lxly @ dg) / np.linalg.norm(g0 + lxly @ dg) * g_norm
    # repackage x to the LinearAlignment layout (3B velocities ... scale)
    x_out = np.zeros(B * 3 + 4)
    x_out[: B * 3] = x[: B * 3]
    x_out[-1] = x[-1]
    return g0, x_out


def _tangent_basis(g0):
    a = g0 / np.linalg.norm(g0)
    tmp = np.array([0.0, 0.0, 1.0])
    if np.allclose(a, tmp):
        tmp = np.array([1.0, 0.0, 0.0])
    b = tmp - a * (a @ tmp)
    b /= np.linalg.norm(b)
    c = np.cross(a, b)
    return np.stack([b, c], axis=1)

