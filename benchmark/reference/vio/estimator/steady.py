"""The estimator's steady-state frame solve: a frozen copy of
isvins_tpu_torch/estimator/estimator.py's steady_solve, device_triangulate
and min_eigvec_sym4, and of estimator/feature_manager.py's _dlt_systems,
for one window (the benchmark's reference runs them in float64)."""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_const
from ..factors import ImuNoise, integrate_segment
from ..geom import quat_to_mat
from ..solver.window import ImuFactors, solve_window

_JACOBI_ROUNDS = (((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2)))


def _jacobi_consts(dtype, device):
    """Per round, on `device`: the rows and columns of a_pp, a_qq and a_pq
    of both pairs, and the (4, 16) map of both pairs' (c, s) to the
    rotation's entries (J_pp = J_qq = c, J_pq = s, J_qp = -s)."""
    rows, cols = [], []
    to_j = np.zeros((len(_JACOBI_ROUNDS), 4, 16))
    for r, pairs in enumerate(_JACOBI_ROUNDS):
        (p0, q0), (p1, q1) = pairs
        rows.append([p0, p1, q0, q1, p0, p1])
        cols.append([p0, p1, q0, q1, q0, q1])
        for i, (p, q) in enumerate(pairs):
            to_j[r, i, 5 * p] = to_j[r, i, 5 * q] = 1.0
            to_j[r, 2 + i, 4 * p + q], to_j[r, 2 + i, 4 * q + p] = 1.0, -1.0
    return device_const([rows, cols], torch.int64, device), device_const(to_j, dtype, device)


def min_eigvec_sym4(G, sweeps: int = 4):
    """The unit eigenvector of the smallest eigenvalue of each symmetric 4x4
    matrix of G (..., 4, 4), up to sign, by cyclic Jacobi: `sweeps` sweeps
    of three rounds, each round's two disjoint rotations made together
    (Numerical Recipes' angle, the smaller one) and applied as one
    orthogonal matrix J, A <- J^T A J: 18 device operations a round. A fixed
    count and no branch on the data, so nothing is read on the host
    (torch.linalg.eigh reads its error flags on the host on CUDA); Jacobi
    converges quadratically, and four sweeps of a 4x4 reach the rounding of
    its type (on the matrices of tests/test_torch_estimator.py a fifth sweep
    moves the f32 error not at all and the f64 error by under 1e-15)."""
    idx, to_j = _jacobi_consts(G.dtype, G.device)
    rounds = [(idx[0, r], idx[1, r], to_j[r]) for r in range(len(_JACOBI_ROUNDS))]
    A = G
    V = torch.eye(4, dtype=G.dtype, device=G.device).expand(G.shape)
    for _ in range(sweeps):
        for rows, cols, to_j_r in rounds:
            a = A[..., rows, cols]  # a_pp, a_qq, a_pq of both pairs
            d, two = a[..., 2:4] - a[..., 0:2], 2.0 * a[..., 4:6]
            # t = sgn(theta) / (|theta| + sqrt(theta^2 + 1)), theta = d / two;
            # 0 where the entry is 0 (0 / 0 when d is 0 too)
            t = torch.nan_to_num(two / (d + torch.copysign(torch.hypot(d, two), d)), nan=0.0)
            c = torch.rsqrt(t * t + 1.0)
            J = (torch.cat([c, t * c], dim=-1) @ to_j_r).reshape(G.shape)
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    k = torch.diagonal(A, dim1=-2, dim2=-1).argmin(dim=-1)
    return torch.gather(V, -1, k[..., None, None].expand(V.shape[:-1] + (1,)))[..., 0]


def _dlt_systems(obs, has_obs, start, P, Q, tic, qic):
    """(n, 2B, 4) masked DLT rows of every track in its host camera frame.
    Every argument may carry the same leading sequence axes."""
    R = quat_to_mat(Q)  # (B,3,3)
    Ric = quat_to_mat(qic)
    t_cam = P + (R @ tic[..., None, :, None])[..., 0]  # (B,3)
    R_cam = R @ Ric[..., None, :, :]  # (B,3,3)
    t0 = torch.gather(t_cam, -2, start[..., None].expand(start.shape + (3,)))  # (n,3)
    R0 = torch.gather(R_cam, -3, start[..., None, None].expand(start.shape + (3, 3)))  # (n,3,3)
    # relative transforms host -> each frame, exactly as the JAX reference
    # computes them (einsum "ji,bi->bj" / "ji,bik->bjk"): R0 (t_b - t0) and
    # R0 R_b. The reference's comment and feature_manager.cpp use R0^T; the
    # port keeps the reference's product so both packages seed the same
    # depths.
    t_rel = torch.einsum("...nji,...nbi->...nbj", R0,
                         t_cam[..., None, :, :] - t0[..., :, None, :])
    R_rel = torch.einsum("...nji,...bik->...nbjk", R0, R_cam)
    Pl = R_rel.transpose(-1, -2)
    Pt = -(Pl @ t_rel[..., None])[..., 0]
    Pm = torch.cat([Pl, Pt[..., None]], dim=-1)  # (n,B,3,4)
    # sanitize BEFORE the normalize: unobserved rows are zero-padded and
    # 0/0 -> NaN would poison the system through the mask (NaN * 0 = NaN)
    unit_z = device_const([0.0, 0.0, 1.0], obs.dtype, obs.device)
    o = torch.where(has_obs[..., None], obs, unit_z)
    f = o / torch.linalg.norm(o, dim=-1, keepdim=True)
    row0 = f[..., 0:1] * Pm[..., 2, :] - f[..., 2:3] * Pm[..., 0, :]
    row1 = f[..., 1:2] * Pm[..., 2, :] - f[..., 2:3] * Pm[..., 1, :]
    w = has_obs.to(obs.dtype)[..., None]
    return torch.cat([row0 * w, row1 * w], dim=-2)


def device_triangulate(st: WindowState, obs, has_obs, start):
    """Masked multi-view DLT depth seeding on the device, (F,) metric depths
    (garbage where a track has < 2 observations; the caller masks). The
    nullspace is the eigenvector of the smallest eigenvalue of the 4x4 Gram
    matrix (min_eigvec_sym4: f32-safe, batched over all tracks, no host
    read). Every argument may carry the same leading sequence axes."""

    A = _dlt_systems(obs, has_obs, start.long(), st.P, st.Q, st.tic, st.qic)
    v = min_eigvec_sym4(A.transpose(-1, -2) @ A)
    v3 = v[..., 3]
    return v[..., 2] / torch.where(v3.abs() > 1e-12, v3, torch.full_like(v3, 1e-12))


def steady_solve(st: WindowState, im_raw, tri, pr: ProjFactors, pri: PriorState, g, ps,
                 dims: WindowDims, iters: int, estimate_extrinsic: bool, noise: ImuNoise,
                 max_depth: float, info: dict | None = None):
    """The steady-state frame solve, all on the device: seed fresh landmark
    depths by masked DLT, preintegrate every segment at the in-state bias,
    then run the window LM (JAX `_steady_solve`, estimator.py:603-619). With
    a leading sequence axis on every leaf it is the batched solve of several
    estimators' windows (solve_window_batched). Reads nothing on the host;
    `info` receives the solve's iteration counts (device tensors)."""
    obs, has_obs, start, need = tri
    d = device_triangulate(st, obs, has_obs, start)
    ok = torch.isfinite(d) & (d > 0.1)
    inv = 1.0 / torch.clamp(d, 0.1, max_depth)
    st = st._replace(dep=torch.where(need & ok, inv, st.dep))
    dts, accs, gyrs, a0, g0, valid = im_raw
    pre = integrate_segment(dts, accs, gyrs, a0, g0, st.Ba[..., :-1, :], st.Bg[..., :-1, :],
                            noise)
    im = ImuFactors.create(pre=pre, valid=valid)
    solve = solve_window
    return solve(st, im, pr, pri, g, ps, dims, iters=iters,
                 estimate_extrinsic=estimate_extrinsic, info=info)


