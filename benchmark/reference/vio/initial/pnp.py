"""Frozen copy of isvins_tpu_torch/initial/pnp.py (with the arithmetic's type as
an argument). Perspective-n-Point by damped Gauss-Newton on SE(3), batched over
hypotheses (torch port of isvins_tpu/initial/pnp.py; reference
cv::solvePnP / cv::solvePnPRansac, keyframe.cpp:201).

All RANSAC rounds run as one batched computation on the inputs' device:
row 0 refines the given guess, every other row hypothesizes from a
weighted DLT on its random subset (initialization-free), then polishes by
GN on the subset. The subsets are drawn with numpy's generator, in the
reference's call order, so both packages test the same hypotheses.
Intended for f64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..factors.preintegration import cholesky_nan
from ..geom import mat_to_quat, quat_mul, quat_normalize, quat_rotate, quat_to_mat, skew, so3_exp_quat


def _residual_jac(pts3d, pts2d, w, q, t):
    """Weighted reprojection residuals (R,n,2) and Jacobians (R,n,2,6) wrt
    [t, right-perturbed rotation] for hypotheses q (R,4), t (R,3)."""
    pc = quat_rotate(q[:, None, :], pts3d) + t[:, None, :]
    z = pc[..., 2]
    z = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
    r = pc[..., :2] / z[..., None] - pts2d
    zero = torch.zeros_like(z)
    red = torch.stack([torch.stack([1.0 / z, zero, -pc[..., 0] / (z * z)], dim=-1),
                       torch.stack([zero, 1.0 / z, -pc[..., 1] / (z * z)], dim=-1)], dim=-2)
    J_r = red @ (quat_to_mat(q)[:, None] @ (-skew(pts3d)))
    J = torch.cat([red, J_r], dim=-1)
    return r * w[..., None], J * w[..., None, None]


def _pnp_gn_core(pts3d, pts2d, w, q_cw, t_cw, iters: int = 10):
    """Minimize sum w_i |proj(R_cw X_i + t_cw) - uv_i|^2 over each row's
    (q_cw, t_cw) (world-to-camera): damped GN, fixed iterations,
    branchless. w (R,n), q_cw (R,4), t_cw (R,3). Returns (q, t, per-point
    squared error (R,n))."""
    q, t = q_cw, t_cw
    eye = 1e-8 * torch.eye(6, dtype=pts3d.dtype, device=pts3d.device)
    for _ in range(iters):
        r, J = _residual_jac(pts3d, pts2d, w, q, t)
        Jf = J.reshape(J.shape[0], -1, 6)
        H = Jf.transpose(-1, -2) @ Jf + eye
        g = -(Jf.transpose(-1, -2) @ r.reshape(r.shape[0], -1, 1))
        dx = torch.cholesky_solve(g, cholesky_nan(H))[..., 0]
        t = t + dx[:, :3]
        q = quat_normalize(quat_mul(q, so3_exp_quat(dx[:, 3:])))
    r, _ = _residual_jac(pts3d, pts2d, w, q, t)
    return q, t, torch.sum(r * r, dim=-1)


def pnp_gn(pts3d, pts2d, q_cw0, t_cw0, weights=None, iters: int = 10):
    """pts3d (n,3) world, pts2d (n,2) normalized plane, initial guess
    (q_cw0, t_cw0) world-to-camera (tensors). Returns (q_cw, t_cw,
    per-point squared error)."""
    w = torch.ones_like(pts3d[:, 0]) if weights is None else weights
    q, t, e = _pnp_gn_core(pts3d, pts2d, w[None], q_cw0[None], t_cw0[None], iters)
    return q[0], t[0], e[0]


def mat_to_quat_safe(R):
    return quat_normalize(mat_to_quat(R))


def _pnp_dlt(pts3d, pts2d, w):
    """Closed-form weighted DLT PnP per row of w (R,n): the 3x4 projection
    matrix as the smallest eigenvector of A^T A (12x12), the sign that puts
    the weighted majority in front of the camera, then the rotation block
    orthogonalized by SVD. Returns (q_cw (R,4), t_cw (R,3))."""
    X = torch.cat([pts3d, torch.ones_like(pts3d[:, :1])], dim=1)  # (n,4)
    Z4 = torch.zeros_like(X)
    row_u = torch.cat([X, Z4, -pts2d[:, :1] * X], dim=1)  # (n,12)
    row_v = torch.cat([Z4, X, -pts2d[:, 1:2] * X], dim=1)
    A = torch.cat([row_u[None] * w[..., None], row_v[None] * w[..., None]], dim=1)
    _, evecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    P = evecs[..., 0].reshape(-1, 3, 4)
    z = X @ P[:, 2, :].transpose(0, 1)  # (n,R)
    sgn = torch.where(torch.sum(torch.sign(z).T * w, dim=1) >= 0, 1.0, -1.0).to(X.dtype)
    M = P[:, :, :3] * sgn[:, None, None]
    m = P[:, :, 3] * sgn[:, None]
    U, S, Vt = torch.linalg.svd(M)
    detUV = torch.linalg.det(U @ Vt)
    ones = torch.ones_like(detUV)
    R = U @ torch.diag_embed(torch.stack([ones, ones, detUV], dim=-1)) @ Vt
    s = torch.mean(S, dim=-1) * detUV
    s = torch.where(s.abs() > 1e-12, s, torch.full_like(s, 1e-12))
    return mat_to_quat_safe(R), m / s[:, None]


def _pnp_ransac_rounds(pts3d, pts2d, W, q_cw0, t_cw0):
    """Every RANSAC hypothesis in one batch (W (R,n) weight rows): row 0
    from the guess, the others from the DLT on their subset, each then GN
    on its subset and scored against all points. Returns (errs (R,n),
    q (R,4), t (R,3))."""
    Rn = W.shape[0]
    q_d, t_d = _pnp_dlt(pts3d, pts2d, W)
    use_guess = (torch.arange(Rn, device=W.device) == 0)[:, None]
    q0 = torch.where(use_guess, q_cw0[None], q_d)
    t0 = torch.where(use_guess, t_cw0[None], t_d)
    q, t, _ = _pnp_gn_core(pts3d, pts2d, W, q0, t0, 10)
    _, _, errs = _pnp_gn_core(pts3d, pts2d, torch.ones_like(W), q, t, 0)
    return errs, q, t


def pnp_ransac_gn(pts3d, pts2d, q_cw0, t_cw0, thresh: float = 10.0 / 460.0,
                  n_rounds: int = 96, min_set: int = 6, min_inliers: int = 5,
                  iters: int = 10, seed: int = 0, device=None, dtype=torch.float64):
    """Robust PnP: DLT hypotheses on random minimal subsets (all rounds
    batched on `device`, None meaning the CUDA card, f64), scored by inlier count, refit on the best
    inlier set from the best hypothesis; the guess (q_cw0, t_cw0) is only
    round 0. Inputs and returns are host numpy: (ok, q_cw, t_cw,
    inlier_mask). `dtype` is the type of the arithmetic (the port's is float64)."""
    pts3d = np.asarray(pts3d, np.float64)
    pts2d = np.asarray(pts2d, np.float64)[:, :2]
    n = len(pts3d)
    if n < min_set:
        return False, np.asarray(q_cw0), np.asarray(t_cw0), np.zeros(n, bool)
    rng = np.random.default_rng(seed)
    t2 = thresh * thresh
    W = np.zeros((n_rounds, n))
    W[0] = 1.0  # round 0: plain GN on everything from the guess
    for r_i in range(1, n_rounds):
        W[r_i, rng.choice(n, size=min(min_set, n), replace=False)] = 1.0
    device = resolve_device(device)
    T = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)
    p3, p2 = T(pts3d), T(pts2d)
    errs, qs, ts = _pnp_ransac_rounds(p3, p2, T(W), T(q_cw0), T(t_cw0))
    inl_all = (errs < t2).cpu().numpy()
    best = int(np.argmax(inl_all.sum(axis=1)))
    best_inl = inl_all[best]
    if best_inl.sum() < max(min_set, min_inliers):
        return False, np.asarray(q_cw0), np.asarray(t_cw0), np.zeros(n, bool)
    q, t, _ = pnp_gn(p3, p2, qs[best], ts[best], weights=T(best_inl), iters=iters)
    _, _, errs_all = pnp_gn(p3, p2, q, t, iters=0)
    return True, q.cpu().numpy(), t.cpu().numpy(), (errs_all < t2).cpu().numpy()
