"""Relative pose from 2D-2D correspondences on the normalized plane (torch
port of isvins_tpu/initial/five_point.py).

Replaces the reference's cv::findFundamentalMat(RANSAC) + recoverPose
(src/initial/solve_5pts.cpp:193-227) with a batched 8-point essential
matrix RANSAC: all hypotheses are solved as one batch, scored with Sampson
distances in one (S, n) broadcast, and the winner's inlier set is refit.
On calibrated (normalized-plane) coordinates the fundamental matrix IS the
essential matrix.

Two routes, as in the reference:
- `epipolar_inliers`, the tracker's fused classification, f32 on the
  tracker's device. The reference takes each nullspace as the smallest
  eigenvector of a 9x9 Gram by `eigh`; torch.linalg.eigh reads its error
  flags on the host on CUDA, so here a hypothesis' nullspace is the last
  column of the complete QR of its 9x8 transposed system and the refit's
  comes from inverse iteration on its Gram, started at the winning
  hypothesis; neither reads the device on the host. The Sampson distance
  is quadratic in E, so the vector's sign is free.
- `_ransac_core` and the `solve_*` entry points: f64 on CPU tensors (the
  reference pins them to the host CPU), with SVDs as the reference.

Returns the pose of camera 2 expressed in camera 1 (the convention the
reference hands to GlobalSFM: R = rot^T, T = -rot^T t, solve_5pts.cpp:219-224).
"""

from __future__ import annotations

import numpy as np
import torch

_CPU = torch.device("cpu")


def _rows9(p1, p2):
    """(..., n, 9) rows [x2x1, x2y1, x2, y2x1, y2y1, y2, x1, y1, 1] of
    x2^T E x1 = 0."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)


def _essential_projection(E):
    """E with singular values (1, 1, 0)."""
    U, _, Vt = torch.linalg.svd(E)
    d = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype)
    return U @ torch.diag_embed(d.expand(E.shape[:-2] + (3,))) @ Vt


def _eight_point(p1, p2):
    """p1, p2: (..., 8, 2) -> E (..., 3, 3) with enforced essential
    structure (f64, CPU)."""
    _, _, Vh = torch.linalg.svd(_rows9(p1, p2), full_matrices=True)
    return _essential_projection(Vh[..., -1, :].reshape(Vh.shape[:-2] + (3, 3)))


def _sampson_sq(E, p1, p2):
    """Squared Sampson distance of every correspondence. E (..., 3, 3),
    p* (n, 2) -> (..., n)."""
    one = torch.ones_like(p1[:, :1])
    x1 = torch.cat([p1, one], dim=1)
    x2 = torch.cat([p2, one], dim=1)
    Ex1 = x1 @ E.transpose(-1, -2)  # (..., n, 3)
    Etx2 = x2 @ E
    num = torch.sum(x2 * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _inverse_iteration(G, x, iters: int = 4):
    """The unit eigenvector of the smallest eigenvalue of each symmetric
    PSD G (..., 9, 9), from the start x (..., 9): x <- (G + s I)^-1 x,
    normalized, with s a 1e-6 share of the mean eigenvalue. One LU, `iters`
    solves; nothing is read on the host (lu_factor_ex checks nothing)."""
    n = G.shape[-1]
    s = 1e-6 * torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / n
    eye = torch.eye(n, dtype=G.dtype, device=G.device)
    LU, piv, _ = torch.linalg.lu_factor_ex(G + s[..., None, None] * eye)
    for _ in range(iters):
        x = torch.linalg.lu_solve(LU, piv, x[..., None])[..., 0]
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x


def epipolar_inliers(p1, p2, valid, samples, thresh_sq):
    """Epipolar inlier classification for the tracker's outlier rejection,
    f32 on the inputs' device, no host read. Hypotheses from `samples`
    (S, 8) row indices into p1/p2; each 8-point solve is the nullspace of
    its 8 x 9 system. The rank-2 essential projection is skipped, as in the
    reference: for inlier CLASSIFICATION the nullspace E's Sampson
    distances separate at the same threshold. Invalid rows drawn into a
    hypothesis poison only that hypothesis (huge residuals -> low score ->
    it loses the argmax); rows outside `valid` are zeroed before the refit,
    which weights them 0, so a non-finite one cannot poison it.

    Returns (inlier_mask (n,), n_inliers) - mask is False outside `valid`."""
    A = _rows9(p1[samples], p2[samples])  # (S, 8, 9)
    Q, _ = torch.linalg.qr(A.transpose(-1, -2), mode="complete")  # (S, 9, 9)
    Es = Q[..., :, -1].reshape(-1, 3, 3)
    d = _sampson_sq(Es, p1, p2)  # (S, n)
    inl = (d < thresh_sq) & valid[None, :]
    # the winner by an index tensor (indexing by a 0-d tensor reads it on
    # the host)
    best = torch.argmax(inl.sum(dim=1)).reshape(1)
    # refit on the best hypothesis' inliers (weighted 8-point); start the
    # iteration at the winning hypothesis, which it refines
    w = inl.index_select(0, best)[0].to(p1.dtype)
    zero = torch.zeros_like(p1)
    A = _rows9(torch.where(valid[:, None], p1, zero), torch.where(valid[:, None], p2, zero))
    A = A * w[:, None]
    E = _inverse_iteration(A.T @ A, Es.index_select(0, best).reshape(9)).reshape(3, 3)
    inl2 = (_sampson_sq(E, p1, p2) < thresh_sq) & valid
    return inl2, torch.sum(inl2)


def _triangulate_pair(R, t, p1, p2):
    """Linear two-view triangulation: cam1 at identity, cam2 = (R, t)
    world-to-cam. Returns depths in cam1 and cam2. p* (n, 2)."""
    one = torch.ones_like(p1[:, :1])
    f1 = torch.cat([p1, one], dim=1)
    f2 = torch.cat([p2, one], dim=1)
    # solve min |d1 (R f1) + t - d2 f2|^2 over (d1, d2):
    #   [[a, b], [b, c]] [d1, d2] = [rhs1, rhs2]
    Rf1 = f1 @ R.T
    a = torch.sum(Rf1 * Rf1, dim=1)
    b = -torch.sum(Rf1 * f2, dim=1)
    c = torch.sum(f2 * f2, dim=1)
    rhs1 = -torch.sum(Rf1 * t, dim=1)
    rhs2 = torch.sum(f2 * t, dim=1)
    det = a * c - b * b
    det = torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    d1 = (c * rhs1 - b * rhs2) / det
    d2 = (a * rhs2 - b * rhs1) / det
    return d1, d2


def _decompose_and_vote(E, p1, p2, inl):
    """4 candidate (R, t) from E; pick by cheirality vote over inliers.
    Returns (R_21, t_21, votes) world-to-cam2 with cam1 as world."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    votes = []
    for R, tt in cands:
        d1, d2 = _triangulate_pair(R, tt, p1, p2)
        votes.append(torch.sum((d1 > 0) & (d2 > 0) & inl))
    best = int(torch.argmax(torch.stack(votes)))
    return cands[best][0], cands[best][1], votes[best]


def _ransac_core(p1, p2, valid, samples, thresh_sq):
    """The host path's RANSAC, f64 CPU tensors: 8-point hypotheses,
    Sampson scoring, refit on the winner's inliers, decomposition.
    Returns (R21, t21, inliers, n_inliers, votes)."""
    Es = _eight_point(p1[samples], p2[samples])
    inl = (_sampson_sq(Es, p1, p2) < thresh_sq) & valid[None, :]
    best = torch.argmax(inl.sum(dim=1))
    # refit on inliers (weighted 8-point over all points)
    A = _rows9(p1, p2) * inl[best][:, None]
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    E = _essential_projection(Vh[-1].reshape(3, 3))
    inl2 = (_sampson_sq(E, p1, p2) < thresh_sq) & valid
    R21, t21, votes = _decompose_and_vote(E, p1, p2, inl2)
    return R21, t21, inl2, torch.sum(inl2), votes


def _t64(a):
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64), device=_CPU)


def solve_translation_with_rotation(pts1, pts2, R, thresh: float = 1.0 / 460.0,
                                    iters: int = 3, min_inliers: int = 12):
    """Relative translation direction given a known relative rotation.

    (R, returned T) = pose of cam2 in cam1, same convention as
    solve_relative_pose. With R fixed (e.g. transported from gyro
    preintegration), each correspondence gives one LINEAR constraint
    c_i . t21 = 0 with c_i = (R21 x1_i) x x2_i - a 3-dof SVD problem that is
    immune to the planar degeneracy that breaks 8-point E estimation on
    wall-dominated views. Robustified by IRLS trimming on Sampson distance;
    sign fixed by cheirality. f64 numpy, the Sampson distances and the
    triangulation as f64 CPU tensors."""
    pts1 = np.asarray(pts1)[:, :2]
    pts2 = np.asarray(pts2)[:, :2]
    n = len(pts1)
    if n < min_inliers:
        return False, R, np.zeros(3), np.zeros(n, bool)
    R21 = np.asarray(R).T
    x1 = np.concatenate([pts1, np.ones((n, 1))], axis=1)
    x2 = np.concatenate([pts2, np.ones((n, 1))], axis=1)
    C = np.cross(x1 @ R21.T, x2)  # rows c_i
    keep = np.ones(n, bool)
    t21 = None
    for _ in range(iters):
        if keep.sum() < 3:
            return False, R, np.zeros(3), np.zeros(n, bool)
        _, _, Vt = np.linalg.svd(C[keep], full_matrices=True)
        t21 = Vt[-1]
        tx = np.array([[0.0, -t21[2], t21[1]],
                       [t21[2], 0.0, -t21[0]],
                       [-t21[1], t21[0], 0.0]])
        E = tx @ R21  # [t21]x R21
        keep = _sampson_sq(_t64(E), _t64(pts1), _t64(pts2)).numpy() < thresh * thresh
    inl = keep
    if inl.sum() < min_inliers:
        return False, R, np.zeros(3), inl
    # cheirality: triangulate inliers, flip t if depths vote negative
    d1, d2 = (d.numpy() for d in _triangulate_pair(_t64(R21), _t64(t21), _t64(pts1),
                                                   _t64(pts2)))
    pos = int(np.sum((d1 > 0) & (d2 > 0) & inl))
    neg = int(np.sum((d1 < 0) & (d2 < 0) & inl))
    if neg > pos:
        t21 = -t21
    T = -R21.T @ t21  # cam2 position in cam1
    return True, np.asarray(R), T, inl


def solve_relative_pose(pts1, pts2, thresh: float = 0.3 / 460.0, n_hyp: int = 256,
                        min_inliers: int = 15, seed: int = 0):
    """pts1, pts2: (n, 2|3) normalized-plane correspondences (camera 1 and
    2). Returns (ok, R, T, inlier_mask) with (R, T) = pose of cam2 in cam1
    frame (solve_5pts.cpp convention). Mirrors the reference gates: needs
    >= 15 correspondences and > 12 inliers (:206, :225). The hypotheses'
    samples come from numpy's generator seeded with `seed`, as in the
    reference, so both packages test the same ones."""
    pts1 = np.asarray(pts1)[:, :2]
    pts2 = np.asarray(pts2)[:, :2]
    n = len(pts1)
    if n < max(15, 8):
        return False, np.eye(3), np.zeros(3), np.zeros(n, bool)
    rng = np.random.default_rng(seed)
    samples = np.stack([rng.choice(n, size=8, replace=False) for _ in range(n_hyp)])
    R21, t21, inl, n_inl, votes = _ransac_core(
        _t64(pts1), _t64(pts2), torch.ones(n, dtype=torch.bool),
        torch.as_tensor(samples), thresh * thresh)
    inl = inl.numpy()
    if int(n_inl) <= 12 or int(votes) < 0.5 * int(n_inl):
        return False, np.eye(3), np.zeros(3), inl
    # world-to-cam2 -> pose of cam2 in cam1: R = R21^T, T = -R21^T t
    R = R21.numpy().T
    return True, R, -R @ t21.numpy(), inl
