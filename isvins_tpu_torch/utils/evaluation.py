"""Trajectory evaluation: association + Umeyama SE3/4-DoF alignment + ATE
RMSE (replaces the external evo-style comparison the reference relies on;
BASELINE.md protocol)."""

from __future__ import annotations

import numpy as np


def associate(t_est, t_gt, max_dt: float = 0.02):
    """Nearest-timestamp association. Returns (idx_est, idx_gt)."""
    j = np.searchsorted(t_gt, t_est)
    j = np.clip(j, 1, len(t_gt) - 1)
    prev = j - 1
    pick = np.where(np.abs(t_gt[j] - t_est) < np.abs(t_gt[prev] - t_est), j, prev)
    ok = np.abs(t_gt[pick] - t_est) < max_dt
    return np.where(ok)[0], pick[ok]


def umeyama_align(X, Y, with_scale: bool = False):
    """Find (s, R, t) minimizing |s R X + t - Y|. X, Y: (n,3)."""
    mx = X.mean(0)
    my = Y.mean(0)
    Xc = X - mx
    Yc = Y - my
    C = Yc.T @ Xc / len(X)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = (np.trace(np.diag(D) @ S) / (Xc**2).sum(1).mean() * len(X) / len(X)) if with_scale else 1.0
    if with_scale:
        s = np.trace(np.diag(D) @ S) / (Xc**2).mean(0).sum()
    t = my - s * R @ mx
    return s, R, t


def ate_rmse(t_est, p_est, t_gt, p_gt, align: str = "se3"):
    """ATE RMSE after alignment ('se3', 'sim3', or 'none')."""
    ie, ig = associate(np.asarray(t_est), np.asarray(t_gt))
    if len(ie) < 3:
        return float("nan")
    X = np.asarray(p_est)[ie]
    Y = np.asarray(p_gt)[ig]
    if align == "none":
        err = X - Y
    else:
        s, R, t = umeyama_align(X, Y, with_scale=(align == "sim3"))
        err = (s * (R @ X.T)).T + t - Y
    return float(np.sqrt((err**2).sum(1).mean()))
