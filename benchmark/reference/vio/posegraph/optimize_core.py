"""The pose graph's dense Gauss-Newton with per-pose covariance: a frozen
copy of isvins_tpu_torch/posegraph/optimize.py's _optimize_core and of
parallel/distributed.py's _huber_weight; `cov_at` evaluates the final
normal equations and covariance at given poses instead of the solved ones
(the benchmark's reference reads the program's covariance at the program's
own poses)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..factors.preintegration import cholesky_nan
from ..factors.priors import relpose_residual_jacobians, rollpitch_residual_jacobians
from ..geom import quat_mul, quat_normalize, so3_exp_quat

def _huber_weight(r_norm_sq, delta):
    """sqrt of the IRLS weight for Huber loss rho(s) with s = ||r||^2."""
    r = torch.sqrt(torch.clamp(r_norm_sq, min=1e-18))
    return torch.sqrt(torch.where(r <= delta, torch.ones_like(r), delta / r))


def _optimize_core(t, q, edge_dt, edge_dq, edge_sqrt, edge_valid,
                   rp_q, rp_sqrt, rp_valid,
                   loop_i, loop_j, loop_dt, loop_dq, loop_w, loop_valid,
                   fixed_mask, iters: int, huber_delta: float = 0.1, cov_at=None):
    """t (K,3), q (K,4) seed poses of the active segment, fixed_mask (K,)
    bool gauge-fixed poses; sequential edge k joins poses k and k+1 (rows
    [0, K-1) used); loop edges (L,) join loop_i (old) and loop_j (cur).
    Returns (t, q, cov blocks (K,6,6), cost)."""
    K = t.shape[0]
    D = 6 * K
    dtype, dev = t.dtype, t.device
    oh = lambda idx: F.one_hot(idx.long(), K).to(dtype)
    seq_oh_i, seq_oh_j = oh(torch.arange(K - 1, device=dev)), oh(torch.arange(1, K, device=dev))
    rp_oh = oh(torch.arange(K, device=dev))
    loop_oh_i, loop_oh_j = oh(loop_i), oh(loop_j)
    seq_m = edge_valid[:-1].to(dtype)
    rp_m = rp_valid.to(dtype)
    loop_s = torch.sqrt(torch.clamp(loop_w, min=0.0))
    colmask = torch.repeat_interleave(~fixed_mask, 6).to(dtype)
    eye = torch.eye(D, dtype=dtype, device=dev)

    def expand(Jb, onehot):
        return torch.einsum("nrk,nb->nrbk", Jb, onehot).reshape(Jb.shape[0], Jb.shape[1], D)

    def build(tt, qq, anneal=None):
        """H, b, cost at (tt, qq). anneal: None for plain Huber(delta);
        else a scalar in (0, 1] that raises each loop edge's Huber delta to
        max(delta, anneal * ||r_w||) (graduated non-convexity)."""
        r, Ji, Jj = relpose_residual_jacobians(edge_dt[:-1], edge_dq[:-1], tt[:-1], qq[:-1],
                                               tt[1:], qq[1:])
        S = edge_sqrt[:-1] * seq_m[:, None, None]
        r_s, Ji_s, Jj_s = (S @ r[..., None])[..., 0], S @ Ji, S @ Jj

        r, J = rollpitch_residual_jacobians(rp_q, qq)
        S = rp_sqrt * rp_m[:, None, None]
        r_rp, J_rp = (S @ r[..., None])[..., 0], S @ J

        r, Ji, Jj = relpose_residual_jacobians(loop_dt, loop_dq, tt[loop_i], qq[loop_i],
                                               tt[loop_j], qq[loop_j])
        r_w = loop_s[:, None] * r
        rsq = torch.sum(r_w * r_w, dim=-1)
        delta = huber_delta
        if anneal is not None:
            delta = torch.clamp(anneal * torch.sqrt(rsq + 1e-18), min=huber_delta)
        m = loop_valid.to(dtype) * _huber_weight(rsq, delta) * loop_s
        r_l, Ji_l, Jj_l = r * m[:, None], Ji * m[:, None, None], Jj * m[:, None, None]

        J = torch.cat([(expand(Ji_s, seq_oh_i) + expand(Jj_s, seq_oh_j)).reshape(-1, D),
                       expand(J_rp, rp_oh).reshape(-1, D),
                       (expand(Ji_l, loop_oh_i) + expand(Jj_l, loop_oh_j)).reshape(-1, D)])
        res = torch.cat([r_s.reshape(-1), r_rp.reshape(-1), r_l.reshape(-1)])
        J = J * colmask[None, :]  # gauge: zero columns of fixed poses
        H = J.T @ J + torch.diag(1.0 - colmask)  # unit diagonal on fixed dims
        return H, -(J.T @ res), 0.5 * torch.sum(res * res)

    for i in range(iters):
        anneal = torch.exp(torch.tensor(-1.2 * i, dtype=dtype, device=dev))
        H, b, _ = build(t, q, anneal)
        dx = torch.cholesky_solve(b[:, None], cholesky_nan(H + 1e-8 * eye))[:, 0]
        d = dx.reshape(K, 6)
        t = t + d[:, :3]
        q = quat_normalize(quat_mul(q, so3_exp_quat(d[:, 3:])))
    if cov_at is not None:  # the covariance at other poses (t, q), as given
        t, q = (x.to(dtype) for x in cov_at)
    H, _, cost = build(t, q)
    Hinv = torch.cholesky_solve(eye, cholesky_nan(H + 1e-8 * eye))
    cov = Hinv.reshape(K, 6, K, 6).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    return t, q, cov, cost
