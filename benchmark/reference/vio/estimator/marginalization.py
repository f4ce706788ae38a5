"""Two-stage marginalization + information sparsification — the core of the
IS scheme (torch port of isvins_tpu/estimator/marginalization.py;
reference estimator.cpp:667–1539).

The information of marginalized variables is re-expressed as a sparse set
of nonlinear pseudo-measurement factors:
- init_sparsify  (initFactorGraph): from the Vo-segment IMU chain after the
  first full-window BA, recover {Vo-1 relative-pose edges, an SE3 prior on
  pose 0, a speed/bias prior on frame Vo-1};
- marg_forward   (MargForward): collapse {pose 0, its frame-0/1 landmarks}
  into a refreshed SE3 prior on pose 1 and a pose-graph packet;
- marg_backward  (MargBackward): collapse the speed/bias of frame Vo-1
  through the IMU factor (Vo-1 -> Vo) into {relative-pose edge (Vo-1, Vo),
  speed/bias prior on Vo, roll-pitch on Vo-1}.

Dense linear algebra on tiny matrices, in f64 on the caller's device. The
KLD between the recovered factor set and the truncated marginal is returned
as a diagnostic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..factors.preintegration import (
    Preintegration,
    cholesky_nan,
    imu_residual_jacobians,
    sqrt_info_from_cov,
)
from ..factors.projection import projection_residual_jacobians
from ..factors.priors import (
    relpose_residual_jacobians,
    rollpitch_residual_jacobians,
    se3_prior_residual_jacobians,
    yaw_residual_jacobians,
)
from ..geom import quat_conj, quat_mul, quat_normalize, quat_rotate
from ..solver.window import PriorState, RollPitchFactors, WindowState


class PoseGraphPacket(NamedTuple):
    """One VIO edge exported to the pose graph per MARGIN_OLD keyframe
    (pose_graph_factors.h:6–18)."""

    rel_dt: torch.Tensor  # (3,)
    rel_dq: torch.Tensor  # (4,)
    cov_rel: torch.Tensor  # (6,6)
    has_rollpitch: torch.Tensor  # () bool
    rp_q: torch.Tensor  # (4,)
    cov_abs: torch.Tensor  # (2,2)
    anchor_t: torch.Tensor  # (3,)
    anchor_q: torch.Tensor  # (4,)
    ts: torch.Tensor  # ()
    distance: torch.Tensor  # ()


def _info(sqrt):
    return sqrt.transpose(-1, -2) @ sqrt


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _accum(Lam, blocks):
    """Add each (row, col, M) block and, off the diagonal, its transpose."""
    Lam = Lam.clone()
    for (r, c, M) in blocks:
        Lam[r: r + M.shape[0], c: c + M.shape[1]] += M
        if r != c:
            Lam[c: c + M.shape[1], r: r + M.shape[0]] += M.T
    return Lam


def _hessian_blocks(jacs_with_offsets, W):
    """Upper-triangle Hessian blocks J_a^T W J_b for _accum."""
    out = []
    for a, (ra, Ja) in enumerate(jacs_with_offsets):
        JtW = Ja.T @ W
        for b, (rb, Jb) in enumerate(jacs_with_offsets):
            if b >= a:
                out.append((ra, rb, JtW @ Jb))
    return out


def _spd_solve(M, B, rel_eps: float = 0.0):
    n = M.shape[0]
    if rel_eps:
        M = M + rel_eps * torch.clamp(torch.max(torch.abs(torch.diagonal(M))), min=1.0) * _eye(n, M)
    return torch.cholesky_solve(B, cholesky_nan(M))


def _spd_inv(M, rel_eps: float = 0.0):
    return _spd_solve(M, _eye(M.shape[0], M), rel_eps)


def _schur_keep_head(Lam, keep: int, rel_eps: float = 1e-10):
    """Marginalize the tail block: Lam_rr - Lam_rm Lam_mm^{-1} Lam_mr."""
    rr, rm, mm = Lam[:keep, :keep], Lam[:keep, keep:], Lam[keep:, keep:]
    scale = torch.clamp(torch.diagonal(mm), min=0.0)
    jitter = rel_eps * torch.clamp(torch.max(scale), min=1.0)
    mm = mm + jitter * _eye(mm.shape[0], mm)
    out = rr - rm @ _spd_solve(mm, rm.T)
    return 0.5 * (out + out.T)


def _eig_truncated(Lam_prior, alpha):
    """eigh + keep lambda > alpha (estimator.cpp:920–938); dropped
    directions become zero columns (static shapes)."""
    w, V = torch.linalg.eigh(Lam_prior)
    keep = w > alpha
    w_safe = torch.where(keep, w, torch.ones_like(w))
    inv_w = torch.where(keep, 1.0 / w_safe, torch.zeros_like(w))
    return V * keep[None, :].to(V.dtype), inv_w, keep


def _recovered_cov(J_i, U, inv_w):
    JU = J_i @ U
    return (JU * inv_w[None, :]) @ JU.T


def _kld_diagnostic(Jr, U, inv_w, keep, infos_with_offsets):
    """estimator.cpp:974–988: X = blockdiag of recovered infos;
    A = (Jr U)^T X (Jr U) should equal D on the kept subspace."""
    X = torch.zeros((Jr.shape[0], Jr.shape[0]), dtype=Jr.dtype, device=Jr.device)
    for off, info in infos_with_offsets:
        X[off: off + info.shape[0], off: off + info.shape[0]] += info
    JU = Jr @ U
    A = JU.T @ X @ JU
    k = keep.to(Jr.dtype)
    A_k = A * k[:, None] * k[None, :] + torch.diag(1.0 - k)
    a = torch.sum(torch.diagonal(A_k) * torch.where(keep, inv_w, torch.zeros_like(inv_w)))
    L = cholesky_nan(A_k + 1e-14 * _eye(A_k.shape[0], A_k))
    logdet_b = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    logdet_Dinv = torch.sum(torch.where(keep, torch.log(torch.where(keep, inv_w, torch.ones_like(inv_w))),
                                        torch.zeros_like(inv_w)))
    return 0.5 * (a - logdet_b - logdet_Dinv - torch.sum(k))


def _pre_at(pre: Preintegration, k):
    return Preintegration(*(a[k] for a in pre))


# --------------------------------------------------------------------------
def init_sparsify(state: WindowState, pre_vo: Preintegration, G, Vo: int, alpha: float):
    """initFactorGraph (estimator.cpp:745–999). Returns (PriorState, kld)."""
    dtype, dev = state.P.dtype, state.P.device
    n_pose = 6 * Vo
    asize = n_pose + 9
    total = 15 * Vo

    def vb_off(i):  # column order: T0..T_{Vo-1} | VB_{Vo-1} | VB_0..VB_{Vo-2}
        return asize + 9 * i if i < Vo - 1 else n_pose

    Lam = torch.zeros((total, total), dtype=dtype, device=dev)
    S = sqrt_info_from_cov(pre_vo.cov, rel_jitter=1e-12)
    for k in range(Vo - 1):
        _, J_pi, J_vbi, J_pj, J_vbj = imu_residual_jacobians(
            _pre_at(pre_vo, k), G,
            state.P[k], state.Q[k], state.V[k], state.Ba[k], state.Bg[k],
            state.P[k + 1], state.Q[k + 1], state.V[k + 1], state.Ba[k + 1], state.Bg[k + 1],
        )
        jacs = [(6 * k, J_pi), (vb_off(k), J_vbi), (6 * (k + 1), J_pj), (vb_off(k + 1), J_vbj)]
        Lam = _accum(Lam, _hessian_blocks(jacs, S[k].T @ S[k]))
    Lam_prior = _schur_keep_head(Lam, asize)

    rel_dt, rel_dq = [], []
    Jr = torch.zeros((asize, asize), dtype=dtype, device=dev)
    rows = 0
    for k in range(1, Vo):
        i = k - 1
        dt_m = quat_rotate(quat_conj(state.Q[i]), state.P[k] - state.P[i])
        dq_m = quat_normalize(quat_mul(quat_conj(state.Q[i]), state.Q[k]))
        rel_dt.append(dt_m)
        rel_dq.append(dq_m)
        _, Ji, Jj = relpose_residual_jacobians(dt_m, dq_m, state.P[i], state.Q[i],
                                               state.P[k], state.Q[k])
        Jr[rows: rows + 6, 6 * i: 6 * i + 6] += Ji
        Jr[rows: rows + 6, 6 * k: 6 * k + 6] += Jj
        rows += 6
    _, J_se3 = se3_prior_residual_jacobians(state.P[0], state.Q[0], state.P[0], state.Q[0])
    Jr[rows: rows + 6, 0:6] += J_se3
    se3_row = rows
    rows += 6
    Jr[rows: rows + 9, n_pose: n_pose + 9] += _eye(9, Jr)
    vb_row = rows

    U, inv_w, keep = _eig_truncated(Lam_prior, alpha)
    ident = torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=dev)
    rel_sqrt = [torch.zeros((6, 6), dtype=dtype, device=dev)]
    infos = []
    for r, k in zip(range(0, 6 * (Vo - 1), 6), range(1, Vo)):
        sq = sqrt_info_from_cov(_recovered_cov(Jr[r: r + 6], U, inv_w), rel_jitter=1e-10)
        rel_sqrt.append(sq)
        infos.append((r, _info(sq)))
    se3_sqrt = sqrt_info_from_cov(_recovered_cov(Jr[se3_row: se3_row + 6], U, inv_w),
                                  rel_jitter=1e-10)
    infos.append((se3_row, _info(se3_sqrt)))
    vb_sqrt = sqrt_info_from_cov(_recovered_cov(Jr[vb_row: vb_row + 9], U, inv_w),
                                 rel_jitter=1e-10)
    infos.append((vb_row, _info(vb_sqrt)))
    kld = _kld_diagnostic(Jr, U, inv_w, keep, infos)

    priors = PriorState(
        se3_t=state.P[0], se3_q=state.Q[0], se3_sqrt=se3_sqrt,
        se3_valid=torch.tensor(True, device=dev),
        vb=torch.cat([state.V[Vo - 1], state.Ba[Vo - 1], state.Bg[Vo - 1]]),
        vb_sqrt=vb_sqrt, vb_valid=torch.tensor(True, device=dev),
        rel_dt=torch.stack([torch.zeros(3, dtype=dtype, device=dev)] + rel_dt),
        rel_dq=torch.stack([ident] + rel_dq),
        rel_sqrt=torch.stack(rel_sqrt),
        rel_valid=torch.arange(Vo, device=dev) >= 1,
        rp=RollPitchFactors(
            q_meas=ident.expand(Vo, 4).clone(),
            sqrt_info=torch.zeros((Vo, 2, 2), dtype=dtype, device=dev),
            idx=torch.zeros(Vo, dtype=torch.int32, device=dev),
            valid=torch.zeros(Vo, dtype=torch.bool, device=dev),
        ),
    )
    return priors, kld


# --------------------------------------------------------------------------
def marg_forward(state: WindowState, priors: PriorState, marg_pts_i, marg_pts_j, marg_fidx,
                 marg_valid, pixel_sqrt_info, alpha: float, ts0):
    """MargForward (estimator.cpp:1149–1352): marginalizes pose 0 and the
    frame-0-hosted landmarks observed at frame 1.
    Returns (se3_t1, se3_q1, se3_sqrt1, packet: PoseGraphPacket, kld)."""
    dtype, dev = state.P.dtype, state.P.device
    L = marg_pts_i.shape[0]
    dim = 12 + L
    # order: T1 (0:6) | T0 (6:12) | landmarks (12:12+L)
    Lam = torch.zeros((dim, dim), dtype=dtype, device=dev)

    d = state.dep[marg_fidx.long()]
    d = torch.where(marg_valid & (d.abs() > 1e-8), d, torch.ones_like(d))
    ex = lambda a: a.expand(L, a.shape[-1])
    _, J_p0, J_p1, _, J_d = projection_residual_jacobians(
        marg_pts_i, marg_pts_j, ex(state.P[0]), ex(state.Q[0]), ex(state.P[1]),
        ex(state.Q[1]), state.tic, state.qic, d)
    m = marg_valid.to(dtype)
    J_p0, J_p1, J_d = J_p0 * m[:, None, None], J_p1 * m[:, None, None], J_d * m[:, None]
    w2 = torch.as_tensor(pixel_sqrt_info, dtype=dtype, device=dev) ** 2
    Lam[0:6, 0:6] += w2 * torch.einsum("nri,nrj->ij", J_p1, J_p1)
    Lam[6:12, 6:12] += w2 * torch.einsum("nri,nrj->ij", J_p0, J_p0)
    c01 = w2 * torch.einsum("nri,nrj->ij", J_p1, J_p0)
    Lam[0:6, 6:12] += c01
    Lam[6:12, 0:6] += c01.T
    g1 = w2 * torch.einsum("nri,nr->ni", J_p1, J_d)
    g0 = w2 * torch.einsum("nri,nr->ni", J_p0, J_d)
    hl = w2 * torch.sum(J_d * J_d, dim=-1)
    Lam[0:6, 12:] += g1.T
    Lam[12:, 0:6] += g1
    Lam[6:12, 12:] += g0.T
    Lam[12:, 6:12] += g0
    idx = torch.arange(L, device=dev)
    Lam[12 + idx, 12 + idx] += hl

    # SE3 prior on T0 and relpose edge (0,1)
    _, J_se3 = se3_prior_residual_jacobians(priors.se3_t, priors.se3_q, state.P[0], state.Q[0])
    Lam[6:12, 6:12] += J_se3.T @ _info(priors.se3_sqrt) @ J_se3
    _, Ji, Jj = relpose_residual_jacobians(priors.rel_dt[1], priors.rel_dq[1], state.P[0],
                                           state.Q[0], state.P[1], state.Q[1])
    Lam = _accum(Lam, _hessian_blocks([(6, Ji), (0, Jj)], _info(priors.rel_sqrt[1])))

    # pose-graph edge via pseudo-inverse projection (:1243–1259)
    Lam_rp = Lam[0:12, 0:12]
    dt_m = quat_rotate(quat_conj(state.Q[0]), state.P[1] - state.P[0])
    dq_m = quat_normalize(quat_mul(quat_conj(state.Q[0]), state.Q[1]))
    _, Jpi, Jpj = relpose_residual_jacobians(dt_m, dq_m, state.P[0], state.Q[0],
                                             state.P[1], state.Q[1])
    Jpg = torch.cat([Jpj, Jpi], dim=1)  # T1 columns | T0 columns
    Jpinv = torch.linalg.pinv(Jpg, rtol=1e-8)
    rp_omega = Jpinv.T @ Lam_rp @ Jpinv
    rp_omega = 0.5 * (rp_omega + rp_omega.T)
    rp_cov = _spd_inv(rp_omega + 1e-12 * torch.trace(rp_omega) / 6 * _eye(6, rp_omega))

    sel = (priors.rp.idx == 0) & priors.rp.valid
    has_rp = torch.any(sel)
    rp_slot = torch.argmax(sel.to(torch.int32))
    rp_q = priors.rp.q_meas[rp_slot]
    rp_info = _info(priors.rp.sqrt_info[rp_slot])
    cov_abs = _spd_inv(rp_info + (1.0 - has_rp.to(dtype)) * _eye(2, rp_info)
                       + 1e-12 * _eye(2, rp_info))
    packet = PoseGraphPacket(
        rel_dt=dt_m, rel_dq=dq_m, cov_rel=rp_cov, has_rollpitch=has_rp, rp_q=rp_q,
        cov_abs=cov_abs, anchor_t=state.P[0], anchor_q=state.Q[0],
        ts=torch.as_tensor(ts0, dtype=dtype, device=dev), distance=torch.linalg.norm(dt_m),
    )

    # Schur-eliminate [T0, landmarks] -> prior on T1; recover its SE3 prior
    Lam_prior = _schur_keep_head(Lam, 6)
    _, Jr1 = se3_prior_residual_jacobians(state.P[1], state.Q[1], state.P[1], state.Q[1])
    U, inv_w, keep = _eig_truncated(Lam_prior, alpha)
    se3_sqrt1 = sqrt_info_from_cov(_recovered_cov(Jr1, U, inv_w), rel_jitter=1e-10)
    kld = _kld_diagnostic(Jr1, U, inv_w, keep, [(0, _info(se3_sqrt1))])
    return state.P[1], state.Q[1], se3_sqrt1, packet, kld


# --------------------------------------------------------------------------
def marg_backward(state: WindowState, pre_vo: Preintegration, priors: PriorState, G,
                  Vo: int, alpha: float):
    """MargBackward (estimator.cpp:1354–1539): marginalizes VB_{Vo-1}.
    Returns (rel_dt, rel_dq, rel_sqrt [edge (Vo-1, Vo)], vb, vb_sqrt [prior
    on frame Vo], rp_q, rp_sqrt [roll-pitch on frame Vo-1], kld)."""
    dtype, dev = state.P.dtype, state.P.device
    i, j = Vo - 1, Vo
    # order: T_Vo (0:6) | VB_Vo (6:15) | T_{Vo-1} (15:21) | VB_{Vo-1} (21:30)
    Lam = torch.zeros((30, 30), dtype=dtype, device=dev)
    Lam[21:30, 21:30] += _info(priors.vb_sqrt)
    S = sqrt_info_from_cov(pre_vo.cov, rel_jitter=1e-12)
    _, J_pi, J_vbi, J_pj, J_vbj = imu_residual_jacobians(
        pre_vo, G,
        state.P[i], state.Q[i], state.V[i], state.Ba[i], state.Bg[i],
        state.P[j], state.Q[j], state.V[j], state.Ba[j], state.Bg[j],
    )
    Lam = _accum(Lam, _hessian_blocks([(15, J_pi), (21, J_vbi), (0, J_pj), (6, J_vbj)],
                                      S.T @ S))
    Lam_prior = _schur_keep_head(Lam, 21)

    dt_m = quat_rotate(quat_conj(state.Q[i]), state.P[j] - state.P[i])
    dq_m = quat_normalize(quat_mul(quat_conj(state.Q[i]), state.Q[j]))
    _, Jri, Jrj = relpose_residual_jacobians(dt_m, dq_m, state.P[i], state.Q[i],
                                             state.P[j], state.Q[j])
    vb_m = torch.cat([state.V[j], state.Ba[j], state.Bg[j]])
    rp_q = state.Q[i]
    _, J_rp = rollpitch_residual_jacobians(rp_q, state.Q[i])
    _, J_yaw = yaw_residual_jacobians(state.Q[i], state.Q[i])

    # Jr rows: relpose(6) | vb(9) | rollpitch(2) | abs-pos(3) | yaw(1)
    Jr = torch.zeros((21, 21), dtype=dtype, device=dev)
    Jr[0:6, 15:21] += Jri
    Jr[0:6, 0:6] += Jrj
    Jr[6:15, 6:15] += _eye(9, Jr)
    Jr[15:17, 15:21] += J_rp
    Jr[17:20, 15:18] += _eye(3, Jr)
    Jr[20:21, 15:21] += J_yaw

    U, inv_w, keep = _eig_truncated(Lam_prior, alpha)
    rel_sqrt = sqrt_info_from_cov(_recovered_cov(Jr[0:6], U, inv_w), rel_jitter=1e-10)
    vb_sqrt = sqrt_info_from_cov(_recovered_cov(Jr[6:15], U, inv_w), rel_jitter=1e-10)
    rp_sqrt = sqrt_info_from_cov(_recovered_cov(Jr[15:17], U, inv_w), rel_jitter=1e-10)
    cov_abs = _recovered_cov(Jr[17:20], U, inv_w)
    cov_yaw = _recovered_cov(Jr[20:21], U, inv_w)
    infos = [
        (0, _info(rel_sqrt)),
        (6, _info(vb_sqrt)),
        (15, _info(rp_sqrt)),
        (17, _spd_inv(cov_abs + 1e-12 * _eye(3, cov_abs))),
        (20, _spd_inv(cov_yaw + 1e-12 * _eye(1, cov_yaw))),
    ]
    kld = _kld_diagnostic(Jr, U, inv_w, keep, infos)
    return dt_m, dq_m, rel_sqrt, vb_m, vb_sqrt, rp_q, rp_sqrt, kld
