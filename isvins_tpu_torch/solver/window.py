"""Batched sliding-window bundle-adjustment solver (torch port of
isvins_tpu/solver/window.py).

Problem structure (estimator.cpp problemSolve :1004–1146):
- B pose blocks (6-dof) + B speed/bias blocks (9-dof) + 1 extrinsic (6-dof)
- B-1 IMU factors between consecutive frames (no robust loss)
- up to N inverse-depth projection factors, Cauchy(1.0), whitened by the
  pixel sqrt-info
- sparse nonlinear priors (IS scheme): SE3 prior on pose 0, speed/bias prior
  on frame Vo-1, Vo-1 relative-pose edges, roll-pitch edges, Cauchy(1.0)

The JAX one-hot einsums (MXU work on the TPU) become index_select /
index_add_ here; the landmark Schur elimination and the LM accept/reject are
as in the reference. Column layout of the full system (D = 15B + 6):
  pose i -> [6i, 6i+6),  vb i -> [6B + 9i, 6B + 9i + 9),  ex -> [15B, 15B+6)
and of the landmark coupling W (reduced, Dr = 6B + 6): [pose | ex].

Kernels (ops/): the f32 solve evaluates projection factors with K1, IMU
factors with K2 and takes each LM step with K4 (whose first launch is K3).
f64 solves (init BA, the init scale scan) call the plain versions, as the
reference's f64 solves keep its XLA path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..factors.preintegration import Preintegration, sqrt_info_from_cov
from ..factors.projection import projection_residual_jacobians
from ..factors.priors import (
    linear9_residual_jacobians,
    relpose_residual_jacobians,
    rollpitch_residual_jacobians,
    se3_prior_residual_jacobians,
)
from ..geom import quat_mul, quat_normalize, so3_exp_quat
from ..ops import proj as _proj_ops  # module: ops.proj imports solver.proj_fast
from ..ops.imu import imu_rows, imu_rows_ref
from ..ops.linstep import linstep, linstep_ref
from .proj_fast import eval_proj_rows


class WindowDims(NamedTuple):
    """Static problem shapes."""

    B: int  # window frames (ALL_BUF_SIZE = 18)
    Vo: int  # VO segment (Vo_SIZE = 8)
    F: int  # landmark capacity (NUM_OF_F = 1000)
    N: int  # projection-observation capacity

    @property
    def D(self) -> int:
        return 15 * self.B + 6


class WindowState(NamedTuple):
    P: torch.Tensor  # (B,3)
    Q: torch.Tensor  # (B,4) wxyz
    V: torch.Tensor  # (B,3)
    Ba: torch.Tensor  # (B,3)
    Bg: torch.Tensor  # (B,3)
    tic: torch.Tensor  # (3,)
    qic: torch.Tensor  # (4,)
    dep: torch.Tensor  # (F,) inverse depths


class ProjFactors(NamedTuple):
    idx_i: torch.Tensor  # (N,) int host frame
    idx_j: torch.Tensor  # (N,) int observing frame
    fidx: torch.Tensor  # (N,) int landmark slot
    pts_i: torch.Tensor  # (N,3) normalized bearing in host frame
    pts_j: torch.Tensor  # (N,3)
    valid: torch.Tensor  # (N,) bool


class ImuFactors(NamedTuple):
    pre: Preintegration  # stacked (B-1, ...), factor k connects frames k,k+1
    valid: torch.Tensor  # (B-1,) bool
    sqrt: torch.Tensor  # (B-1,15,15) whitening (cov is fixed per solve)

    @staticmethod
    def create(pre: Preintegration, valid) -> "ImuFactors":
        eye15 = torch.eye(15, dtype=pre.cov.dtype, device=pre.cov.device)
        cov = torch.where(valid[..., None, None], pre.cov, eye15)
        return ImuFactors(pre=pre, valid=valid, sqrt=sqrt_info_from_cov(cov, rel_jitter=1e-12))


class RollPitchFactors(NamedTuple):
    q_meas: torch.Tensor  # (K,4)
    sqrt_info: torch.Tensor  # (K,2,2)
    idx: torch.Tensor  # (K,) int frame index
    valid: torch.Tensor  # (K,) bool


class PriorState(NamedTuple):
    """The IS sparse nonlinear prior set (estimator.h:134–138)."""

    se3_t: torch.Tensor  # (3,)
    se3_q: torch.Tensor  # (4,)
    se3_sqrt: torch.Tensor  # (6,6)
    se3_valid: torch.Tensor  # () bool
    vb: torch.Tensor  # (9,)
    vb_sqrt: torch.Tensor  # (9,9)
    vb_valid: torch.Tensor  # () bool
    rel_dt: torch.Tensor  # (Vo,3)   edge k connects (k-1, k); slot 0 unused
    rel_dq: torch.Tensor  # (Vo,4)
    rel_sqrt: torch.Tensor  # (Vo,6,6)
    rel_valid: torch.Tensor  # (Vo,) bool
    rp: RollPitchFactors  # capacity Vo

    @staticmethod
    def empty(Vo: int, dtype=None) -> "PriorState":
        """Host (numpy, f64 by default) empty prior set: the estimator keeps
        and mutates priors in host memory; solves move them to the device."""
        dtype = dtype or np.float64
        ident = np.array([1.0, 0, 0, 0], dtype)
        return PriorState(
            se3_t=np.zeros(3, dtype), se3_q=ident.copy(),
            se3_sqrt=np.zeros((6, 6), dtype), se3_valid=np.asarray(False),
            vb=np.zeros(9, dtype), vb_sqrt=np.zeros((9, 9), dtype),
            vb_valid=np.asarray(False),
            rel_dt=np.zeros((Vo, 3), dtype), rel_dq=np.tile(ident, (Vo, 1)),
            rel_sqrt=np.zeros((Vo, 6, 6), dtype), rel_valid=np.zeros(Vo, bool),
            rp=RollPitchFactors(
                q_meas=np.tile(ident, (Vo, 1)), sqrt_info=np.zeros((Vo, 2, 2), dtype),
                idx=np.zeros(Vo, np.int32), valid=np.zeros(Vo, bool),
            ),
        )


def _cauchy_weight(r_sq):
    """Ceres CauchyLoss(1): rho(s) = log(1+s); IRLS weight sqrt(rho'(s))."""
    return torch.sqrt(1.0 / (1.0 + r_sq))


def _cauchy_rho(r_sq):
    return torch.log1p(r_sq)


def retract_state(state: WindowState, dx, dl, dims: WindowDims) -> WindowState:
    """Manifold plus: p+dp, q*Exp(dtheta); additive on v/ba/bg/ex-trans/depth."""
    B = dims.B
    d_pose = dx[: 6 * B].reshape(B, 6)
    d_vb = dx[6 * B: 15 * B].reshape(B, 9)
    d_ex = dx[15 * B:]
    return WindowState(
        P=state.P + d_pose[:, :3],
        Q=quat_normalize(quat_mul(state.Q, so3_exp_quat(d_pose[:, 3:]))),
        V=state.V + d_vb[:, :3],
        Ba=state.Ba + d_vb[:, 3:6],
        Bg=state.Bg + d_vb[:, 6:9],
        tic=state.tic + d_ex[:3],
        qic=quat_normalize(quat_mul(state.qic, so3_exp_quat(d_ex[3:]))),
        dep=state.dep + dl,
    )


def _eval_imu(state: WindowState, imu: ImuFactors, G, dims: WindowDims):
    """Whitened residuals (B-1,15) + dense rows (B-1,15,D) + cost vector."""
    B, D = dims.B, dims.D
    dtype, dev = state.P.dtype, state.P.device
    pre = imu.pre
    args = (state.P[:-1], state.Q[:-1], state.V[:-1], state.Ba[:-1], state.Bg[:-1],
            state.P[1:], state.Q[1:], state.V[1:], state.Ba[1:], state.Bg[1:],
            pre.delta_p, pre.delta_q, pre.delta_v, pre.sum_dt, pre.ba, pre.bg, pre.jac, G)
    rows = imu_rows if dtype == torch.float32 else imu_rows_ref
    r, Jcat = rows(*(a.contiguous() for a in args))
    w = imu.valid.to(dtype)[:, None]
    S = imu.sqrt
    Jcat = (S @ Jcat) * w[..., None]
    r_w = (S @ r[..., None])[..., 0] * w

    n = B - 1
    k = torch.arange(n, device=dev)
    pose = torch.zeros((n, 15, B, 6), dtype=dtype, device=dev)
    vb = torch.zeros((n, 15, B, 9), dtype=dtype, device=dev)
    pose[k, :, k] = Jcat[:, :, 0:6]
    vb[k, :, k] = Jcat[:, :, 6:15]
    pose[k, :, k + 1] = Jcat[:, :, 15:21]
    vb[k, :, k + 1] = Jcat[:, :, 21:30]
    Jrows = torch.cat([pose.reshape(n, 15, 6 * B), vb.reshape(n, 15, 9 * B),
                       torch.zeros((n, 15, 6), dtype=dtype, device=dev)], dim=2)
    cvec = 0.5 * torch.sum(r_w * r_w, dim=1)
    return r_w, Jrows, cvec


def _eval_proj(state: WindowState, proj: ProjFactors, pixel_sqrt_info, dims: WindowDims,
               estimate_extrinsic: bool = False):
    """Whitened+robust projection residuals (N,2), compact block Jacobians
    J_pi/J_pj/J_ex (N,2,6), landmark partials (N,2) and the cost vector."""
    dtype = state.P.dtype
    idx_i, idx_j, fidx = proj.idx_i.long(), proj.idx_j.long(), proj.fidx.long()
    P_i = state.P.index_select(0, idx_i)
    Q_i = state.Q.index_select(0, idx_i)
    P_j = state.P.index_select(0, idx_j)
    Q_j = state.Q.index_select(0, idx_j)
    dep_g = state.dep.index_select(0, fidx)

    if not estimate_extrinsic:
        rows = _proj_ops.proj_rows if dtype == torch.float32 else eval_proj_rows
        r, J_pi, J_pj, J_dep = rows(
            proj.pts_i.contiguous(), proj.pts_j.contiguous(), P_i, Q_i, P_j, Q_j,
            state.tic.contiguous(), state.qic.contiguous(), dep_g, proj.valid)
        J_ex = torch.zeros_like(J_pi)
    else:
        # sanitize BEFORE evaluation: masked rows must not produce NaN
        d = torch.where(proj.valid & (dep_g.abs() > 1e-8), dep_g, torch.ones_like(dep_g))
        r, J_pi, J_pj, J_ex, J_dep = projection_residual_jacobians(
            proj.pts_i, proj.pts_j, P_i, Q_i, P_j, Q_j, state.tic, state.qic, d)
    s = pixel_sqrt_info
    vw = proj.valid.to(dtype)
    r_sq = torch.sum((s * r) ** 2, dim=-1)
    w = (s * _cauchy_weight(r_sq)) * vw
    r_w = r * w[:, None]
    J_pi = J_pi * w[:, None, None]
    J_pj = J_pj * w[:, None, None]
    J_ex = J_ex * w[:, None, None]
    J_dep = J_dep * w[:, None]
    cvec = 0.5 * _cauchy_rho(r_sq) * vw
    return r_w, J_pi, J_pj, J_ex, J_dep, cvec


def _eval_priors(state: WindowState, priors: PriorState, dims: WindowDims):
    """All sparse nonlinear priors -> list of (r_w, Jrows) + cost vector,
    each Cauchy(1.0) (estimator.cpp:1102–1117)."""
    B, Vo, D = dims.B, dims.Vo, dims.D
    dtype, dev = state.P.dtype, state.P.device
    rows, cvecs = [], []

    def robust(r_w, valid):
        """Per-factor Cauchy weight and cost of whitened residuals (...,r)."""
        s = torch.sum(r_w * r_w, dim=-1)
        v = valid.to(dtype)
        return _cauchy_weight(s) * v, 0.5 * _cauchy_rho(s) * v

    mv = lambda S, r: (S @ r[..., None])[..., 0]

    # SE3 prior on pose 0
    r, J = se3_prior_residual_jacobians(priors.se3_t, priors.se3_q, state.P[0], state.Q[0])
    r_w = mv(priors.se3_sqrt, r)
    w, c = robust(r_w, priors.se3_valid)
    Jrow = torch.zeros((6, D), dtype=dtype, device=dev)
    Jrow[:, 0:6] = (priors.se3_sqrt @ J) * w
    rows.append((r_w * w, Jrow))
    cvecs.append(c.reshape(1))

    # VB prior on frame Vo-1
    k = Vo - 1
    r, J = linear9_residual_jacobians(priors.vb, state.V[k], state.Ba[k], state.Bg[k])
    r_w = mv(priors.vb_sqrt, r)
    w, c = robust(r_w, priors.vb_valid)
    Jrow = torch.zeros((9, D), dtype=dtype, device=dev)
    Jrow[:, 6 * B + 9 * k: 6 * B + 9 * k + 9] = (priors.vb_sqrt @ J) * w
    rows.append((r_w * w, Jrow))
    cvecs.append(c.reshape(1))

    # relative-pose edges (k-1, k), k = 1..Vo-1; slot 0 is inert: its
    # i-side block has no frame (jax.nn.one_hot(-1) is a zero row), so it
    # is masked explicitly rather than indexed with -1 (which would wrap)
    ks = torch.arange(Vo, device=dev)
    km1 = torch.clamp(ks - 1, min=0)
    r, Ji, Jj = relpose_residual_jacobians(
        priors.rel_dt, priors.rel_dq, state.P[km1], state.Q[km1], state.P[ks], state.Q[ks])
    S = priors.rel_sqrt
    r_w = mv(S, r)
    w, c = robust(r_w, priors.rel_valid)
    Jrel = torch.zeros((Vo, 6, B, 6), dtype=dtype, device=dev)
    Jrel[ks[1:], :, ks[1:] - 1] += ((S @ Ji) * w[:, None, None])[1:]
    Jrel[ks, :, ks] += (S @ Jj) * w[:, None, None]
    Jfull = torch.zeros((Vo, 6, D), dtype=dtype, device=dev)
    Jfull[:, :, : 6 * B] = Jrel.reshape(Vo, 6, 6 * B)
    rows.append(((r_w * w[:, None]).reshape(-1), Jfull.reshape(-1, D)))
    cvecs.append(c)

    # roll-pitch edges
    K = priors.rp.idx.shape[0]
    idx = priors.rp.idx.long()
    r, J = rollpitch_residual_jacobians(priors.rp.q_meas, state.Q[idx])
    S = priors.rp.sqrt_info
    r_w = mv(S, r)
    w, c = robust(r_w, priors.rp.valid)
    Jrp = torch.zeros((K, 2, B, 6), dtype=dtype, device=dev)
    kk = torch.arange(K, device=dev)
    Jrp[kk, :, idx] = (S @ J) * w[:, None, None]
    Jfull = torch.zeros((K, 2, D), dtype=dtype, device=dev)
    Jfull[:, :, : 6 * B] = Jrp.reshape(K, 2, 6 * B)
    rows.append(((r_w * w[:, None]).reshape(-1), Jfull.reshape(-1, D)))
    cvecs.append(c)
    return rows, torch.cat(cvecs)


def build_normal_equations(state: WindowState, imu: ImuFactors, proj: ProjFactors,
                           priors: PriorState, G, pixel_sqrt_info, dims: WindowDims,
                           estimate_extrinsic: bool = False):
    """Returns (H (D,D), b (D,), h (F,), W (F,Dr), b_l (F,), cost) with the
    landmark coupling W in the reduced layout Dr = 6B+6 ([pose | ex]).
    The projection Hessian is accumulated block-wise: per observation the
    compact 6x6 products are formed and added into the (B,B) block grid."""
    B, F, D = dims.B, dims.F, dims.D
    Dr = 6 * B + 6
    dtype, dev = state.P.dtype, state.P.device

    r_imu, J_imu, cv_imu = _eval_imu(state, imu, G, dims)
    r_proj, J_pi, J_pj, J_ex, J_dep, cv_proj = _eval_proj(
        state, proj, pixel_sqrt_info, dims, estimate_extrinsic)
    prior_rows, cv_prior = _eval_priors(state, priors, dims)

    Jip = torch.cat([J_imu.reshape(-1, D)] + [J for _, J in prior_rows], dim=0)
    rip = torch.cat([r_imu.reshape(-1)] + [r for r, _ in prior_rows], dim=0)
    if not estimate_extrinsic:
        Jip = torch.cat([Jip[:, : 15 * B], torch.zeros_like(Jip[:, 15 * B:])], dim=1)
    H = Jip.T @ Jip
    b = -(Jip.T @ rip)

    # ---- projection block accumulation ----
    idx_i, idx_j, fidx = proj.idx_i.long(), proj.idx_j.long(), proj.fidx.long()
    G_ii = J_pi.transpose(1, 2) @ J_pi
    G_jj = J_pj.transpose(1, 2) @ J_pj
    G_ij = J_pi.transpose(1, 2) @ J_pj
    g_i = (J_pi.transpose(1, 2) @ r_proj[..., None])[..., 0]
    g_j = (J_pj.transpose(1, 2) @ r_proj[..., None])[..., 0]

    diag = torch.zeros((B, 6, 6), dtype=dtype, device=dev)
    diag.index_add_(0, idx_i, G_ii)
    diag.index_add_(0, idx_j, G_jj)
    offd = torch.zeros((B * B, 6, 6), dtype=dtype, device=dev)
    offd.index_add_(0, idx_i * B + idx_j, G_ij)
    offd = offd.reshape(B, B, 6, 6)
    Hblk = offd + offd.permute(1, 0, 3, 2)
    ar = torch.arange(B, device=dev)
    Hblk[ar, ar] += diag
    H_pose = Hblk.permute(0, 2, 1, 3).reshape(6 * B, 6 * B)
    gb = torch.zeros((B, 6), dtype=dtype, device=dev)
    gb.index_add_(0, idx_i, g_i)
    gb.index_add_(0, idx_j, g_j)

    H[: 6 * B, : 6 * B] += H_pose
    b[: 6 * B] -= gb.reshape(6 * B)

    # landmark coupling rows (compact)
    wi = (J_dep[:, None, :] @ J_pi)[:, 0]  # (N,6)
    wj = (J_dep[:, None, :] @ J_pj)[:, 0]
    n = J_dep.shape[0]
    on = torch.arange(n, device=dev)
    Wrows = torch.zeros((n, B, 6), dtype=dtype, device=dev)
    Wrows.index_put_((on, idx_i), wi, accumulate=True)
    Wrows.index_put_((on, idx_j), wj, accumulate=True)
    Wrows = Wrows.reshape(n, 6 * B)

    if estimate_extrinsic:
        G_ie = J_pi.transpose(1, 2) @ J_ex
        G_je = J_pj.transpose(1, 2) @ J_ex
        G_ee = torch.einsum("nra,nrb->ab", J_ex, J_ex)
        g_e = torch.einsum("nra,nr->a", J_ex, r_proj)
        E = torch.zeros((B, 6, 6), dtype=dtype, device=dev)
        E.index_add_(0, idx_i, G_ie)
        E.index_add_(0, idx_j, G_je)
        E_rows = E.reshape(6 * B, 6)
        H[: 6 * B, 15 * B:] += E_rows
        H[15 * B:, : 6 * B] += E_rows.T
        H[15 * B:, 15 * B:] += G_ee
        b[15 * B:] -= g_e
        we = (J_dep[:, None, :] @ J_ex)[:, 0]
        Wrows = torch.cat([Wrows, we], dim=1)
    else:
        H[15 * B:, 15 * B:] += torch.eye(6, dtype=dtype, device=dev)
        Wrows = torch.cat([Wrows, torch.zeros((n, 6), dtype=dtype, device=dev)], dim=1)

    # landmark system: per-feature scalar Hessian + coupling row + rhs
    payload = torch.cat([
        torch.sum(J_dep * J_dep, dim=-1, keepdim=True),
        Wrows,
        -torch.sum(J_dep * r_proj, dim=-1, keepdim=True),
    ], dim=1)
    agg = torch.zeros((F, Dr + 2), dtype=dtype, device=dev)
    agg.index_add_(0, fidx, payload)
    h = agg[:, 0].contiguous()
    W = agg[:, 1: 1 + Dr].contiguous()
    b_l = agg[:, 1 + Dr].contiguous()

    cost = torch.sum(torch.cat([cv_imu, cv_proj, cv_prior]))
    return H, b, h, W, b_l, cost


def window_cost(state, imu, proj, priors, G, pixel_sqrt_info, dims):
    """Robust cost only."""
    _, _, cv_imu = _eval_imu(state, imu, G, dims)
    cv_proj = _eval_proj(state, proj, pixel_sqrt_info, dims)[5]
    _, cv_prior = _eval_priors(state, priors, dims)
    return torch.sum(torch.cat([cv_imu, cv_proj, cv_prior]))


def solve_window(state: WindowState, imu: ImuFactors, proj: ProjFactors,
                 priors: PriorState, G, pixel_sqrt_info, dims: WindowDims,
                 iters: int = 10, estimate_extrinsic: bool = False,
                 init_lambda: float = 1e-4, info: dict | None = None):
    """Levenberg–Marquardt with landmark Schur elimination; branchless
    accept/reject (a non-finite trial cost is rejected), the reference's
    lambda schedule and its convergence early exit. Returns (state, cost).

    One factor evaluation per iteration: the normal equations at the
    accepted state are carried, a trial's evaluation becomes the next
    linearization when accepted. The loop reads ONE device scalar per
    iteration on the host (the early-exit flag); lambda and the accept
    decision stay on the device. `info`, when given, receives the number of
    LM iterations run."""
    B = dims.B
    dtype, dev = state.P.dtype, state.P.device
    step = linstep if dtype == torch.float32 else linstep_ref

    def build(st):
        return build_normal_equations(st, imu, proj, priors, G, pixel_sqrt_info, dims,
                                      estimate_extrinsic)

    lam = torch.tensor(init_lambda, dtype=dtype, device=dev)
    ne = build(state)
    it = 0
    while it < iters:
        it += 1
        H, b, h, W, b_l, cost0 = ne
        if dtype == torch.float32:
            dx, dl = step(H, b, W, h, b_l, lam, 6 * B)
        else:
            dx, dl = step(H, b, W, h, b_l, lam, 6 * B, dims.D)
        trial = retract_state(state, dx, dl, dims)
        ne_trial = build(trial)
        cost1 = ne_trial[-1]
        ok = (cost1 < cost0) & torch.isfinite(cost1)
        state = WindowState(*(torch.where(ok, t, s) for s, t in zip(state, trial)))
        ne = tuple(torch.where(ok, t, s) for s, t in zip(ne, ne_trial))
        lam = torch.where(ok, torch.clamp(lam * 0.4, min=1e-9), torch.clamp(lam * 8.0, max=1e6))
        converged = ok & (cost0 - cost1 < 1e-6 * torch.clamp(cost0, min=1e-30))
        if bool(converged):  # the one host sync per iteration
            break
    if info is not None:
        info["iterations"] = it
    return state, ne[-1]
