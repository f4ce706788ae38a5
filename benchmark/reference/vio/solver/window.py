"""Batched sliding-window bundle-adjustment solver (torch port of
isvins_tpu/solver/window.py).

Problem structure (estimator.cpp problemSolve :1004–1146):
- B pose blocks (6-dof) + B speed/bias blocks (9-dof) + 1 extrinsic (6-dof)
- B-1 IMU factors between consecutive frames (no robust loss)
- up to N inverse-depth projection factors, Cauchy(1.0), whitened by the
  pixel sqrt-info
- sparse nonlinear priors (IS scheme): SE3 prior on pose 0, speed/bias prior
  on frame Vo-1, Vo-1 relative-pose edges, roll-pitch edges, Cauchy(1.0)

The JAX one-hot einsums (MXU work on the TPU) become gathers and segment
sums here: the rows that land on one slot (a frame, a pair of frames, a
landmark) are summed in an order fixed by plans (`NormalPlans`) built once
per solve from the factor indices, so that a solve gives the same bits on
every run, as the reference's one-hot sums do (index_add_ sums in an order
that changes from run to run on the card). The landmark Schur elimination
and the LM accept/reject are as in the reference. Column layout of the full system (D = 15B + 6):
  pose i -> [6i, 6i+6),  vb i -> [6B + 9i, 6B + 9i + 9),  ex -> [15B, 15B+6)
and of the landmark coupling W (reduced, Dr = 6B + 6): [pose | ex].

Kernels (ops/): the f32 solve evaluates projection factors with K1, IMU
factors with K2 and takes each LM step with K4 (whose first launch is K3).
f64 solves (init BA, the init scale scan) call the plain versions, as the
reference's f64 solves keep its XLA path.

Every function here takes its leaves with or without leading sequence axes:
solve_window_batched solves NB windows in one program (the reference's
jax.vmap(solve_window)), with K1 and K2 launched once over the rows of all
sequences and the NB linear systems factored by K5.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F_nn

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
from ..ops.linstep import linstep, linstep_batched, linstep_ref
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


def _take(a, idx):
    """a (..., B, k) gathered along its frame axis with idx (..., n) ->
    (..., n, k)."""
    return torch.gather(a, -2, idx[..., None].expand(idx.shape + a.shape[-1:]))


def _bcast(m, t):
    """m (lead...) reshaped so that it broadcasts against t (lead..., ...)."""
    return m.reshape(m.shape + (1,) * (t.dim() - m.dim()))


def retract_state(state: WindowState, dx, dl, dims: WindowDims) -> WindowState:
    """Manifold plus: p+dp, q*Exp(dtheta); additive on v/ba/bg/ex-trans/depth.
    Every leaf may carry leading sequence axes (dx (..., D), dl (..., F))."""
    B = dims.B
    lead = dx.shape[:-1]
    d_pose = dx[..., : 6 * B].reshape(lead + (B, 6))
    d_vb = dx[..., 6 * B: 15 * B].reshape(lead + (B, 9))
    d_ex = dx[..., 15 * B:]
    return WindowState(
        P=state.P + d_pose[..., :3],
        Q=quat_normalize(quat_mul(state.Q, so3_exp_quat(d_pose[..., 3:]))),
        V=state.V + d_vb[..., :3],
        Ba=state.Ba + d_vb[..., 3:6],
        Bg=state.Bg + d_vb[..., 6:9],
        tic=state.tic + d_ex[..., :3],
        qic=quat_normalize(quat_mul(state.qic, so3_exp_quat(d_ex[..., 3:]))),
        dep=state.dep + dl,
    )


def _eval_imu(state: WindowState, imu: ImuFactors, G, dims: WindowDims):
    """Whitened residuals (B-1,15) + dense rows (B-1,15,D) + cost vector.
    With leading sequence axes on every leaf (G (..., 3) then), the factors
    of all sequences go through ONE launch of K2 as flattened rows."""
    B, D = dims.B, dims.D
    dtype, dev = state.P.dtype, state.P.device
    lead = state.P.shape[:-2]
    n = B - 1
    pre = imu.pre
    args = (state.P[..., :-1, :], state.Q[..., :-1, :], state.V[..., :-1, :],
            state.Ba[..., :-1, :], state.Bg[..., :-1, :],
            state.P[..., 1:, :], state.Q[..., 1:, :], state.V[..., 1:, :],
            state.Ba[..., 1:, :], state.Bg[..., 1:, :],
            pre.delta_p, pre.delta_q, pre.delta_v, pre.sum_dt, pre.ba, pre.bg, pre.jac)
    flat = [a.reshape((-1,) + a.shape[len(lead) + 1:]).contiguous() for a in args]
    rows = imu_rows if dtype == torch.float32 else imu_rows_ref
    r, Jcat = rows(*flat, (G.reshape(-1, 3) if G.dim() > 1 else G).contiguous())
    r, Jcat = r.reshape(lead + (n, 15)), Jcat.reshape(lead + (n, 15, 30))
    w = imu.valid.to(dtype)[..., None]
    S = imu.sqrt
    Jcat = (S @ Jcat) * w[..., None]
    r_w = (S @ r[..., None])[..., 0] * w

    # factor k touches frames k and k+1: the (k, k) and (k, k+1) diagonals
    # of the (factor, frame) grid, written through diagonal views
    pose = torch.zeros(lead + (n, 15, B, 6), dtype=dtype, device=dev)
    vb = torch.zeros(lead + (n, 15, B, 9), dtype=dtype, device=dev)
    for blk, c0, off in ((pose, 0, 0), (vb, 6, 0), (pose, 15, 1), (vb, 21, 1)):
        k = blk.shape[-1]
        torch.diagonal(blk[..., off: off + n, :], dim1=-4, dim2=-2).copy_(
            Jcat[..., c0: c0 + k].movedim(-3, -1))
    Jrows = torch.cat([pose.reshape(lead + (n, 15, 6 * B)), vb.reshape(lead + (n, 15, 9 * B)),
                       torch.zeros(lead + (n, 15, 6), dtype=dtype, device=dev)], dim=-1)
    cvec = 0.5 * torch.sum(r_w * r_w, dim=-1)
    return r_w, Jrows, cvec


def _eval_proj(state: WindowState, proj: ProjFactors, pixel_sqrt_info, dims: WindowDims,
               estimate_extrinsic: bool = False):
    """Whitened+robust projection residuals (N,2), compact block Jacobians
    J_pi/J_pj/J_ex (N,2,6), landmark partials (N,2) and the cost vector.
    With leading sequence axes (pixel_sqrt_info (...) then), the rows of all
    sequences go through ONE launch of K1."""
    dtype = state.P.dtype
    lead = state.P.shape[:-2]
    N = proj.valid.shape[-1]
    idx_i, idx_j, fidx = proj.idx_i.long(), proj.idx_j.long(), proj.fidx.long()
    P_i, Q_i = _take(state.P, idx_i), _take(state.Q, idx_i)
    P_j, Q_j = _take(state.P, idx_j), _take(state.Q, idx_j)
    dep_g = torch.gather(state.dep, -1, fidx)

    if not estimate_extrinsic:
        rows = _proj_ops.proj_rows if dtype == torch.float32 else eval_proj_rows
        flat = lambda a, k: a.reshape((-1,) + a.shape[a.dim() - k:]).contiguous()
        tic, qic = state.tic.contiguous(), state.qic.contiguous()
        if lead and rows is eval_proj_rows:  # the plain version takes one per row
            tic, qic = (a.reshape(-1, a.shape[-1]).repeat_interleave(N, 0) for a in (tic, qic))
        elif lead:
            tic, qic = tic.reshape(-1, 3), qic.reshape(-1, 4)
        out = rows(flat(proj.pts_i, 1), flat(proj.pts_j, 1), flat(P_i, 1), flat(Q_i, 1),
                   flat(P_j, 1), flat(Q_j, 1), tic, qic, flat(dep_g, 0), flat(proj.valid, 0))
        r, J_pi, J_pj, J_dep = (o.reshape(lead + (N,) + o.shape[1:]) for o in out)
        J_ex = torch.zeros_like(J_pi)
    else:
        # sanitize BEFORE evaluation: masked rows must not produce NaN
        d = torch.where(proj.valid & (dep_g.abs() > 1e-8), dep_g, torch.ones_like(dep_g))
        r, J_pi, J_pj, J_ex, J_dep = projection_residual_jacobians(
            proj.pts_i, proj.pts_j, P_i, Q_i, P_j, Q_j, state.tic[..., None, :],
            state.qic[..., None, :], d)
    s = pixel_sqrt_info[..., None]
    vw = proj.valid.to(dtype)
    r_sq = torch.sum((s[..., None] * r) ** 2, dim=-1)
    w = (s * _cauchy_weight(r_sq)) * vw
    r_w = r * w[..., None]
    J_pi = J_pi * w[..., None, None]
    J_pj = J_pj * w[..., None, None]
    J_ex = J_ex * w[..., None, None]
    J_dep = J_dep * w[..., None]
    cvec = 0.5 * _cauchy_rho(r_sq) * vw
    return r_w, J_pi, J_pj, J_ex, J_dep, cvec


def _eval_priors(state: WindowState, priors: PriorState, dims: WindowDims):
    """All sparse nonlinear priors -> list of (r_w, Jrows) + cost vector,
    each Cauchy(1.0) (estimator.cpp:1102–1117). Leading sequence axes
    allowed on every leaf."""
    B, Vo, D = dims.B, dims.Vo, dims.D
    dtype, dev = state.P.dtype, state.P.device
    lead = state.P.shape[:-2]
    rows, cvecs = [], []

    def robust(r_w, valid):
        """Per-factor Cauchy weight and cost of whitened residuals (...,r)."""
        s = torch.sum(r_w * r_w, dim=-1)
        v = valid.to(dtype)
        return _cauchy_weight(s) * v, 0.5 * _cauchy_rho(s) * v

    mv = lambda S, r: (S @ r[..., None])[..., 0]
    zeros = lambda *shape: torch.zeros(lead + shape, dtype=dtype, device=dev)

    # SE3 prior on pose 0
    r, J = se3_prior_residual_jacobians(priors.se3_t, priors.se3_q,
                                        state.P[..., 0, :], state.Q[..., 0, :])
    r_w = mv(priors.se3_sqrt, r)
    w, c = robust(r_w, priors.se3_valid)
    Jrow = zeros(6, D)
    Jrow[..., :, 0:6] = (priors.se3_sqrt @ J) * w[..., None, None]
    rows.append((r_w * w[..., None], Jrow))
    cvecs.append(c[..., None])

    # VB prior on frame Vo-1
    k = Vo - 1
    r, J = linear9_residual_jacobians(priors.vb, state.V[..., k, :], state.Ba[..., k, :],
                                      state.Bg[..., k, :])
    r_w = mv(priors.vb_sqrt, r)
    w, c = robust(r_w, priors.vb_valid)
    Jrow = zeros(9, D)
    Jrow[..., :, 6 * B + 9 * k: 6 * B + 9 * k + 9] = (priors.vb_sqrt @ J) * w[..., None, None]
    rows.append((r_w * w[..., None], Jrow))
    cvecs.append(c[..., None])

    # relative-pose edges (k-1, k), k = 1..Vo-1; slot 0 is inert: its
    # i-side block has no frame (jax.nn.one_hot(-1) is a zero row), so it
    # is left out of the (k, k-1) diagonal rather than indexed with -1
    # (which would wrap)
    ks = torch.arange(Vo, device=dev)
    km1 = torch.clamp(ks - 1, min=0)
    r, Ji, Jj = relpose_residual_jacobians(
        priors.rel_dt, priors.rel_dq, state.P[..., km1, :], state.Q[..., km1, :],
        state.P[..., ks, :], state.Q[..., ks, :])
    S = priors.rel_sqrt
    r_w = mv(S, r)
    w, c = robust(r_w, priors.rel_valid)
    Jrel = zeros(Vo, 6, B, 6)
    torch.diagonal(Jrel[..., 1:, :, : Vo - 1, :], dim1=-4, dim2=-2).copy_(
        ((S @ Ji) * w[..., None, None])[..., 1:, :, :].movedim(-3, -1))
    torch.diagonal(Jrel[..., :, :, :Vo, :], dim1=-4, dim2=-2).add_(
        ((S @ Jj) * w[..., None, None]).movedim(-3, -1))
    Jfull = zeros(Vo, 6, D)
    Jfull[..., : 6 * B] = Jrel.reshape(lead + (Vo, 6, 6 * B))
    rows.append(((r_w * w[..., None]).reshape(lead + (-1,)), Jfull.reshape(lead + (-1, D))))
    cvecs.append(c)

    # roll-pitch edges: edge k sits on frame idx[k] (a one-hot spread)
    K = priors.rp.idx.shape[-1]
    idx = priors.rp.idx.long()
    # an emptied slot has idx -1: it reads frame 0 and is masked by `valid`
    r, J = rollpitch_residual_jacobians(priors.rp.q_meas, _take(state.Q, idx.clamp(min=0)))
    S = priors.rp.sqrt_info
    r_w = mv(S, r)
    w, c = robust(r_w, priors.rp.valid)
    on = (idx[..., None] == torch.arange(B, device=dev)).to(dtype)  # (..., K, B)
    Jrp = ((S @ J) * w[..., None, None])[..., None, :] * on[..., None, :, None]
    Jfull = zeros(K, 2, D)
    Jfull[..., : 6 * B] = Jrp.reshape(lead + (K, 2, 6 * B))
    rows.append(((r_w * w[..., None]).reshape(lead + (-1,)), Jfull.reshape(lead + (-1, D))))
    cvecs.append(c)
    return rows, torch.cat(cvecs, dim=-1)


SEGMENT_RUN = 32  # rows a thread adds one after another before the runs are summed


class SegmentPlan(NamedTuple):
    """Rows of a source, grouped by the slot each is summed into, and each
    slot's rows cut into runs of at most SEGMENT_RUN consecutive rows."""

    order: torch.Tensor  # (R,) int64: the source rows sorted by slot, stably
    run_starts: torch.Tensor  # (n_runs,) int64: where each run starts in `order`
    run_ids: torch.Tensor  # (n_runs,) int64: 0, 1, ..., n_runs - 1
    slot_runs: torch.Tensor  # (n_slots,) int64: each slot's first run


def segment_plan(slots: torch.Tensor, n_slots: int) -> SegmentPlan:
    """The plan of summing row r of a source into slot slots[r] (1-D
    int64, each in [0, n_slots)). Built on the slots' device without a host
    read: the number of runs is bounded by R // SEGMENT_RUN + n_slots, and
    the runs past the last slot's are empty."""
    dev, R, chunk = slots.device, slots.shape[0], SEGMENT_RUN
    keys, order = torch.sort(slots, stable=True)
    bounds = torch.searchsorted(keys, torch.arange(n_slots + 1, device=dev))  # bounds[-1] = R
    runs = (bounds[1:] - bounds[:-1] + chunk - 1) // chunk
    ends = torch.cumsum(runs, 0)
    first = ends - runs
    run_ids = torch.arange(R // chunk + n_slots, device=dev)
    s = torch.searchsorted(ends, run_ids, right=True).clamp(max=n_slots - 1)
    starts = torch.where(run_ids < ends[-1], bounds[s] + (run_ids - first[s]) * chunk, R)
    return SegmentPlan(order, starts, run_ids, first)


def segment_sum(plan: SegmentPlan, src: torch.Tensor) -> torch.Tensor:
    """src (R, *k) summed per slot -> (n_slots, *k); an empty slot is 0.
    Each run's rows are added one after another in row order, then each
    slot's runs one after another (two `embedding_bag` sums, on the CPU and
    the card alike), so the result has the same bits on every run; the runs
    keep each thread's serial chain short on the card."""
    per_run = F_nn.embedding_bag(plan.order, src.reshape(src.shape[0], -1), plan.run_starts,
                                 mode="sum")
    out = F_nn.embedding_bag(plan.run_ids, per_run, plan.slot_runs, mode="sum")
    return out.reshape((-1,) + src.shape[1:])


class NormalPlans(NamedTuple):
    """The segment-sum plans of build_normal_equations, from the projection
    factors' indices alone: fixed within a solve, so built once by it."""

    frames: SegmentPlan  # host-side rows then observer-side rows -> B frames
    pairs: SegmentPlan  # row n -> the (idx_i, idx_j) block of the B x B grid
    landmarks: SegmentPlan  # row n -> landmark fidx


def normal_plans(proj: ProjFactors, dims: WindowDims) -> NormalPlans:
    """The plans for projection factors with any leading sequence axes:
    sequence s's slots are offset by s times the slot count, so nothing is
    summed across sequences. Source rows are the factors' rows flattened
    over the sequences (for `frames`: all host-side rows, then all
    observer-side rows)."""
    B, F = dims.B, dims.F
    idx_i, idx_j, fidx = proj.idx_i.long(), proj.idx_j.long(), proj.fidx.long()
    lead = idx_i.shape[:-1]
    S = int(np.prod(lead)) if lead else 1
    seq = torch.arange(S, device=idx_i.device).reshape(lead + (1,))
    return NormalPlans(
        frames=segment_plan(torch.cat([(seq * B + idx_i).reshape(-1),
                                       (seq * B + idx_j).reshape(-1)]), S * B),
        pairs=segment_plan((seq * (B * B) + idx_i * B + idx_j).reshape(-1), S * B * B),
        landmarks=segment_plan((seq * F + fidx).reshape(-1), S * F))


def build_normal_equations(state: WindowState, imu: ImuFactors, proj: ProjFactors,
                           priors: PriorState, G, pixel_sqrt_info, dims: WindowDims,
                           estimate_extrinsic: bool = False, plans: NormalPlans | None = None):
    """Returns (H (D,D), b (D,), h (F,), W (F,Dr), b_l (F,), cost) with the
    landmark coupling W in the reduced layout Dr = 6B+6 ([pose | ex]).
    The projection Hessian is accumulated block-wise: per observation the
    compact 6x6 products are formed and added into the (B,B) block grid.

    Every leaf may carry leading sequence axes (G (..., 3) and
    pixel_sqrt_info (...) then); the outputs carry them too. The segment
    sums then run once over all sequences, on slots offset by the sequence,
    so nothing is summed across sequences. `plans` (normal_plans(proj,
    dims)) is built here when not given."""
    B, F, D = dims.B, dims.F, dims.D
    Dr = 6 * B + 6
    dtype, dev = state.P.dtype, state.P.device
    lead = state.P.shape[:-2]
    S = int(np.prod(lead)) if lead else 1
    seq = torch.arange(S, device=dev).reshape(lead + (1,))  # sequence number, per row

    r_imu, J_imu, cv_imu = _eval_imu(state, imu, G, dims)
    r_proj, J_pi, J_pj, J_ex, J_dep, cv_proj = _eval_proj(
        state, proj, pixel_sqrt_info, dims, estimate_extrinsic)
    prior_rows, cv_prior = _eval_priors(state, priors, dims)

    Jip = torch.cat([J_imu.reshape(lead + (-1, D))] + [J for _, J in prior_rows], dim=-2)
    rip = torch.cat([r_imu.reshape(lead + (-1,))] + [r for r, _ in prior_rows], dim=-1)
    if not estimate_extrinsic:
        Jip = torch.cat([Jip[..., : 15 * B], torch.zeros_like(Jip[..., 15 * B:])], dim=-1)
    H = Jip.transpose(-1, -2) @ Jip
    b = -(Jip.transpose(-1, -2) @ rip[..., None])[..., 0]

    if plans is None:
        plans = normal_plans(proj, dims)

    def seg(plan, n_slots, *srcs):
        """Rows of the srcs (..., n, *k), laid end to end as the plan's
        source, summed into (..., n_slots, *k)."""
        k = srcs[0].shape[len(lead) + 1:]
        flat = [s.reshape((-1,) + k) for s in srcs]
        flat = flat[0] if len(flat) == 1 else torch.cat(flat)
        return segment_sum(plan, flat).reshape(lead + (n_slots,) + k)

    def place(n_slots, index, src):
        """Rows of src (..., n, *k) written into zeros (..., n_slots, *k) at
        index (..., n), which holds no slot twice."""
        out = torch.zeros((S * n_slots,) + src.shape[len(lead) + 1:], dtype=dtype, device=dev)
        if lead:
            index = (seq * n_slots + index).reshape(-1)
        out.index_add_(0, index, src.reshape((-1,) + src.shape[len(lead) + 1:]))
        return out.reshape(lead + (n_slots,) + src.shape[len(lead) + 1:])

    # ---- projection block accumulation ----
    idx_i, idx_j = proj.idx_i.long(), proj.idx_j.long()
    T = lambda J: J.transpose(-1, -2)
    G_ii = T(J_pi) @ J_pi
    G_jj = T(J_pj) @ J_pj
    G_ij = T(J_pi) @ J_pj
    g_i = (T(J_pi) @ r_proj[..., None])[..., 0]
    g_j = (T(J_pj) @ r_proj[..., None])[..., 0]

    diag = seg(plans.frames, B, G_ii, G_jj)
    offd = seg(plans.pairs, B * B, G_ij).reshape(lead + (B, B, 6, 6))
    Hblk = offd + offd.transpose(-4, -3).transpose(-1, -2)
    torch.diagonal(Hblk, dim1=-4, dim2=-3).add_(diag.movedim(-3, -1))
    H_pose = Hblk.transpose(-3, -2).reshape(lead + (6 * B, 6 * B))
    gb = seg(plans.frames, B, g_i, g_j)

    H[..., : 6 * B, : 6 * B] += H_pose
    b[..., : 6 * B] -= gb.reshape(lead + (6 * B,))

    # landmark coupling rows (compact): observation n couples its landmark
    # to frames idx_i[n] and idx_j[n]
    wi = (J_dep[..., None, :] @ J_pi)[..., 0, :]  # (N,6)
    wj = (J_dep[..., None, :] @ J_pj)[..., 0, :]
    n = J_dep.shape[-2]
    row = torch.arange(n, device=dev) * B
    Wrows = (place(n * B, row + idx_i, wi) + place(n * B, row + idx_j, wj)).reshape(
        lead + (n, 6 * B))

    if estimate_extrinsic:
        G_ie = T(J_pi) @ J_ex
        G_je = T(J_pj) @ J_ex
        G_ee = torch.einsum("...nra,...nrb->...ab", J_ex, J_ex)
        g_e = torch.einsum("...nra,...nr->...a", J_ex, r_proj)
        E_rows = seg(plans.frames, B, G_ie, G_je).reshape(lead + (6 * B, 6))
        H[..., : 6 * B, 15 * B:] += E_rows
        H[..., 15 * B:, : 6 * B] += T(E_rows)
        H[..., 15 * B:, 15 * B:] += G_ee
        b[..., 15 * B:] -= g_e
        we = (J_dep[..., None, :] @ J_ex)[..., 0, :]
        Wrows = torch.cat([Wrows, we], dim=-1)
    else:
        H[..., 15 * B:, 15 * B:] += torch.eye(6, dtype=dtype, device=dev)
        Wrows = torch.cat([Wrows, torch.zeros(lead + (n, 6), dtype=dtype, device=dev)], dim=-1)

    # landmark system: per-feature scalar Hessian + coupling row + rhs
    payload = torch.cat([
        torch.sum(J_dep * J_dep, dim=-1, keepdim=True),
        Wrows,
        -torch.sum(J_dep * r_proj, dim=-1, keepdim=True),
    ], dim=-1)
    agg = seg(plans.landmarks, F, payload)
    h = agg[..., 0].contiguous()
    W = agg[..., 1: 1 + Dr].contiguous()
    b_l = agg[..., 1 + Dr].contiguous()

    cost = torch.sum(torch.cat([cv_imu, cv_proj, cv_prior], dim=-1), dim=-1)
    return H, b, h, W, b_l, cost


def window_cost(state, imu, proj, priors, G, pixel_sqrt_info, dims):
    """Robust cost only."""
    _, _, cv_imu = _eval_imu(state, imu, G, dims)
    cv_proj = _eval_proj(state, proj, pixel_sqrt_info, dims)[5]
    _, cv_prior = _eval_priors(state, priors, dims)
    return torch.sum(torch.cat([cv_imu, cv_proj, cv_prior], dim=-1), dim=-1)


def _lm(state, imu, proj, priors, G, pixel_sqrt_info, dims, iters, estimate_extrinsic,
        init_lambda, info, step):
    """The Levenberg–Marquardt loop of solve_window and solve_window_batched
    over whatever leading sequence axes the leaves carry. `lam`, the accept
    decision and `done` are per sequence; a sequence that has converged is
    frozen (its state, normal equations and lam no longer change) while the
    others iterate, as jax.vmap of the reference's while_loop leaves it.

    The loop runs all `iters` iterations and reads nothing on the host: an
    iteration after convergence is a no-op on the result (the masks keep
    every bit), so the answer equals the reference's early exit, and the
    caller's thread never waits for the device. The iterations each
    sequence took before converging are counted on the device."""
    dtype, dev = state.P.dtype, state.P.device
    lead = state.P.shape[:-2]

    plans = normal_plans(proj, dims)  # the factors' indices do not change within a solve

    def build(st):
        return build_normal_equations(st, imu, proj, priors, G, pixel_sqrt_info, dims,
                                      estimate_extrinsic, plans)

    lam = torch.full(lead, init_lambda, dtype=dtype, device=dev)
    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    taken = torch.zeros(lead, dtype=torch.int64, device=dev)
    ne = build(state)
    for _ in range(iters):
        taken += ~done
        H, b, h, W, b_l, cost0 = ne
        dx, dl = step(H, b, W, h, b_l, lam)
        trial = retract_state(state, dx, dl, dims)
        ne_trial = build(trial)
        cost1 = ne_trial[-1]
        ok = (cost1 < cost0) & torch.isfinite(cost1)
        take = ok & ~done
        state = WindowState(*(torch.where(_bcast(take, t), t, s) for s, t in zip(state, trial)))
        ne = tuple(torch.where(_bcast(take, t), t, s) for s, t in zip(ne, ne_trial))
        lam = torch.where(done, lam, torch.where(ok, torch.clamp(lam * 0.4, min=1e-9),
                                                 torch.clamp(lam * 8.0, max=1e6)))
        done = done | (take & (cost0 - cost1 < 1e-6 * torch.clamp(cost0, min=1e-30)))
    if info is not None:
        info["iterations"] = taken.amax()
        info["sequence_iterations"] = taken
    return state, ne[-1]


def solve_window(state: WindowState, imu: ImuFactors, proj: ProjFactors,
                 priors: PriorState, G, pixel_sqrt_info, dims: WindowDims,
                 iters: int = 10, estimate_extrinsic: bool = False,
                 init_lambda: float = 1e-4, info: dict | None = None):
    """Levenberg–Marquardt with landmark Schur elimination; branchless
    accept/reject (a non-finite trial cost is rejected), the reference's
    lambda schedule and its convergence test. Returns (state, cost).

    One factor evaluation per iteration: the normal equations at the
    accepted state are carried, a trial's evaluation becomes the next
    linearization when accepted. All `iters` iterations run (those after
    convergence leave the result as it is) and nothing is read on the host:
    lambda, the accept decision and the convergence flag stay on the
    device. `info`, when given, receives `iterations`, the LM iterations
    taken before convergence (at most `iters`), as a 0-d device tensor."""
    if state.P.dim() != 2:
        raise ValueError("solve_window takes one problem; see solve_window_batched")
    n_pose, D = 6 * dims.B, dims.D
    if state.P.dtype == torch.float32:
        step = lambda H, b, W, h, b_l, lam: linstep(H, b, W, h, b_l, lam, n_pose)
    else:
        step = lambda H, b, W, h, b_l, lam: linstep_ref(H, b, W, h, b_l, lam, n_pose, D)
    return _lm(state, imu, proj, priors, G, pixel_sqrt_info, dims, iters, estimate_extrinsic,
               init_lambda, info, step)


def solve_window_batched(state: WindowState, imu: ImuFactors, proj: ProjFactors,
                         priors: PriorState, G, pixel_sqrt_info, dims: WindowDims,
                         iters: int = 10, estimate_extrinsic: bool = False,
                         init_lambda: float = 1e-4, info: dict | None = None):
    """solve_window for NB independent problems at once: every leaf carries
    a leading sequence axis; G is (3,) or (NB,3), pixel_sqrt_info () or
    (NB,). Returns (state, cost (NB,)). What jax.vmap(solve_window) is in
    the reference: per-sequence lambda, accept test and convergence, a
    converged sequence frozen while the others iterate; the loop always
    runs `iters` iterations. Per iteration the NB sequences share ONE
    launch each of K1 and K2 (flattened rows) and ONE of K5 (a thread block
    per sequence); K3 and K4 are not on this path. No host read. `info`
    receives `iterations` (the most any sequence took, 0-d) and
    `sequence_iterations` ((NB,), each sequence's), device tensors. A
    sequence whose system is not SPD or whose cost is NaN only has its own
    steps rejected."""
    if state.P.dim() != 3:
        raise ValueError("solve_window_batched takes a leading sequence axis on every leaf")
    NB = state.P.shape[0]
    G = G.expand(NB, 3) if G.dim() == 1 else G
    psi = pixel_sqrt_info.expand(NB) if pixel_sqrt_info.dim() == 0 else pixel_sqrt_info
    step = lambda H, b, W, h, b_l, lam: linstep_batched(H, b, W, h, b_l, lam, 6 * dims.B)
    return _lm(state, imu, proj, priors, G, psi, dims, iters, estimate_extrinsic, init_lambda,
               info, step)
