"""Visual-inertial initialization orchestration (torch port of
isvins_tpu/estimator/vi_init.py; initialStructure / visualInitialAlign,
estimator.cpp:239-429).

Pipeline: IMU excitation check -> seed-pair relative pose -> chained PnP +
two-view triangulation across the window -> projection-only bundle
adjustment (the window LM solver with the IMU factors masked out, f64 on
the estimator's device, the kernels' plain versions; the reference builds a
separate ceres autodiff SfM problem, initial_sfm.cpp:232-289) -> gyro-bias
solve -> velocity/gravity/scale linear alignment + gravity refinement ->
state application with gravity-aligned, yaw-zeroed world frame.
`refine_gyro_bias` and `realign_window` run in the first solve after init.

Host math in f64 numpy; the small geometry helpers run as f64 torch on the
CPU (the reference's own formulas).
"""

from __future__ import annotations

import numpy as np
import torch

from ..factors.preintegration import Preintegration
from ..geom import (g2R, mat_to_quat, mat_to_ypr, quat_conj, quat_mul, quat_normalize,
                    quat_rotate, quat_to_mat, ypr_to_mat)
from ..initial import linear_alignment, solve_gyroscope_bias, solve_relative_pose
from ..initial.five_point import _triangulate_pair, solve_translation_with_rotation
from ..initial.pnp import pnp_gn
from ..solver import PriorState, ProjFactors, WindowState, solve_window
from ..utils.convert import from_numpy_tree, to_numpy_tree


def _np(t):
    return t.detach().cpu().numpy()


def _h(fn, *args):
    """fn of the port's geom on f64 CPU tensors of numpy arguments -> numpy."""
    return _np(fn(*(torch.as_tensor(np.asarray(a, np.float64)) for a in args)))


def _segments(pre) -> list:
    """The stacked (B-1, ...) preintegration as one host Preintegration per
    segment."""
    pre_np = to_numpy_tree(pre)
    return [Preintegration(*(a[k] for a in pre_np)) for k in range(len(pre_np.sum_dt))]


def check_imu_excitation(est) -> bool:
    """estimator.cpp:213-238: stddev of mean specific force across segments."""
    pre = est._imu_factors().pre
    dv = _np(pre.delta_v)
    dt = _np(pre.sum_dt)
    ok = dt > 1e-6
    if ok.sum() < 2:
        return False
    g_seg = dv[ok] / dt[ok][:, None]
    var = np.sqrt(((g_seg - g_seg.mean(0)) ** 2).sum(1).mean())
    return var >= est.cfg.solver.excitation_threshold


def _gyro_rotation_prior(est, i):
    """Relative CAMERA rotation frame i -> B-1 from the gyro preintegration
    chain at the current bias estimate: R_ci_c(B-1) = RIC^T (prod dq) RIC.
    Pre-init the gyro bias error is a few mrad/s, far below what 8-point E
    estimation delivers on few clustered (wall-planar) correspondences."""
    B = est.dims.B
    imu_f = est._imu_factors()
    dq = _np(imu_f.pre.delta_q)  # (B-1, 4); segment j: frame j -> j+1
    valid = _np(imu_f.valid)
    if not valid[i: B - 1].all():
        return None
    q = torch.tensor([1.0, 0, 0, 0], dtype=torch.float64)
    for j in range(i, B - 1):
        q = quat_normalize(quat_mul(q, torch.as_tensor(dq[j])))
    R_body = _np(quat_to_mat(q))
    # the live extrinsic (est.qic), not the config's: online calibration
    # (mode 2) may have installed a better rotation (estimator.cpp:146)
    RIC = _h(quat_to_mat, est.qic)
    return RIC.T @ R_body @ RIC


def find_seed_pair(est):
    """relativePose (estimator.cpp:431-459): earliest frame with >20
    correspondences to the newest frame and mean parallax*460 > 30.

    Deviation from the reference's pure-vision findFundamentalMat seed: the
    rotation is transported from the gyro preintegration chain and only the
    translation direction is solved from the correspondences
    (solve_translation_with_rotation): wall-dominated views make the
    8-point problem planar-degenerate. Falls back to 8-point E-RANSAC when
    the IMU chain is unavailable."""
    B = est.dims.B
    fm = est.f_manager
    # epipolar threshold ~1 px of tracking noise in normalized units
    thresh = 1.0 / float(est.cfg.camera.fx)
    for i in range(B - 2):
        a, b = fm.get_corresponding(i, B - 1)
        if len(a) > 20:
            par = np.linalg.norm(a[:, :2] - b[:, :2], axis=1).mean()
            if par * 460.0 > 30.0:
                R_prior = _gyro_rotation_prior(est, i)
                if R_prior is not None:
                    ok, R, T, _ = solve_translation_with_rotation(a[:, :2], b[:, :2], R_prior,
                                                                  thresh=thresh)
                else:
                    ok, R, T, _ = solve_relative_pose(a[:, :2], b[:, :2], thresh=thresh)
                if ok:
                    return i, R, T
    return None, None, None


def global_sfm(est, l, R_rel, T_rel):
    """Camera poses (cam-to-c0) for every window frame + landmark depths via
    chained PnP + triangulation + projection-only BA (initial_sfm.cpp
    construct, :58-289). Returns (ok, q_wc (B,4) cam-to-world, t_wc (B,3),
    inv_depth (F,) in host frames)."""
    B = est.dims.B
    fm = est.f_manager
    F = est.dims.F
    cpu = torch.device("cpu")

    # seed l = identity, last = (R_rel, T_rel)
    q_wc = np.tile(np.array([1.0, 0, 0, 0]), (B, 1))  # cam-to-world
    t_wc = np.zeros((B, 3))
    q_wc[B - 1] = _h(mat_to_quat, R_rel)
    t_wc[B - 1] = T_rel
    have_pose = np.zeros(B, bool)
    have_pose[l] = True
    have_pose[B - 1] = True

    pts3d = np.full((F, 3), np.nan)

    def w2c(i):
        q = _h(quat_conj, q_wc[i])
        return q, -_h(quat_rotate, q, t_wc[i])

    def triangulate_pair_frames(i, j):
        """Triangulate the untriangulated tracks seen in frames i and j."""
        qi, ti = w2c(i)
        qj, tj = w2c(j)
        # x_j = R_ji x_i + t_ji
        R_i = _h(quat_to_mat, qi)
        R_j = _h(quat_to_mat, qj)
        R_ji = R_j @ R_i.T
        t_ji = tj - R_ji @ ti
        sel = fm.active() & fm.has_obs[:, i] & fm.has_obs[:, j] & np.isnan(pts3d[:, 0])
        rows = np.where(sel)[0]
        if len(rows) == 0:
            return
        p1 = fm.obs[rows, i][:, :2]
        p2 = fm.obs[rows, j][:, :2]
        d1, d2 = (_np(d) for d in _triangulate_pair(*(torch.as_tensor(np.asarray(a, np.float64))
                                                      for a in (R_ji, t_ji, p1, p2))))
        good = (d1 > 0.05) & (d2 > 0.05)
        # cam_i point -> world
        pc = np.concatenate([p1, np.ones((len(rows), 1))], axis=1) * d1[:, None]
        pw = (R_i.T @ (pc - ti).T).T
        pts3d[rows[good]] = pw[good]

    def pnp_frame(i, guess_from):
        sel = fm.active() & fm.has_obs[:, i] & ~np.isnan(pts3d[:, 0])
        rows = np.where(sel)[0]
        if len(rows) < 6:
            return False
        q0, t0 = w2c(guess_from)
        t64 = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64), device=cpu)
        q, t, _ = pnp_gn(t64(pts3d[rows]), t64(fm.obs[rows, i][:, :2]), t64(q0), t64(t0),
                         iters=10)
        # store cam-to-world
        qi = _np(quat_conj(q))
        q_wc[i] = qi
        t_wc[i] = -_h(quat_rotate, qi, _np(t))
        have_pose[i] = True
        return True

    triangulate_pair_frames(l, B - 1)
    for i in range(l + 1, B - 1):
        if not pnp_frame(i, i - 1 if have_pose[i - 1] else l):
            return False, None, None, None
        triangulate_pair_frames(i, B - 1)
    for i in range(l - 1, -1, -1):
        if not pnp_frame(i, i + 1):
            return False, None, None, None
        triangulate_pair_frames(i, l)
    # triangulate leftovers from first/last observation
    for r in np.where(fm.active() & np.isnan(pts3d[:, 0]))[0]:
        frames = np.where(fm.has_obs[r])[0]
        if len(frames) >= 2:
            triangulate_pair_frames(frames[0], frames[-1])

    # ---- projection-only BA on the window solver
    tracked = fm.active() & ~np.isnan(pts3d[:, 0])
    inv_dep = np.zeros(F)
    for r in np.where(tracked)[0]:
        q, t = w2c(int(fm.start[r]))
        pc = _h(quat_rotate, q, pts3d[r]) + t
        if pc[2] < 0.05:
            tracked[r] = False
            continue
        inv_dep[r] = 1.0 / pc[2]

    idx_i, idx_j, fidx, pi_l, pj_l = [], [], [], [], []
    for r in np.where(tracked)[0]:
        host = int(fm.start[r])
        for f in np.where(fm.has_obs[r])[0]:
            if f == host:
                continue
            idx_i.append(host)
            idx_j.append(f)
            fidx.append(r)
            pi_l.append(fm.obs[r, host])
            pj_l.append(fm.obs[r, f])
    n = len(idx_i)
    if n < 30:
        return False, None, None, None
    N = est.dims.N
    n = min(n, N)
    pad = N - n
    proj = ProjFactors(
        idx_i=np.concatenate([idx_i[:n], np.zeros(pad)]).astype(np.int32),
        idx_j=np.concatenate([idx_j[:n], np.ones(pad)]).astype(np.int32),
        fidx=np.concatenate([fidx[:n], np.zeros(pad)]).astype(np.int32),
        pts_i=np.concatenate([np.asarray(pi_l[:n]).reshape(-1, 3),
                              np.tile([[0, 0, 1.0]], (pad, 1))]),
        pts_j=np.concatenate([np.asarray(pj_l[:n]).reshape(-1, 3),
                              np.tile([[0, 0, 1.0]], (pad, 1))]),
        valid=np.concatenate([np.ones(n), np.zeros(pad)]).astype(bool),
    )
    state = WindowState(P=t_wc, Q=q_wc, V=np.zeros((B, 3)), Ba=np.zeros((B, 3)),
                        Bg=np.zeros((B, 3)), tic=np.zeros(3), qic=np.array([1.0, 0, 0, 0]),
                        dep=inv_dep)
    imu_f = est._imu_factors()
    imu_off = imu_f._replace(valid=torch.zeros_like(imu_f.valid))
    # gauge: anchor pose 0 (any anchor works; damping holds scale)
    priors = PriorState.empty(est.dims.Vo)._replace(
        se3_t=t_wc[0], se3_q=q_wc[0], se3_sqrt=np.eye(6) * 100.0, se3_valid=np.asarray(True))
    st, pr, pri, G, psi = from_numpy_tree(
        (state, proj, priors, est.G, np.asarray(est.cfg.noise.pixel_sqrt_info)), est.device,
        torch.float64)
    state2, cost = solve_window(st, imu_off, pr, pri, G, psi, est.dims,
                                iters=est.cfg.solver.init_max_iterations)
    if not np.isfinite(float(cost)):
        return False, None, None, None
    return True, _np(state2.Q), _np(state2.P), _np(state2.dep)


def refine_gyro_bias(est) -> float:
    """Re-estimate the gyro bias against the CURRENT window rotations
    (post-BA) and apply the correction. Returns |dbg|.

    The one-shot solve_gyroscope_bias in run_visual_inertial_init uses the
    chained-SfM rotations, whose drift grows with the window length — at the
    product window (B=18) the accumulated ~0.8 deg/frame PnP-chain rotation
    drift aliases into a 0.14 rad/s bias estimate (measured on the noiseless
    synthetic bench world), which the init BA then cannot fully undo (the
    bias direction is stiff; 30 LM iterations recover only 20%) and the
    marginalization prior freezes thereafter, drifting the whole run. The
    alternation loop (estimator.solve_odometry first=True) therefore
    re-solves the same linear problem against the window's own
    vision-dominated rotations each round: as the BA rotations converge, so
    does the bias (reference analogue: solveGyroscopeBias,
    initial_aligment.cpp:3-37, run once — the reference's 10-frame-SfM
    rotation drift is small enough for one shot; an 18-frame chain's is
    not)."""
    pre_all = est._imu_factors()
    valid = pre_all.valid.cpu().numpy()
    if not valid.all():
        # segment pairing (R[k], R[k+1]) <-> pres[k] breaks with holes;
        # init windows normally have every segment valid
        return 0.0
    R_body = _np(quat_to_mat(torch.as_tensor(est.Qs)))
    dbg = solve_gyroscope_bias(R_body, _segments(pre_all.pre))
    est.Bgs[:] = est.Bgs + dbg
    return float(np.linalg.norm(dbg))


def realign_window(est, status: dict = None) -> bool:
    """Closed-form velocity/gravity/scale re-alignment at the CURRENT window
    states (post-BA). LM converges the stiff global scale/gravity directions
    only logarithmically (measured on a hard init: 30 iterations leave the
    window path at 0.35 of its true length, 120 at 0.74), while the linear
    alignment (initial_aligment.cpp:125–198) jumps to the optimum given the
    current rotations — alternating BA and re-alignment contracts the scale
    error geometrically (each round's BA re-solves the window shape with IMU
    factors at the better scale, which conditions the next alignment).
    Gauge is free during initialization, so re-zeroing yaw and re-anchoring
    the first position is safe (double2vector re-anchors anyway).
    Returns False (leaving states untouched) if alignment rejects OR if the
    correction is negligible (|s-1| < 2%, attitude < 1 deg) — a converged
    init must not be perturbed: the realignment is exact only up to the IMU
    noise in the preintegrations, so applying a near-identity correction to
    an already-converged window trades BA-optimal states for alignment noise
    (measured: +35% ATE on the noisy e2e sequence without this gate).

    `status`, when given, receives {"why": "rejected"|"converged"|"applied",
    "s": scale} so the caller can gate init acceptance on convergence (a
    weakly-excited window can leave an arbitrarily wrong scale; measured on
    the loop-closure e2e world the raw SfM alignment was 8x off and two
    alternation rounds left 3x — an initialization that must be refused,
    estimator.cpp retries initialStructure on the next keyframe)."""
    if status is None:
        status = {}
    B = est.dims.B
    TIC = np.asarray(est.tic)
    R_body = _np(quat_to_mat(torch.as_tensor(est.Qs)))  # (B,3,3)
    T_cam = est.Ps + np.einsum("bij,j->bi", R_body, TIC)
    ok, g_w, x = linear_alignment(
        R_body, T_cam, _segments(est._imu_factors().pre), TIC, float(np.linalg.norm(est.G))
    )
    status["why"] = "rejected"
    status["s"] = float(x[-1]) if ok else None
    if not ok:
        return False
    s = float(x[-1])
    if not (0.05 < s < 20.0):
        return False

    Ps = s * T_cam - np.einsum("bij,j->bi", R_body, TIC)
    anchor = est.Ps[0].copy()
    Vs = np.einsum("bij,bj->bi", R_body, x[: 3 * B].reshape(B, 3))

    R0 = _np(g2R(torch.as_tensor(g_w)))
    yaw = float(_np(mat_to_ypr(torch.as_tensor(R0 @ R_body[0])))[0])
    R0 = _np(ypr_to_mat(torch.tensor([-yaw, 0.0, 0.0], dtype=torch.float64))) @ R0

    ang = np.degrees(np.arccos(np.clip((np.trace(R0) - 1.0) / 2.0, -1.0, 1.0)))
    if abs(s - 1.0) < 0.02 and ang < 1.0:
        status["why"] = "converged"
        return False  # converged — see docstring
    status["why"] = "applied"

    Ps = np.einsum("ij,bj->bi", R0, Ps)
    est.Ps[:] = Ps - Ps[0] + anchor
    est.Vs[:] = np.einsum("ij,bj->bi", R0, Vs)
    R_w = np.einsum("ij,bjk->bik", R0, R_body)
    est.Qs[:] = _np(mat_to_quat(torch.as_tensor(R_w)))
    # the world similarity (R0, s) leaves each landmark's anchor-camera ray
    # unchanged and scales its depth by s — rescale instead of invalidating
    # (a reset discards converged triangulations and re-seeds them from
    # noisy two-view DLT)
    dep = est.f_manager.depth
    dep[dep > 0] *= s
    return True


def run_visual_inertial_init(est) -> bool:
    if not check_imu_excitation(est):
        return False
    l, R_rel, T_rel = find_seed_pair(est)
    if l is None:
        return False
    ok, q_wc, t_wc, inv_dep = global_sfm(est, l, R_rel, T_rel)
    if not ok:
        est.marginalization_flag = 0  # MARGIN_OLD (estimator.cpp:277)
        return False

    B = est.dims.B
    # the live extrinsic, possibly just produced by the online hand-eye
    # calibrator this very frame (estimator.cpp:146)
    RIC = _h(quat_to_mat, est.qic)
    TIC = np.asarray(est.tic)
    R_cam = _h(quat_to_mat, q_wc)  # cam-to-c0
    R_body = np.einsum("bij,kj->bik", R_cam, RIC)  # R_cam @ RIC^T
    T_cam = t_wc

    # ---- gyro bias + re-integration (initial_aligment.cpp:3-37); a failed
    # attempt must not leak a (possibly garbage) bias into the next one
    Bgs_backup = est.Bgs.copy()
    dbg = solve_gyroscope_bias(R_body, _segments(est._imu_factors().pre))
    est.Bgs[:] = est.Bgs + dbg
    pres = _segments(est._imu_factors().pre)

    # ---- linear alignment (+ gravity refinement)
    ok, g_c0, x = linear_alignment(R_body, T_cam, pres, TIC, float(np.linalg.norm(est.G)))
    if not ok:
        est.Bgs[:] = Bgs_backup
        return False
    s = x[-1]

    # ---- apply (visualInitialAlign, estimator.cpp:368-427)
    Ps = np.zeros((B, 3))
    for i in range(B):
        Ps[i] = s * T_cam[i] - R_body[i] @ TIC
    Ps = Ps - Ps[0]
    Vs = np.einsum("bij,bj->bi", R_body, x[: 3 * B].reshape(B, 3))

    R0 = _h(g2R, g_c0)
    yaw = float(_h(mat_to_ypr, R0 @ R_body[0])[0])
    R0 = _h(ypr_to_mat, [-yaw, 0.0, 0.0]) @ R0

    est.Ps[:] = np.einsum("ij,bj->bi", R0, Ps)
    est.Vs[:] = np.einsum("ij,bj->bi", R0, Vs)
    est.Qs[:] = _h(mat_to_quat, np.einsum("ij,bjk->bik", R0, R_body))
    est.Bas[:] = 0.0

    # depths: reset and let the estimator re-triangulate at metric poses
    est.f_manager.depth[:] = -1.0
    return True
