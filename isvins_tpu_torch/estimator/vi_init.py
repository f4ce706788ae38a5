"""Visual-inertial initialization steps that the first solve after init
runs (torch port of the two functions of isvins_tpu/estimator/vi_init.py
that the steady slice needs: refine_gyro_bias and realign_window). The SfM
chain of that module (seed pair, global SfM, PnP, run_visual_inertial_init)
is not ported yet; see estimator/initialization.py.

Host math in f64 numpy; the small geometry helpers run as f64 torch on the
CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..factors.preintegration import Preintegration
from ..geom import g2R, mat_to_quat, mat_to_ypr, quat_to_mat, ypr_to_mat
from ..initial import linear_alignment, solve_gyroscope_bias
from ..utils.convert import to_numpy_tree


def _np(t):
    return t.detach().cpu().numpy()


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
    B = est.dims.B
    pre_all = est._imu_factors()
    valid = pre_all.valid.cpu().numpy()
    if not valid.all():
        # segment pairing (R[k], R[k+1]) <-> pres[k] breaks with holes;
        # init windows normally have every segment valid
        return 0.0
    R_body = _np(quat_to_mat(torch.as_tensor(est.Qs)))
    pre_np = to_numpy_tree(pre_all.pre)
    pres = [Preintegration(*(a[k] for a in pre_np)) for k in range(B - 1)]
    dbg = solve_gyroscope_bias(R_body, pres)
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
    pre_np = to_numpy_tree(est._imu_factors().pre)
    pres = [Preintegration(*(a[k] for a in pre_np)) for k in range(B - 1)]
    ok, g_w, x = linear_alignment(
        R_body, T_cam, pres, TIC, float(np.linalg.norm(est.G))
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
