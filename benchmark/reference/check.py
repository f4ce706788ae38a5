"""The comparison that decides `correct`.

Every number follows the program step by step from the program's own
state: the reference takes the inputs that the timed path handed to a
layer (copied by benchmark/capture.py), works out again in float64 what
that layer derived from them, with the frozen plain code of
benchmark/reference/vio, and reads the gap to what the layer produced:

| number | layer | gap |
|---|---|---|
| trk_lk_px | tracker: CLAHE, pyramid, LK of the published tracks | the largest pixel distance of a track the program kept to the reference's LK from the same start, over the tracks whose window the reference finds well conditioned (TRACK_COND) |
| trk_lift_px | tracker: the undistortion of the published points through the configuration's camera model | the largest distance on the normalized plane (z = 1) of a packet's point to the reference's lift of its pixel (benchmark/traffic/camera.py), times fx |
| k1_rows_rel_gap | K1: the projection rows of the steady solve (on the extrinsic branch, where the configuration estimates the extrinsic, the rows of projection_residual_jacobians) | the largest over the call's valid rows whose point lies inside the camera's view in the reference (ROW_COND) of the row's largest gap (r, J_pi, J_pj, J_dep; and J_ex on the extrinsic branch) over the row's largest magnitude |
| k2_rows_rel_gap | K2: the IMU rows | the largest over the call's factors with IMU samples of the same (r, Jcat) |
| normal_eq_rel_gap | the normal matrices K1's and K2's rows are summed into (per frame, frame pair and landmark: the segment sums) | the largest gap of an entry of H or W over the bound its terms set (sqrt(H_ii H_jj) for H_ij, sqrt(h_l H_jj) for W_lj) |
| k4_step_backward_err | K4: the Schur-reduced, damped LM step | how far (dx, dl) is from solving the system built from the call's arguments, entry by entry over the sizes of its terms |
| solve_cost_excess | steady solve (DLT seeding, preintegration, 10 LM iterations through K1-K4) and its install | the window's float64 cost at the program's answer over that at the reference's answer, less 1; infinite where the estimator's installed state is not the answer re-anchored (with the answer's tic and qic where the configuration estimates the extrinsic) |
| marg_rel_gap | marginalization (forward and backward, the pose-graph packet) | largest gap of any output leaf, over that leaf's largest magnitude or the median leaf's, whichever is larger |
| loop_pnp_gap_m | loop verification (PnP-RANSAC and refit) | largest gap in camera centre; an accept decision or an inlier set that differs reads infinite |
| pg_cost_excess | pose graph: the optimized keyframe poses | the segment's float64 cost at the program's poses over that at the reference's, less 1 |
| pg_cov_rel_gap | pose graph: per-keyframe 6x6 covariance | largest gap of a block to the float64 covariance at the answer's own poses, over that block's largest entry |

Each reading is the worst over a sample of the window's answers drawn
from the seed.

`control=True` puts the reference itself in the program's place, in the
nearest precision below the one the configuration states that reaches
what decides the layer's answer (TF32 products for K2's and K4's rows and
for K1's rows on the extrinsic branch, whose row function multiplies 3x3
matrices; bfloat16 for the tracker, its lift and K1, which have no
product, and, as storage of every float32 result, for the steady solve's
and the pose graph's answers, where TF32 products change nothing that
float32 does not; float32 for the float64 layers), and reads its gap to
the float64 reference the same way. Nothing here imports the port."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..traffic import camera
from .precision import Bf16Storage, Tf32Products
from .vio.estimator.marginalization import PoseGraphPacket, marg_backward, marg_forward
from .vio.estimator.steady import device_triangulate, steady_solve
from .vio.factors import ImuNoise, integrate_segment
from .vio.factors.projection import projection_residual_jacobians
from .vio.factors.preintegration import Preintegration
from .vio.frontend.image_ops import clahe
from .vio.frontend.lk import _dot, _shift_bilinear, _Windows, padded_pyramid, pyramidal_lk
from .vio.geom import hostmath as hm
from .vio.initial.pnp import pnp_ransac_gn
from .vio.ops.imu import imu_rows_ref
from .vio.ops.linstep import linstep_ref
from .vio.ops.proj import proj_rows_ref
from .vio.posegraph.optimize_core import _optimize_core
from .vio.solver.window import (ImuFactors, PriorState, ProjFactors, RollPitchFactors,
                                WindowDims, WindowState, build_normal_equations, window_cost)

_CLASSES = {c.__name__: c for c in (WindowState, ProjFactors, ImuFactors, PriorState,
                                    RollPitchFactors, Preintegration, PoseGraphPacket)}

# the numbers compared (each with a limit in the configuration), and those
# of them that only a configuration with loop closure has
NUMBERS = ("trk_lk_px", "trk_lift_px", "k1_rows_rel_gap", "k2_rows_rel_gap", "normal_eq_rel_gap",
           "k4_step_backward_err", "solve_cost_excess", "marg_rel_gap", "loop_pnp_gap_m", "pg_cost_excess",
           "pg_cov_rel_gap")
LOOP_NUMBERS = ("loop_pnp_gap_m", "pg_cost_excess", "pg_cov_rel_gap")

# the rules that leave an answer out of a largest gap, both computed from
# the reference: a track whose level-0 window has a gradient matrix with
# eigenvalues further apart than TRACK_COND (a window on one straight
# edge: LK's position along the edge rests on rounding), and a K1 row whose
# point lies more than ROW_COND times further from camera j than in front
# of it (over 84 degrees off the optical axis, where no frame can show it:
# LM trials that carry a landmark to the camera plane, whose 1 / z
# amplifies rounding up to 1e5 times at the 1e-6 clamp)
TRACK_COND = 100.0
ROW_COND = 10.0

# the installed state against the answer re-anchored: the same float64
# host code on both sides
INSTALL_TOL = 1e-9


class Reading(NamedTuple):
    name: str
    value: float  # the worst over the answers compared
    count: int  # answers compared
    values: tuple = ()  # each answer's reading


def thaw(tree, dtype, device):
    """A frozen tree (benchmark/capture.freeze) as the reference's
    NamedTuples of tensors, float leaves as `dtype`."""
    if isinstance(tree, tuple) and tree and isinstance(tree[0], str) and tree[0] in _CLASSES:
        return _CLASSES[tree[0]](*(thaw(v, dtype, device) for v in tree[1:]))
    if isinstance(tree, tuple):
        return tuple(thaw(v, dtype, device) for v in tree)
    t = torch.as_tensor(np.array(tree), device=device)
    return t.to(dtype) if t.is_floating_point() else t


def _leaves(tree):
    """The array leaves of a frozen or a tensor tree, in order (class names
    dropped)."""
    if isinstance(tree, tuple):
        items = tree[1:] if tree and isinstance(tree[0], str) else tree
        return [x for v in items for x in _leaves(v)]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().cpu().double().numpy() if tree.is_floating_point()
                else tree.detach().cpu().numpy()]
    return [np.asarray(tree)]


def _arrays(xs):
    return tuple(x.detach().cpu().double().numpy() if isinstance(x, torch.Tensor)
                 else np.asarray(x) for x in xs)


def _finite_max(a):
    a = np.asarray(a, np.float64)
    return float(np.max(a)) if a.size and np.all(np.isfinite(a)) else math.inf


class Reference:
    """The reference for one configuration (its JSON dict). `control`:
    run in the precision below the configuration's instead of float64."""

    def __init__(self, cfg: dict, device, control: bool = False):
        self.cfg, self.device, self.control = cfg, torch.device(device), control
        eng = cfg["engine"]
        self.dims = WindowDims(**cfg["dims"])
        n = eng["noise"]
        self.noise = ImuNoise(float(n["acc_n"]), float(n["gyr_n"]), float(n["acc_w"]),
                              float(n["gyr_w"]))
        self.solver = eng["solver"]
        self.tracker = eng["tracker"]
        self.camera = eng["camera"]
        self.estimate_extrinsic = bool(eng["estimate_extrinsic"])

    def _f32_layer(self):
        """dtype and mode of a float32 layer judged by its matrix products'
        rows (K2's IMU rows, K4's step)."""
        if self.control:
            return torch.float32, Tf32Products()
        return torch.float64, _NoMode()

    def _elementwise_layer(self):
        """dtype and mode of a float32 layer with no matrix product (the
        tracker's CLAHE, pyramid and LK; K1's projection rows): TF32
        reaches none of its arithmetic, so the precision below that does is
        bfloat16."""
        return (torch.bfloat16 if self.control else torch.float64), _NoMode()

    def _f64_layer(self):
        return (torch.float32 if self.control else torch.float64), _NoMode()

    def _answer_layer(self):
        """dtype and mode of a float32 layer judged by its answer (the
        steady solve, the pose graph): the control keeps every float32
        result in bfloat16."""
        if self.control:
            return torch.float32, Bf16Storage()
        return torch.float64, _NoMode()

    # ---------------------------------------------------------- each layer
    def solve(self, inputs):
        """(state, cost of a state): the steady solve's state from the
        inputs the program uploaded, and the window's robust cost in
        float64 as a function of a (frozen) state, on the problem that solve
        posed (depths seeded and segments preintegrated as steady_solve
        does before its LM)."""
        dtype, mode = self._answer_layer()
        with mode:
            st, im_raw, tri, pr, pri, g, ps = thaw(inputs, dtype, self.device)
            out, _ = steady_solve(st, im_raw, tri, pr, pri, g, ps, self.dims,
                                  int(self.solver["max_iterations"]), self.estimate_extrinsic,
                                  self.noise, float(self.solver["max_depth"]))
        st, im_raw, tri, pr, pri, g, ps = thaw(inputs, torch.float64, self.device)
        obs, has_obs, start, need = tri
        d = device_triangulate(st, obs, has_obs, start)
        ok = torch.isfinite(d) & (d > 0.1)
        inv = 1.0 / torch.clamp(d, 0.1, float(self.solver["max_depth"]))
        st = st._replace(dep=torch.where(need & ok, inv, st.dep))
        dts, accs, gyrs, a0, g0, valid = im_raw
        im = ImuFactors.create(pre=integrate_segment(dts, accs, gyrs, a0, g0, st.Ba[:-1],
                                                     st.Bg[:-1], self.noise), valid=valid)

        def cost(state):
            x = state if isinstance(state, WindowState) else thaw(state, torch.float64,
                                                                  self.device)
            x = WindowState(*(t.to(torch.float64) for t in x))
            return float(window_cost(x, im, pr, pri, g, ps, self.dims))
        return out, cost

    def marg(self, inputs):
        """(forward, backward) of the marginalization job's snapshot."""
        dtype, mode = self._f64_layer()
        state, pr, mp_i, mp_j, mf, mv, psi, header0, imu_seg, G = inputs
        alpha = float(self.solver["alpha"])
        with mode:
            st, pri, mpi, mpj, mfi, mva, g = thaw((state, pr, mp_i, mp_j, mf, mv, G), dtype,
                                                  self.device)
            fwd = marg_forward(st, pri, mpi, mpj, mfi, mva, float(np.asarray(psi)), alpha,
                               float(np.asarray(header0)))
            seg = [torch.as_tensor(np.array(a), device=self.device).to(dtype) for a in imu_seg]
            pre = integrate_segment(*seg, self.noise)
            back = marg_backward(st, pre, pri, g, Vo=self.dims.Vo, alpha=alpha)
        return fwd, back

    def pnp(self, inputs, kw):
        dtype, mode = self._f64_layer()
        pts3d, pts2d, q0, t0 = inputs
        with mode:
            return pnp_ransac_gn(pts3d, pts2d, q0, t0, device=self.device, dtype=dtype, **kw)

    def optimize(self, rows, iters: int, cov_at=None):
        """(t, q, cov, cost) of the dense pose-graph solve of the captured
        segment, built as posegraph/optimize.py builds its arguments."""
        dtype, mode = self._answer_layer()
        n = len(rows["vio_t"])
        fixed = np.zeros(n, bool)
        fixed[0] = True
        fixed |= rows["seq"] == 0
        edge_valid = np.zeros(n, bool)
        edge_valid[: n - 1] = rows["edge_valid"][: n - 1]
        L = max(len(rows["loops"]), 1)
        loop_i, loop_j = np.zeros(L, np.int64), np.zeros(L, np.int64)
        loop_dt, loop_dq = np.zeros((L, 3)), np.tile([1.0, 0, 0, 0], (L, 1))
        loop_w, loop_valid = np.zeros(L), np.zeros(L, bool)
        for li, (i, j, dt, dq, w) in enumerate(rows["loops"]):
            loop_i[li], loop_j[li], loop_dt[li], loop_dq[li], loop_w[li] = i, j, dt, dq, w
            loop_valid[li] = True
        host = (rows["vio_t"], rows["vio_q"], rows["edge_dt"], rows["edge_dq"], rows["edge_sqrt"],
                edge_valid, rows["rp_q"], rows["rp_sqrt"], rows["rp_valid"], loop_i, loop_j,
                loop_dt, loop_dq, loop_w, loop_valid, fixed)
        with mode:
            args = [torch.as_tensor(np.ascontiguousarray(a), device=self.device) for a in host]
            args = [a.to(dtype) if a.is_floating_point() else a for a in args]
            if cov_at is not None:
                cov_at = tuple(torch.as_tensor(np.asarray(x), device=self.device) for x in cov_at)
            return _optimize_core(*args, iters=iters, cov_at=cov_at)

    def normal_equations(self, args):
        """(H, b, h, W, b_l, cost) of the window's normal equations at the
        LM state of a copied build, from its factors (the program's IMU
        factors, as K2 takes them)."""
        dtype, mode = self._f32_layer()
        with mode:
            st, imu, pr, pri, g, ps = thaw(args, dtype, self.device)
            return build_normal_equations(st, imu, pr, pri, g, ps, self.dims,
                                          self.estimate_extrinsic)

    def kernel(self, name: str, args):
        """The plain version of a kernel wrapper on its copied arguments:
        K1 proj_rows (r, J_pi, J_pj, J_dep), on the extrinsic branch
        projection_residual_jacobians (r, J_pi, J_pj, J_ex, J_dep), K2
        imu_rows (r, Jcat), K4 linstep (dx, dl)."""
        dtype, mode = (self._elementwise_layer() if name == "proj_rows" else self._f32_layer())
        T = lambda a: (torch.as_tensor(np.asarray(a), device=self.device).to(dtype)
                       if np.asarray(a).dtype.kind == "f" else
                       torch.as_tensor(np.asarray(a), device=self.device))
        with mode:
            if name == "linstep":
                H, b, W, h, b_l, lam, n_pose = args
                return linstep_ref(T(H), T(b), T(W), T(h), T(b_l), T(lam), int(n_pose),
                                   np.asarray(H).shape[0])
            fn = {"proj_rows": proj_rows_ref, "proj_rows_ex": projection_residual_jacobians,
                  "imu_rows": imu_rows_ref}[name]
            return fn(*(T(a) for a in args))

    def lift(self, pts_px):
        """The normalized points (M, 2), z = 1, of pixels (M, 2) lifted
        through the configuration's camera model, as float64 NumPy."""
        dtype, mode = self._elementwise_layer()
        uv = torch.as_tensor(np.asarray(pts_px, np.float64), device=self.device).to(dtype)
        with mode:
            xy = camera.z1(camera.lift(self.camera, uv))[..., :2]
        return xy.double().cpu().numpy()

    def lk(self, img0, img1, pts0, valid0):
        """The tracker's LK of pts0 from frame img0 to img1 (uint8 host
        images): CLAHE, the padded pyramid and pyramidal LK as the tracker's
        device step runs them. Returns (pts1 (M, 2) as float64 NumPy, the
        condition of each track's level-0 gradient matrix in img0: the
        ratio of its eigenvalues, infinite where the smaller is 0)."""
        dtype, mode = self._elementwise_layer()
        half = int(self.tracker["lk_win"]) // 2
        levels = int(self.tracker["lk_levels"])
        T = lambda a: torch.as_tensor(np.asarray(a), device=self.device)
        with mode:
            ims = []
            for im in (img0, img1):
                imf = T(im).to(dtype)
                ims.append(clahe(imf, dtype=dtype) if self.tracker["equalize"] else imf)
            p0 = T(pts0).to(dtype)
            pts1, _, _ = pyramidal_lk(ims[0], ims[1], p0, T(valid0), levels=levels, half=half)
            # the template's gradient matrix at level 0, as _lk_level forms it
            P = 2 * half + 1
            win = _Windows(padded_pyramid(ims[0], 1, half + 3)[0], half + 3, P + 3)
            q0, fx0, fy0 = win(p0 - half)
            dx = 0.5 * (_shift_bilinear(q0, fx0, fy0, P, 0, 1) - _shift_bilinear(q0, fx0, fy0, P, 0, -1))
            dy = 0.5 * (_shift_bilinear(q0, fx0, fy0, P, 1, 0) - _shift_bilinear(q0, fx0, fy0, P, -1, 0))
            gxx, gxy, gyy = (_dot(a, b).double() for a, b in ((dx, dx), (dx, dy), (dy, dy)))
        mid, rad = 0.5 * (gxx + gyy), torch.sqrt(0.25 * (gxx - gyy) ** 2 + gxy * gxy)
        lo, hi = mid - rad, mid + rad
        cond = torch.where(lo > 0, hi / lo.clamp(min=1e-300), torch.full_like(hi, math.inf))
        return pts1.double().cpu().numpy(), cond.cpu().numpy()


class _NoMode:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


# ------------------------------------------------------------- the gaps
def ex_rows_as_k1(args, valid):
    """The arguments of a call of the extrinsic branch's row function
    (pts_i, pts_j, Pi, Qi, Pj, Qj, tic, qic, inverse depth) laid out as
    K1's, with the solve's projection-factor mask as K1's last argument."""
    return tuple(args[:6]) + tuple(np.asarray(a).reshape(-1, np.shape(a)[-1])
                                   for a in args[6:8]) + (args[8], valid)


def row_cond(args):
    """Per row of a K1 call, in float64 from its arguments: the distance
    of the row's point from camera j over its depth in front of it,
    |c_j| / |z_j| (infinite at z_j = 0; NaN where the arguments are not
    finite, a row that is then compared as it is)."""
    from .vio.solver.proj_fast import _qconj, _qrot

    T = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    pts_i, _, Pi, Qi, Pj, Qj, tic, qic, dep, valid = (T(a) for a in args)
    one = torch.ones_like(dep)
    d = torch.where((valid > 0) & (dep.abs() > 1e-8), dep, one)
    qi, qj = tuple(Qi[:, k] for k in range(4)), tuple(Qj[:, k] for k in range(4))
    qc = tuple(qic[..., k] * one for k in range(4))
    tc = tuple(tic[..., k] * one for k in range(3))
    bi = _qrot(qc, tuple(pts_i[:, k] / d for k in range(3)))
    wpt = _qrot(qi, tuple(bi[k] + tc[k] for k in range(3)))
    bj = _qrot(_qconj(qj), tuple(wpt[k] + Pi[:, k] - Pj[:, k] for k in range(3)))
    cj = torch.stack(_qrot(_qconj(qc), tuple(bj[k] - tc[k] for k in range(3))), -1)
    return (cj.norm(dim=-1) / cj[:, 2].abs()).numpy()


def reanchor(P, Q, V, P0_old, Q0_old):
    """(P, Q, V) of a solved window moved so that frame 0's yaw and
    position are those before the solve: a frozen copy of
    isvins_tpu_torch/estimator/estimator.py's Estimator._reanchor."""
    Q, P, V = (np.asarray(x, np.float64) for x in (Q, P, V))
    ypr_old = hm.mat_to_ypr_np(hm.quat_to_mat_np(np.asarray(Q0_old)))
    ypr_new = hm.mat_to_ypr_np(hm.quat_to_mat_np(Q[0]))
    y_diff = ypr_old[0] - ypr_new[0]
    if abs(abs(ypr_old[1]) - 90) < 1.0 or abs(abs(ypr_new[1]) - 90) < 1.0:
        rot = hm.quat_to_mat_np(np.asarray(Q0_old)) @ hm.quat_to_mat_np(Q[0]).T
    else:
        rot = hm.ypr_to_mat_np([y_diff, 0.0, 0.0])
    rq = hm.mat_to_quat_np(rot)
    P_new = (P - P[0]) @ rot.T + np.asarray(P0_old)
    Q_new = np.stack([hm.quat_normalize_np(hm.quat_mul_np(rq, Q[k])) for k in range(Q.shape[0])])
    return P_new, Q_new, V @ rot.T


def install_gap(answer, installed, anchor, extrinsic: bool = False) -> float:
    """Largest gap of the installed (P, Q, V, Ba, Bg) to the answer (a
    frozen WindowState) re-anchored at `anchor` (P0_old, Q0_old); with
    `extrinsic`, also of the installed (tic, qic) to the answer's, which
    the re-anchoring leaves as they are."""
    _, P, Q, V, Ba, Bg, tic, qic = answer[:8]
    want = reanchor(P, Q, V, *anchor) + (np.asarray(Ba), np.asarray(Bg))
    if extrinsic:
        want += (np.asarray(tic), np.asarray(qic))
    if len(installed) < len(want):
        return math.inf
    gaps = [np.max(np.abs(np.asarray(a, np.float64) - b)) if np.shape(a) == np.shape(b) else math.inf
            for a, b in zip(installed, want)]
    return float(max(gaps)) if all(np.isfinite(gaps)) else math.inf


def rel_tree_gap(ref_tree, prog_tree):
    """Largest gap of any float leaf, over that leaf's largest magnitude or
    the median leaf's largest magnitude, whichever is larger; a non-float
    leaf that differs, or a shape that differs, reads infinite."""
    a, b = _leaves(prog_tree), _leaves(ref_tree)
    if len(a) != len(b):
        return math.inf
    scales = [float(np.max(np.abs(y))) for y in b if y.dtype.kind == "f" and y.size]
    med = float(np.median(scales)) if scales else 0.0
    worst = 0.0
    for x, y in zip(a, b):
        x = np.asarray(x)
        if x.shape != y.shape:
            return math.inf
        if y.dtype.kind != "f":
            if not np.array_equal(x.astype(y.dtype), y):
                return math.inf
            continue
        if not (np.all(np.isfinite(y)) and np.all(np.isfinite(x))):
            return math.inf
        if y.size == 0:
            continue
        scale = max(float(np.max(np.abs(y))), med, 1e-300)
        worst = max(worst, float(np.max(np.abs(x.astype(np.float64) - y))) / scale)
    return worst


def row_gaps(ref_out, prog_out):
    """Per row of a kernel's outputs (leading axis): the largest gap of the
    row's entries over the largest magnitude of the reference's finite
    ones. An entry that is not finite on both sides agrees (an LM trial
    from a rejected, non-finite step evaluates to NaN on both); one that is
    not finite on one side only makes its row infinite."""
    n = ref_out[0].shape[0]
    flat = lambda xs: np.concatenate([np.asarray(x, np.float64).reshape(n, -1) for x in xs], 1)
    r, p = flat(ref_out), flat(prog_out)
    fr, fp = np.isfinite(r), np.isfinite(p)
    both = fr & fp
    with np.errstate(invalid="ignore", divide="ignore"):
        d = np.where(both, np.abs(p - r), 0.0).max(1)
        scale = np.where(fr, np.abs(r), 0.0).max(1)
        g = d / np.maximum(scale, 1e-300)
    g[(fr != fp).any(1)] = np.inf
    return g


def normal_eq_gap(ref_out, prog_out, B: int) -> float:
    """The largest gap of the program's normal matrices (H, and the
    landmark coupling W) to the reference's, each entry over the bound that
    its terms set: a sum of products of whitened rows J_ri J_rj is at most
    sqrt(H_ii H_jj) term by term (Cauchy-Schwarz), W_lj at most
    sqrt(h_l H_jj), so rounding moves each entry by a multiple of its bound
    whatever the cancellation. (The right-hand sides and the landmark
    diagonal carry the rounding of the residuals and of J_dep themselves,
    K1's and K2's; a row left out shows in H.) Entries not finite on both
    sides agree (an LM trial from a rejected step); on one side only, the
    gap is infinite."""
    H_r, _, h_r, W_r = (np.asarray(x, np.float64) for x in _arrays(ref_out[:4]))
    H_p, _, _, W_p = (np.asarray(x, np.float64) for x in _arrays(prog_out[:4]))
    d = np.sqrt(np.clip(np.diagonal(H_r), 0.0, None))
    dW = np.concatenate([d[:6 * B], d[15 * B:15 * B + 6]])
    sh = np.sqrt(np.clip(h_r, 0.0, None))

    def gap(p, r, scale):
        if p.shape != r.shape:
            return math.inf
        fp, fr = np.isfinite(p), np.isfinite(r)
        if np.any(fp != fr):
            return math.inf
        diff = np.where(fp, np.abs(p - r), 0.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            g = np.where(diff == 0.0, 0.0, diff / scale)
        return float(np.max(g)) if g.size else 0.0

    return max(gap(H_p, H_r, np.outer(d, d)), gap(W_p, W_r, np.outer(sh, dW)))


def linstep_backward_error(args, out) -> float:
    """How far K4's step (dx, dl) is from solving the system it was given,
    in float64: the Schur-reduced, damped system H_d dx = b_s and the
    landmark back-substitution h_d dl = b_l - W dx_r, built from the call's
    arguments as linstep_ref builds them. Each residual over the sizes of
    its terms (|H_d| |dx| + |b_s|, entry by entry, the largest ratio), the
    larger of the two: a backward error, which a float32 solve keeps near
    its rounding whatever the system's condition, and which a system formed
    otherwise (lower-precision products, rows left out) does not."""
    T = lambda a: (a.detach().to("cpu", torch.float64) if isinstance(a, torch.Tensor)
                   else torch.as_tensor(np.asarray(a), dtype=torch.float64))
    H, b, W, h, b_l, lam = (T(a) for a in args[:6])
    n_pose, D = int(args[6]), H.shape[0]
    dx, dl = (T(o) for o in out[:2])
    Dr = W.shape[1]
    h_d = h * (1.0 + lam)
    h_safe = torch.where(h_d > 1e-12, h_d, torch.ones_like(h_d))
    Wi = W / h_safe[:, None]
    C, c_b = W.T @ Wi, W.T @ (b_l / h_safe)
    ex0 = D - (Dr - n_pose)
    rows = torch.cat([torch.arange(n_pose), torch.arange(ex0, D)])
    H_s = H.clone()
    H_s[rows[:, None], rows[None, :]] -= C
    b_s = b.clone()
    b_s[rows] -= c_b
    diagH = torch.clamp(torch.diagonal(H), min=1e-8)
    H_d = H_s + torch.diag(lam * diagH)
    H_d = H_d + 1e-12 * torch.trace(H_d) / D * torch.eye(D, dtype=H.dtype)
    if not (torch.isfinite(dx).all() and torch.isfinite(dl).all()):
        # K4 answers a system that is not positive definite with NaN (the LM
        # then rejects the step): right where float32 cannot tell the
        # system from a singular one, wrong elsewhere
        ev = torch.linalg.eigvalsh(0.5 * (H_d + H_d.T))
        f32_singular = not torch.isfinite(ev).all() or ev[0] <= 64 * 2.0**-24 * ev[-1].abs()
        return 0.0 if f32_singular else math.inf
    r1 = (H_d @ dx - b_s).abs() / (H_d.abs() @ dx.abs() + b_s.abs()).clamp(min=1e-300)
    dx_r = dx[rows]
    rhs = b_l - W @ dx_r
    r2 = (h_safe * dl - rhs).abs() / (h_safe * dl.abs() + b_l.abs() + W.abs() @ dx_r.abs()).clamp(min=1e-300)
    return float(max(r1.max(), r2.max()))


def pnp_gap(ref_out, prog_out):
    """Camera-centre gap (m) of two PnP results (ok, q_cw, t_cw, inliers):
    infinite where the accept decision or the inlier set differs."""
    ok_r, q_r, t_r, inl_r = ref_out
    ok_p, q_p, t_p, inl_p = prog_out
    if bool(ok_r) != bool(ok_p) or not np.array_equal(np.asarray(inl_r), np.asarray(inl_p)):
        return math.inf
    c = lambda q, t: -_quat_to_mat(np.asarray(q, np.float64)).T @ np.asarray(t, np.float64)
    return _finite_max(np.linalg.norm(c(q_p, t_p) - c(q_r, t_r)))


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def cost_excess(c_prog: float, c_ref: float) -> float:
    """The float64 cost at the program's answer over that at the
    reference's, less 1; infinite where either is not finite."""
    if not (math.isfinite(c_prog) and math.isfinite(c_ref)) or c_ref <= 0:
        return math.inf
    return (c_prog - c_ref) / c_ref


def cov_gap(cov_ref, cov_prog) -> float:
    """Largest gap of a 6x6 covariance block over the block's largest
    entry in the reference."""
    cov_r, cov_p = (np.asarray(x, np.float64) for x in (cov_ref, cov_prog))
    if cov_r.shape != cov_p.shape:
        return math.inf
    scale = np.maximum(np.abs(cov_r).reshape(len(cov_r), -1).max(axis=1), 1e-300)
    return _finite_max(np.abs(cov_p - cov_r).reshape(len(cov_r), -1).max(axis=1) / scale)


# ------------------------------------------------------------ the sample
def sample(n: int, k: int, rng) -> list:
    """k of range(n), drawn from rng, in order (all of them when n <= k)."""
    if n <= k:
        return list(range(n))
    return sorted(int(i) for i in rng.choice(n, size=k, replace=False))


def track_pairs(tracks: dict):
    """Frames k whose tracker state and the previous frame's were both
    copied: the LK of k - 1 -> k can be followed."""
    return [k for k in sorted(tracks) if k - 1 in tracks]


def evaluate(captures, frames, cfg: dict, counts: dict, seed: int, device,
             control: bool = False, notes: dict | None = None):
    """The numbers of one run: a Reading per number the cell has, each the
    worst over a sample of the window's answers drawn from `seed`. With
    control=True the reference in the lower precision is read in the
    program's place. `notes` receives how many tracks and K1 rows the
    rules left out of how many."""
    notes = {} if notes is None else notes
    notes.update(tracks_left_out=0, tracks=0, k1_rows_left_out=0, k1_rows=0)
    rng = np.random.default_rng(seed)
    ref = Reference(cfg, device)
    low = Reference(cfg, device, control=True) if control else None
    out = {}

    def keep(name, values):
        out[name] = Reading(name, max(values) if values else math.nan, len(values),
                            tuple(values))

    # tracker: LK of the tracks that survived frame k - 1 -> k, the largest
    # gap over the well-conditioned ones
    gaps = []
    pairs = track_pairs(captures.tracks)
    for k in (pairs[i] for i in sample(len(pairs), counts["tracks"], rng)):
        s0, s1 = captures.tracks[k - 1], captures.tracks[k]
        kept = (s0["valid"] & s1["valid"] & (s0["ids"] == s1["ids"])
                & (s1["track_cnt"] == s0["track_cnt"] + 1))
        p_ref, cond = ref.lk(frames[k - 1], frames[k], s0["pts"], s0["valid"])
        notes["tracks"] += int(kept.sum())
        notes["tracks_left_out"] += int((kept & ~(cond <= TRACK_COND)).sum())
        kept &= cond <= TRACK_COND
        if not kept.any():
            continue
        p_prog = (low.lk(frames[k - 1], frames[k], s0["pts"], s0["valid"])[0] if control
                  else s1["pts"])
        gaps.append(_finite_max(np.linalg.norm(p_prog[kept] - p_ref[kept], axis=1)))
    keep("trk_lk_px", gaps)

    # the steady solve's kernels, each copied call against its plain version
    # in float64 on the same arguments, row by row over the rows the solve
    # reads: K1's valid projection rows (its last argument) whose point the
    # reference sees in front of camera j (ROW_COND), K2's factors with IMU
    # samples (sum_dt > 0; an empty segment's factor is masked out); K4 by
    # its backward error
    def k1_rows(a):
        valid = np.asarray(a[-1], bool)
        inside = ~(row_cond(a) > ROW_COND)
        notes["k1_rows"] += int(valid.sum())
        notes["k1_rows_left_out"] += int((valid & ~inside).sum())
        return valid & inside

    # on the extrinsic branch K1's rows come from projection_residual_jacobians
    # (J_ex among them), masked by the solve's projection factors
    for names, number, rows_of in (
            (("proj_rows", "proj_rows_ex"), "k1_rows_rel_gap",
             lambda c: k1_rows(ex_rows_as_k1(c["args"], c["valid"]) if "valid" in c
                               else c["args"])),
            (("imu_rows",), "k2_rows_rel_gap", lambda c: np.asarray(c["args"][13]) > 0)):
        gaps = []
        for name in names:
            for c in captures.kernels.get(name, []):
                r = _arrays(ref.kernel(name, c["args"]))
                p = _arrays(low.kernel(name, c["args"]) if control else c["out"])
                g = row_gaps(r, p)[rows_of(c)]
                if g.size:
                    gaps.append(float(np.max(g)))
        keep(number, gaps)
    gaps = []
    for c in captures.kernels.get("normal_equations", []):
        r = ref.normal_equations(c["args"])
        p = low.normal_equations(c["args"]) if control else c["out"]
        gaps.append(normal_eq_gap(r, p, ref.dims.B))
    keep("normal_eq_rel_gap", gaps)
    back = []
    for c in captures.kernels.get("linstep", []):
        p = tuple(low.kernel("linstep", c["args"])) if control else c["out"]
        back.append(linstep_backward_error(c["args"], p))
    keep("k4_step_backward_err", back)

    # the steady solve's answer, by its float64 cost on the problem it
    # posed, and the estimator's install of it
    excess = []
    for i in sample(len(captures.solves), counts["solves"], rng):
        c = captures.solves[i]
        st_ref, cost = ref.solve(c["inputs"])
        prog = c["state"]
        if control:
            st_low, _ = low.solve(c["inputs"])
            prog = ("WindowState",) + tuple(x.double().cpu().numpy() for x in st_low)
        elif not install_gap(prog, c["installed"], c["anchor"],
                             ref.estimate_extrinsic) <= INSTALL_TOL:
            excess.append(math.inf)
            continue
        excess.append(cost_excess(cost(prog), cost(st_ref)))
    keep("solve_cost_excess", excess)

    # marginalization
    gaps = []
    for i in sample(len(captures.margs), counts["margs"], rng):
        c = captures.margs[i]
        r = ref.marg(c["inputs"])
        gaps.append(rel_tree_gap(r, low.marg(c["inputs"]) if control else c["out"]))
    keep("marg_rel_gap", gaps)

    if cfg["enable_loop"]:
        gaps = []
        for i in sample(len(captures.loops), counts["loops"], rng):
            c = captures.loops[i]
            r = ref.pnp(c["inputs"], c["kw"])
            p = low.pnp(c["inputs"], c["kw"]) if control else c["out"]
            gaps.append(pnp_gap(r, p))
        keep("loop_pnp_gap_m", gaps)
        # the pose graph: the float64 cost at the answer's poses against the
        # reference's, and the covariance against the float64 one at the
        # answer's own poses
        excess, dcov = [], []
        for i in sample(len(captures.optimizes), counts["optimizes"], rng):
            c = captures.optimizes[i]
            _, _, _, c_ref = ref.optimize(c["inputs"], c["iters"])
            p = c["out"]
            if control:
                p = tuple(x.double().cpu().numpy() for x in low.optimize(c["inputs"], c["iters"]))
            if p is None or not (np.all(np.isfinite(p[0])) and np.all(np.isfinite(p[1]))):
                excess.append(math.inf)
                dcov.append(math.inf)
                continue
            _, _, cov_at, c_at = ref.optimize(c["inputs"], 0, cov_at=(p[0], p[1]))
            excess.append(cost_excess(float(c_at), float(c_ref)))
            dcov.append(cov_gap(cov_at.double().cpu().numpy(), p[2]))
        keep("pg_cost_excess", excess)
        keep("pg_cov_rel_gap", dcov)

    # the tracker's undistortion: each copied packet's normalized points
    # against the reference's lift of its pixels (the capture drew the
    # packets from the seed; nothing is drawn here, so the samples above
    # stay those of a run without this number)
    gaps = []
    for c in captures.lifts:
        if len(c["pts_px"]) == 0:
            continue
        xy = ref.lift(c["pts_px"])
        p = low.lift(c["pts_px"]) if control else np.asarray(c["pts_norm"], np.float64)[:, :2]
        gaps.append(_finite_max(np.linalg.norm(p - xy, axis=1)) * float(ref.camera["fx"]))
    keep("trk_lift_px", gaps)
    return out


def judge(readings: dict, limits: dict):
    """(correct, [(name, value, limit, count)]): every number that the
    configuration gives a limit must have been read on at least one answer
    and lie at or under it."""
    rows, ok = [], True
    for name, r in readings.items():
        lim = float(limits.get(name, math.nan))
        ok &= r.count > 0 and math.isfinite(r.value) and r.value <= lim
        rows.append((name, r.value, lim, r.count))
    missing = [n for n in limits if n not in readings]
    ok &= not missing
    rows += [(n, math.nan, float(limits[n]), 0) for n in missing]
    return ok, rows
