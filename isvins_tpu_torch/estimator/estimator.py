"""Sliding-window VIO estimator: host state machine driving device solves
(torch port of isvins_tpu/estimator/estimator.py; reference
src/estimator.cpp).

The data-dependent control flow (INITIAL vs NON_LINEAR, MARGIN_OLD vs
MARGIN_NEW, failure reset) lives on the host in f64 numpy; the numeric work
runs on the estimator's device:
- the steady-state solve `steady_solve` in f32 (DLT depth seeding,
  preintegration, then solve_window through kernels K1-K4), its inputs moved
  once per frame (pinned host buffers, non-blocking copies);
- the init BA, the init scale scan and triangulation in f64 on the same
  device (the H100 has native f64); the f64 marginalization on the host
  CPU, where it runs faster than on the card.

`solve_async=True` pipelines the steady solve across frames
(dispatch_odometry / collect_solve): the solve is launched on a side CUDA
stream and installed at the start of the next frame; with `_defer_dispatch`
set, the prepared arguments wait for parallel/multi_seq.MultiSequenceSolver,
which solves several estimators' windows as one batch (K1, K2, K5).
Deliberate improvements over the reference kept from the JAX package:
preintegrations re-integrated at the current bias each solve, exact
pseudo-measurement drags applied after the gauge re-anchoring, and the VB
prior's velocity rows rotated by the re-anchoring rotation.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..config import EngineConfig
from ..device import device_const, resolve_device
from ..factors import ImuNoise, integrate_segment
from ..factors.priors import relpose_update_np, rollpitch_update_np, se3_prior_update_np
from ..geom import hostmath as hm
from ..initial.ex_rotation import ExtrinsicRotationCalibrator
from ..solver import (
    ImuFactors,
    PriorState,
    ProjFactors,
    RollPitchFactors,
    WindowDims,
    WindowState,
    solve_window,
    solve_window_batched,
)
from ..utils import perf
from ..utils.convert import from_numpy_tree, to_numpy_tree, tree_map
from .feature_manager import FeatureManager
from .marginalization import PoseGraphPacket, init_sparsify, marg_backward, marg_forward

_log = logging.getLogger(__name__)

INITIAL = 0
NON_LINEAR = 2

MARGIN_OLD = 0
MARGIN_NEW = 1


@dataclass
class KeyframePoints:
    """Per-keyframe export to the pose graph builder (System.cpp:356–397)."""

    ts: float
    points_w: np.ndarray  # (n,3)
    pts_norm: np.ndarray  # (n,2)
    ids: np.ndarray  # (n,)


def to_device(tree, device, dtype=None):
    """Host numpy tree -> tensors on `device` (float leaves cast to dtype).
    On CUDA every leaf goes through a pinned buffer and a non-blocking copy,
    so one frame's inputs stream to the card without per-leaf syncs."""
    if device.type != "cuda":
        return from_numpy_tree(tree, device, dtype)

    def pin(a):
        a = np.asarray(a)
        t = torch.as_tensor(np.ascontiguousarray(a)).reshape(a.shape)  # 0-d stays 0-d
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.pin_memory().to(device, non_blocking=True)

    return from_numpy_tree(tree_map(pin, tree), device)


# the three rounds of a cyclic Jacobi sweep of a 4x4, two disjoint pairs
# (p, q) each
_JACOBI_ROUNDS = (((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2)))


def _jacobi_consts(dtype, device):
    """Per round, on `device`: the rows and columns of a_pp, a_qq and a_pq
    of both pairs, and the (4, 16) map of both pairs' (c, s) to the
    rotation's entries (J_pp = J_qq = c, J_pq = s, J_qp = -s)."""
    rows, cols = [], []
    to_j = np.zeros((len(_JACOBI_ROUNDS), 4, 16))
    for r, pairs in enumerate(_JACOBI_ROUNDS):
        (p0, q0), (p1, q1) = pairs
        rows.append([p0, p1, q0, q1, p0, p1])
        cols.append([p0, p1, q0, q1, q0, q1])
        for i, (p, q) in enumerate(pairs):
            to_j[r, i, 5 * p] = to_j[r, i, 5 * q] = 1.0
            to_j[r, 2 + i, 4 * p + q], to_j[r, 2 + i, 4 * q + p] = 1.0, -1.0
    return device_const([rows, cols], torch.int64, device), device_const(to_j, dtype, device)


def min_eigvec_sym4(G, sweeps: int = 4):
    """The unit eigenvector of the smallest eigenvalue of each symmetric 4x4
    matrix of G (..., 4, 4), up to sign, by cyclic Jacobi: `sweeps` sweeps
    of three rounds, each round's two disjoint rotations made together
    (Numerical Recipes' angle, the smaller one) and applied as one
    orthogonal matrix J, A <- J^T A J: 18 device operations a round. A fixed
    count and no branch on the data, so nothing is read on the host
    (torch.linalg.eigh reads its error flags on the host on CUDA); Jacobi
    converges quadratically, and four sweeps of a 4x4 reach the rounding of
    its type (on the matrices of tests/test_torch_estimator.py a fifth sweep
    moves the f32 error not at all and the f64 error by under 1e-15)."""
    idx, to_j = _jacobi_consts(G.dtype, G.device)
    rounds = [(idx[0, r], idx[1, r], to_j[r]) for r in range(len(_JACOBI_ROUNDS))]
    A = G
    V = torch.eye(4, dtype=G.dtype, device=G.device).expand(G.shape)
    for _ in range(sweeps):
        for rows, cols, to_j_r in rounds:
            a = A[..., rows, cols]  # a_pp, a_qq, a_pq of both pairs
            d, two = a[..., 2:4] - a[..., 0:2], 2.0 * a[..., 4:6]
            # t = sgn(theta) / (|theta| + sqrt(theta^2 + 1)), theta = d / two;
            # 0 where the entry is 0 (0 / 0 when d is 0 too)
            t = torch.nan_to_num(two / (d + torch.copysign(torch.hypot(d, two), d)), nan=0.0)
            c = torch.rsqrt(t * t + 1.0)
            J = (torch.cat([c, t * c], dim=-1) @ to_j_r).reshape(G.shape)
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    k = torch.diagonal(A, dim1=-2, dim2=-1).argmin(dim=-1)
    return torch.gather(V, -1, k[..., None, None].expand(V.shape[:-1] + (1,)))[..., 0]


def device_triangulate(st: WindowState, obs, has_obs, start):
    """Masked multi-view DLT depth seeding on the device, (F,) metric depths
    (garbage where a track has < 2 observations; the caller masks). The
    nullspace is the eigenvector of the smallest eigenvalue of the 4x4 Gram
    matrix (min_eigvec_sym4: f32-safe, batched over all tracks, no host
    read). Every argument may carry the same leading sequence axes."""
    from .feature_manager import _dlt_systems

    A = _dlt_systems(obs, has_obs, start.long(), st.P, st.Q, st.tic, st.qic)
    v = min_eigvec_sym4(A.transpose(-1, -2) @ A)
    v3 = v[..., 3]
    return v[..., 2] / torch.where(v3.abs() > 1e-12, v3, torch.full_like(v3, 1e-12))


def steady_solve(st: WindowState, im_raw, tri, pr: ProjFactors, pri: PriorState, g, ps,
                 dims: WindowDims, iters: int, estimate_extrinsic: bool, noise: ImuNoise,
                 max_depth: float, info: dict | None = None):
    """The steady-state frame solve, all on the device: seed fresh landmark
    depths by masked DLT, preintegrate every segment at the in-state bias,
    then run the window LM (JAX `_steady_solve`, estimator.py:603-619). With
    a leading sequence axis on every leaf it is the batched solve of several
    estimators' windows (solve_window_batched). Reads nothing on the host;
    `info` receives the solve's iteration counts (device tensors)."""
    obs, has_obs, start, need = tri
    d = device_triangulate(st, obs, has_obs, start)
    ok = torch.isfinite(d) & (d > 0.1)
    inv = 1.0 / torch.clamp(d, 0.1, max_depth)
    st = st._replace(dep=torch.where(need & ok, inv, st.dep))
    dts, accs, gyrs, a0, g0, valid = im_raw
    pre = integrate_segment(dts, accs, gyrs, a0, g0, st.Ba[..., :-1, :], st.Bg[..., :-1, :],
                            noise)
    im = ImuFactors.create(pre=pre, valid=valid)
    solve = solve_window if st.P.dim() == 2 else solve_window_batched
    return solve(st, im, pr, pri, g, ps, dims, iters=iters,
                 estimate_extrinsic=estimate_extrinsic, info=info)


class PendingSolve:
    """A dispatched, not yet collected steady solve (one window, or a batch
    with a leading sequence axis). On the card the solve ran on a stream of
    its own and copied (state, cost) and the iterations each sequence took
    into pinned host buffers there; `collect()` waits on that stream's event
    and returns (state, cost) as f64 numpy (the host state's type), after
    which `iterations` holds the iteration counts (numpy int64) and, when
    utils.perf was on at the dispatch, `device_ms()` the stream's time from
    the start of the upload to the end of the download. `row(k)` is the same
    for sequence k of a batch."""

    def __init__(self, outputs, iterations, event=None, start=None):
        self._outputs = outputs  # (WindowState, cost), host tensors
        self._iterations = iterations
        self._event = event
        self._start = start
        self._host = None
        self.iterations = None

    def collect(self):
        if self._host is None:
            if self._event is not None:
                self._event.synchronize()
            self._host = tree_map(lambda o: o.numpy().astype(np.float64), self._outputs)
            self.iterations = self._iterations.numpy().astype(np.int64)
            self._outputs = self._iterations = None
        return self._host

    def device_ms(self):
        """The solve's stream time (upload, solve, download) after collect();
        None on the CPU or when it was not timed."""
        return None if self._start is None else self._start.elapsed_time(self._event)

    def row(self, k: int) -> "_PendingRow":
        return _PendingRow(self, k)


class _PendingRow:
    def __init__(self, batch: PendingSolve, k: int):
        self._batch = batch
        self._k = k

    @property
    def iterations(self):
        its = self._batch.iterations
        return None if its is None else its[self._k]

    def collect(self):
        return tree_map(lambda a: a[self._k], self._batch.collect())


def dispatch_steady(args, device, dims: WindowDims, iters: int, estimate_extrinsic: bool,
                    noise: ImuNoise, max_depth: float) -> PendingSolve:
    """Upload the host argument tree of steady_solve (as f32, the steady
    path's type), run the solve and start the download of its outputs,
    without waiting for them: nothing on the way reads the device on the
    host. On the card all three go to a new stream from the calling thread
    (the kernel launches take the thread's current stream), between two
    timing events while utils.perf is on, and every tensor of the solve
    lives until the stream's event through that stream's allocator; on the
    CPU the solve simply runs here."""
    def run():
        info = {}
        st, im_raw, tri, pr, pri, g, ps = to_device(args, device, torch.float32)
        out = steady_solve(st, im_raw, tri, pr, pri, g, ps, dims, iters, estimate_extrinsic,
                           noise, max_depth, info)
        return out, info["sequence_iterations"]

    if device.type != "cuda":
        return PendingSolve(*run())
    stream, timed = torch.cuda.Stream(device), perf.enabled()
    with torch.cuda.stream(stream):
        start = torch.cuda.Event(enable_timing=True) if timed else None
        if timed:
            start.record(stream)
        outs, its = tree_map(
            lambda o: torch.empty(o.shape, dtype=o.dtype, pin_memory=True).copy_(
                o, non_blocking=True), run())
        event = torch.cuda.Event(enable_timing=timed)
        event.record(stream)
    return PendingSolve(outs, its, event, start)


class Estimator:
    def __init__(self, cfg: EngineConfig, dims: Optional[WindowDims] = None,
                 device=None, solve_async: bool = False):
        """`device`: where the numeric work runs (None: the CUDA card; the
        CPU only on `device="cpu"`), but for the f64 marginalization, which
        runs on the host CPU, as the reference places it:
        its small f64 algebra is bound by launches on the card (on an H100
        one job took 81.5 ms there against 34.3 ms on the CPU, chip_smoke.py's
        slice phase).

        `solve_async=True` pipelines the steady-state window solve across
        frames: process_image DISPATCHES the device solve and returns; the
        result is collected (state installed, priors dragged, marginalization
        submitted, window slid) by collect_solve(), which the caller runs at
        the START of the next frame, before its IMU feed. Outputs are
        value-identical to the synchronous mode, delivered one frame later
        (drain `ready_poses`). Setting `_defer_dispatch` on such an estimator
        leaves the prepared solve to a MultiSequenceSolver."""
        self.cfg = cfg
        self.solve_async = bool(solve_async)
        self._defer_dispatch = False
        self.device = resolve_device(device)
        w = cfg.window
        self.dims = dims or WindowDims(B=w.all_size, Vo=w.vo_size, F=w.max_features, N=3072)
        self.C = w.max_imu_per_frame
        self.noise = ImuNoise.from_config(cfg.noise)
        self.G = np.asarray(cfg.gravity)
        self.min_parallax = cfg.solver.min_parallax_px / cfg.noise.pixel_sqrt_info

        # online extrinsic calibration mode (estimator.cpp:139-153): 2 = run
        # the hand-eye calibrator until confident, then drop to 1 = refine
        # the extrinsic block in the window solver; 0 = fixed. The runtime
        # mode and the calibrated rotation persist across failure resets
        # (the reference stores the promotion in the RIC global, which
        # clearState/setParameter re-install).
        self.estimate_extrinsic = int(cfg.estimate_extrinsic)
        self._calib_ric: Optional[np.ndarray] = None
        self.ex_calibrator = (ExtrinsicRotationCalibrator(vo_size=self.dims.Vo)
                              if self.estimate_extrinsic == 2 else None)
        self._marg_exec = None  # lazy ThreadPoolExecutor(1)
        self._marg_future = None
        self._marg_job_extra = None
        # the steady solves collected and the LM iterations they took before
        # converging (each runs cfg.solver.max_iterations), read after collect
        self.steady_solves = 0
        self.lm_iterations_taken = 0
        self.clear_state()

    def _new_feature_manager(self):
        return FeatureManager(self.dims.F, self.dims.B, self.dims.Vo, self.min_parallax,
                              self.cfg.solver.init_depth, self.cfg.solver.max_depth,
                              device=self.device)

    # ------------------------------------------------------------------ state
    def clear_state(self):
        B, C = self.dims.B, self.C
        if self._marg_future is not None:
            self._marg_future.cancel()
            self._marg_future = None
            self._marg_job_extra = None
        # an in-flight async solve is dropped the same way: never collected
        self._solve_pending = None
        self.ready_poses: List[tuple] = []
        self.Ps = np.zeros((B, 3))
        self.Qs = np.tile(np.array([1.0, 0, 0, 0]), (B, 1))
        self.Vs = np.zeros((B, 3))
        self.Bas = np.zeros((B, 3))
        self.Bgs = np.zeros((B, 3))
        self.Headers = np.zeros(B)
        self.tic = np.asarray(self.cfg.tic_np)
        ric = self._calib_ric if self._calib_ric is not None else self.cfg.ric_np
        self.qic = hm.mat_to_quat_np(np.asarray(ric))

        self.imu_dt = np.zeros((B, C))
        self.imu_acc = np.zeros((B, C, 3))
        self.imu_gyr = np.zeros((B, C, 3))
        self.imu_acc0 = np.zeros((B, 3))
        self.imu_gyr0 = np.zeros((B, 3))
        self.imu_cnt = np.zeros(B, dtype=np.int32)
        self.imu_overflow = np.zeros(B, dtype=bool)

        self.frame_count = 0
        self.first_imu = True
        self.acc_0 = np.zeros(3)
        self.gyr_0 = np.zeros(3)
        self.solver_flag = INITIAL
        self.marginalization_flag = MARGIN_OLD
        self.initial_timestamp = -1e18
        self.priors: Optional[PriorState] = None
        self.failure_count = 0

        self.pose_graph_packets: List[PoseGraphPacket] = []
        self.keyframe_points: List[KeyframePoints] = []
        self.last_kld = {}
        self.f_manager = self._new_feature_manager()

    # ------------------------------------------------------------------- IMU
    def process_imu(self, dt: float, acc: np.ndarray, gyr: np.ndarray):
        """estimator.cpp:91–124: buffer the sample into the current frame
        segment and propagate the newest state as initial guess."""
        if self._solve_pending is not None:
            raise RuntimeError("collect_solve() before the next frame's IMU feed: the pending "
                               "solve's state would overwrite this propagation")
        acc = np.asarray(acc)
        gyr = np.asarray(gyr)
        if self.first_imu:
            self.first_imu = False
            self.acc_0 = acc
            self.gyr_0 = gyr
            j = self.frame_count
            self.imu_acc0[j] = acc
            self.imu_gyr0[j] = gyr

        j = self.frame_count
        if j != 0:
            if self.imu_cnt[j] == 0:
                self.imu_acc0[j] = self.acc_0
                self.imu_gyr0[j] = self.gyr_0
            k = self.imu_cnt[j]
            if k < self.C:
                self.imu_dt[j, k] = dt
                self.imu_acc[j, k] = acc
                self.imu_gyr[j, k] = gyr
                self.imu_cnt[j] += 1
            else:
                if not self.imu_overflow[j]:
                    _log.warning("IMU segment %d overflowed capacity C=%d; the segment "
                                 "is excluded from the IMU factor", j, self.C)
                self.imu_overflow[j] = True

            R = hm.quat_to_mat_np(self.Qs[j])
            un_acc_0 = R @ (self.acc_0 - self.Bas[j]) - self.G
            un_gyr = 0.5 * (self.gyr_0 + gyr) - self.Bgs[j]
            dq = np.concatenate([[1.0], un_gyr * dt * 0.5])
            q_new = hm.quat_normalize_np(hm.quat_mul_np(self.Qs[j], dq))
            self.Qs[j] = q_new
            R1 = hm.quat_to_mat_np(q_new)
            un_acc_1 = R1 @ (acc - self.Bas[j]) - self.G
            un_acc = 0.5 * (un_acc_0 + un_acc_1)
            self.Ps[j] += dt * self.Vs[j] + 0.5 * dt * dt * un_acc
            self.Vs[j] += dt * un_acc
        self.acc_0 = acc
        self.gyr_0 = gyr

    def _segment_delta_q(self, j: int) -> np.ndarray:
        """Gyro-only midpoint preintegrated rotation of frame segment j at
        the current bias estimate (pre_integrations[frame_count]->delta_q),
        host numpy: the segment is at most C samples."""
        q = np.array([1.0, 0.0, 0.0, 0.0])
        g_prev = self.imu_gyr0[j]
        bg = self.Bgs[j]
        for k in range(int(self.imu_cnt[j])):
            dt = self.imu_dt[j, k]
            g = self.imu_gyr[j, k]
            dq = np.concatenate([[1.0], 0.5 * ((0.5 * (g_prev + g) - bg) * dt)])
            q = hm.quat_mul_np(q, dq)
            q /= np.linalg.norm(q)
            g_prev = g
        return q

    # ------------------------------------------------------------------ image
    def process_image(self, feat_ids, pts, t: float, vels=None) -> dict:
        """One frame step (estimator.cpp:126–211). Returns diagnostics."""
        keyframe = self.f_manager.add_features(self.frame_count, feat_ids, pts, vels)
        self.marginalization_flag = MARGIN_OLD if keyframe else MARGIN_NEW
        self.Headers[self.frame_count] = t
        info = {"keyframe": keyframe, "solved": False}

        # online extrinsic rotation calibration (estimator.cpp:139-153): feed
        # consecutive-frame correspondences + the gyro-preintegrated rotation
        # to the hand-eye calibrator; on confidence, install ric and drop to
        # refinement mode (the solver's extrinsic block takes over)
        if self.estimate_extrinsic == 2 and self.frame_count != 0:
            ci, cj = self.f_manager.get_corresponding(self.frame_count - 1, self.frame_count)
            if len(ci) >= 9:
                ric = self.ex_calibrator.push(ci[:, :2], cj[:, :2],
                                              self._segment_delta_q(self.frame_count))
                if ric is not None:
                    self._calib_ric = ric
                    self.qic = hm.mat_to_quat_np(np.asarray(ric))
                    self.estimate_extrinsic = 1
                    info["extrinsic_calibrated"] = True

        B = self.dims.B
        if self.solver_flag == INITIAL:
            if self.frame_count == B - 1:
                # init only once the extrinsic is at least coarsely known, with
                # a 0.1 s retry throttle (estimator.cpp:160-165)
                ok = False
                if self.estimate_extrinsic != 2 and (t - self.initial_timestamp) > 0.1:
                    ok = self.initial_structure()
                    self.initial_timestamp = t
                info["init"] = ok
                if ok:
                    self.solver_flag = NON_LINEAR
                    self._init_converged = True
                    self.solve_odometry(first=True)
                    if not self._init_converged:
                        info["init"] = False
                        self.clear_state()
                        return info
                    self.slide_window()
                    self.f_manager.remove_failures()
                    info["solved"] = True
                    j = self.dims.B - 1
                    self.ready_poses.append(
                        (float(self.Headers[j]), self.Ps[j].copy(), self.Qs[j].copy()))
                else:
                    self.slide_window()
            else:
                self.frame_count += 1
        elif self.solve_async:
            # cross-frame solve pipeline: dispatch now, install at the next
            # frame's collect_solve() (before its IMU feed)
            self.dispatch_odometry()
            info["solved"] = True
        else:
            self.solve_odometry()
            if self.failure_detection():
                info["failure"] = True
                self.clear_state()
                return info
            self._finish_frame()
            info["solved"] = True
        return info

    def _finish_frame(self):
        """Slide the window after a steady solve and publish its newest pose."""
        self.slide_window()
        self.f_manager.remove_failures()
        j = self.dims.B - 1
        self.ready_poses.append((float(self.Headers[j]), self.Ps[j].copy(), self.Qs[j].copy()))

    # ----------------------------------------------------------- initialization
    def initial_structure(self) -> bool:
        from .initialization import initial_structure

        return initial_structure(self)

    def set_ground_truth_init(self, P, Q, V, Ba=None, Bg=None):
        """Test/bench hook: bypass SfM initialization with known states."""
        B = self.dims.B
        self.Ps[:] = P[:B]
        self.Qs[:] = Q[:B]
        self.Vs[:] = V[:B]
        if Ba is not None:
            self.Bas[:] = Ba
        if Bg is not None:
            self.Bgs[:] = Bg

    # ------------------------------------------------------------------ solve
    def _window_state(self) -> WindowState:
        """Window state as a host numpy tree (f64)."""
        return WindowState(
            P=np.asarray(self.Ps), Q=np.asarray(self.Qs), V=np.asarray(self.Vs),
            Ba=np.asarray(self.Bas), Bg=np.asarray(self.Bgs),
            tic=np.asarray(self.tic), qic=np.asarray(self.qic),
            dep=self.f_manager.depth_vector(),
        )

    def _integrate(self, dts, accs, gyrs, acc0, gyr0, ba, bg, device=None):
        """f64 preintegration of host buffers on `device` (the estimator's)."""
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                      device=device or self.device)
        return integrate_segment(t(dts), t(accs), t(gyrs), t(acc0), t(gyr0), t(ba), t(bg),
                                 self.noise)

    def _imu_valid(self):
        sum_dt = self.imu_dt[1:].sum(axis=1)
        return (self.imu_cnt[1:] > 0) & (sum_dt < 10.0) & ~self.imu_overflow[1:]

    def _imu_factors(self) -> ImuFactors:
        """Integrate every frame segment at the current bias estimates (f64,
        on the device)."""
        pre = self._integrate(self.imu_dt[1:], self.imu_acc[1:], self.imu_gyr[1:],
                              self.imu_acc0[1:], self.imu_gyr0[1:],
                              self.Bas[:-1], self.Bgs[:-1])
        valid = torch.as_tensor(self._imu_valid(), device=self.device)
        return ImuFactors.create(pre=pre, valid=valid)

    def _proj_factors(self, marg_old: bool):
        pf = self.f_manager.build_proj_factors(self.dims.N, marg_old=marg_old)
        proj = ProjFactors(
            idx_i=np.asarray(pf["idx_i"], np.int32), idx_j=np.asarray(pf["idx_j"], np.int32),
            fidx=np.asarray(pf["fidx"], np.int32), pts_i=np.asarray(pf["pts_i"]),
            pts_j=np.asarray(pf["pts_j"]), valid=np.asarray(pf["valid"]),
        )
        return pf, proj

    def _solve_once(self, priors: PriorState, iters: int, dtype=None):
        """One triangulate + window solve + gauge re-anchor pass. `dtype`
        None is the f64 solve (init BA); torch.float32 is the steady path.
        Returns the projection-factor dict (reused by marginalization)."""
        if dtype is None:
            with perf.phase("est.triangulate"):
                self.f_manager.triangulate(self.Ps, self.Qs, self.tic, self.qic)
        return self._solve_once_inner(priors, iters, dtype)

    def _solve_once_inner(self, priors: PriorState, iters: int, dtype):
        dev = self.device
        with perf.phase("est.build_proj"):
            pf, proj = self._proj_factors(self.marginalization_flag == MARGIN_OLD)
        state = self._window_state()
        old_P = self.Ps.copy()
        old_Q = self.Qs.copy()
        psi = np.asarray(self.cfg.noise.pixel_sqrt_info)
        ee = bool(self.estimate_extrinsic)
        if dtype is not None:
            # steady path: the frame's inputs move once, the raw IMU buffers
            # preintegrate and the fresh depths seed inside steady_solve
            with perf.phase("est.upload"):
                st, im_raw, tri, pr, pri, g, ps = to_device(
                    (state, self._raw_imu_factors(), self._tri_inputs(), proj, priors,
                     self.G, psi), dev, dtype)
            with perf.phase("est.solve_device"):
                info = {}
                new_state, cost = steady_solve(
                    st, im_raw, tri, pr, pri, g, ps, self.dims, iters, ee, self.noise,
                    float(self.cfg.solver.max_depth), info)
                new_state, cost = to_numpy_tree(new_state), float(cost)
                self._count_iterations(int(info["iterations"]))
        else:
            imu_f = self._imu_factors()
            st, pr, pri, g, ps = from_numpy_tree(
                (state, proj, priors, self.G, psi), dev, torch.float64)
            new_state, cost = solve_window(st, imu_f, pr, pri, g, ps, self.dims,
                                           iters=iters, estimate_extrinsic=ee)
            new_state, cost = to_numpy_tree(new_state), float(cost)

        self._install_solution(new_state, cost, old_P[0], old_Q[0])
        return pf

    def _count_iterations(self, taken: int):
        self.steady_solves += 1
        self.lm_iterations_taken += taken

    def _install_solution(self, new_state: WindowState, cost: float, P0_old, Q0_old):
        """Re-anchor a solved window (host numpy tree) and make it the state."""
        new_state = self._reanchor(new_state, P0_old, Q0_old)
        self.Ps = np.array(new_state.P, dtype=np.float64)
        self.Qs = np.array(new_state.Q, dtype=np.float64)
        self.Vs = np.array(new_state.V, dtype=np.float64)
        self.Bas = np.array(new_state.Ba, dtype=np.float64)
        self.Bgs = np.array(new_state.Bg, dtype=np.float64)
        if self.estimate_extrinsic:
            self.tic = np.array(new_state.tic, dtype=np.float64)
            self.qic = np.array(new_state.qic, dtype=np.float64)
        self.f_manager.set_depths(np.asarray(new_state.dep, dtype=np.float64))
        self.last_cost = cost

    def _tri_inputs(self):
        """Device-triangulation side inputs: per-track observations + the
        rows needing a fresh depth seed (good, untriangulated, not
        outlier-flagged)."""
        fm = self.f_manager
        need = fm.good_mask() & (fm.depth <= 0) & ~fm.outlier
        return (fm.obs, fm.has_obs, fm.start.astype(np.int32), need)

    def _raw_imu_factors(self):
        """Raw per-segment IMU buffers + host validity for the on-device
        preintegration of the steady path."""
        return (self.imu_dt[1:], self.imu_acc[1:], self.imu_gyr[1:],
                self.imu_acc0[1:], self.imu_gyr0[1:], self._imu_valid())

    def _init_scale_scan(self, iters: int = 8):
        """Parallel-hypothesis global-scale search (init only; see the JAX
        reference for the rationale). The projection cost is invariant to
        scaling (P about P0, V, depths), so the window cost along the scale
        axis is pure IMU information: solve at 9 log-spaced scales, adopt
        the deepest basin. The 9 f64 solves run one after another.
        Returns (best_scale, costs, scales)."""
        dev = self.device
        self.f_manager.triangulate(self.Ps, self.Qs, self.tic, self.qic)
        imu_f = self._imu_factors()
        _, proj = self._proj_factors(False)
        state, pr, priors, g, ps = from_numpy_tree(
            (self._window_state(), proj, PriorState.empty(self.dims.Vo), self.G,
             np.asarray(self.cfg.noise.pixel_sqrt_info)), dev, torch.float64)
        scales = np.array([0.25, 0.4, 0.6, 0.8, 1.0, 1.3, 1.8, 2.6, 4.0])
        sts, costs = [], []
        for s in scales:
            st = state._replace(P=(state.P - state.P[0]) * s + state.P[0],
                                V=state.V * s, dep=state.dep / s)
            st, c = solve_window(st, imu_f, pr, priors, g, ps, self.dims, iters=iters)
            sts.append(st)
            costs.append(float(c))
        costs = np.asarray(costs)
        best = int(np.nanargmin(costs))
        best_state = self._reanchor(to_numpy_tree(sts[best]), self.Ps[0], self.Qs[0])
        self.Ps = np.array(best_state.P, dtype=np.float64)
        self.Qs = np.array(best_state.Q, dtype=np.float64)
        self.Vs = np.array(best_state.V, dtype=np.float64)
        self.Bas = np.array(best_state.Ba, dtype=np.float64)
        self.Bgs = np.array(best_state.Bg, dtype=np.float64)
        self.f_manager.set_depths(np.asarray(best_state.dep, dtype=np.float64))
        return float(scales[best]), costs, scales

    def solve_odometry(self, first: bool = False):
        """triangulate + solve + prior drag + marg (estimator.cpp:461–472,
        1541–1562). After initialization (first=True) this runs both passes,
        like the reference's backendOptimization: full-window BA (alternated
        with gyro-bias refinement and closed-form re-alignment to
        convergence, then the scale scan and its observability gate) +
        init_sparsify, then the prior-constrained solve + marg."""
        self.collect_marg()
        G = np.asarray(self.G)
        psi = np.asarray(self.cfg.noise.pixel_sqrt_info)

        if first:
            from .vi_init import realign_window, refine_gyro_bias

            Vo = self.dims.Vo
            iters = self.cfg.solver.init_max_iterations
            self._solve_once(PriorState.empty(Vo), iters)
            status = {}
            for _ in range(6):
                dbg_norm = refine_gyro_bias(self)
                moved = realign_window(self, status)
                if not moved and dbg_norm < 2e-3:
                    break
                self._solve_once(PriorState.empty(Vo), iters)
            s_best, costs, scales = self._init_scale_scan()
            if s_best in (scales[0], scales[-1]):
                s2, costs, scales = self._init_scale_scan()
                s_best *= s2
            finite = np.isfinite(costs)
            if not finite.any():
                self._init_converged = False
            else:
                c_best = float(np.nanmin(costs))
                c_max = float(np.nanmax(costs[finite]))
                self._init_converged = c_max > 1.3 * max(c_best, 1e-9)
            _log.info("init scale scan: best s=%.2f costs=%s converged=%s",
                      s_best, np.array2string(costs, precision=1), self._init_converged)
            if not self._init_converged:
                _log.warning("init scale unobservable (scan costs %s); rejecting "
                             "initialization", np.array2string(costs, precision=1))
                return
            self._solve_once(PriorState.empty(Vo), iters)
            pre_vo = self._imu_factors().pre
            pre_vo = type(pre_vo)(*(a[: Vo - 1] for a in pre_vo))
            st, g = from_numpy_tree((self._window_state(), G), self.device, torch.float64)
            priors, kld = init_sparsify(st, pre_vo, g, Vo=Vo, alpha=self.cfg.solver.alpha)
            self.priors = to_numpy_tree(priors)
            self.last_kld["init"] = float(kld)

        old_P, old_Q, old_V = self.Ps.copy(), self.Qs.copy(), self.Vs.copy()
        old_Ba, old_Bg = self.Bas.copy(), self.Bgs.copy()
        sdt = torch.float32 if self.cfg.solver.solve_dtype == "float32" else None
        pf = self._solve_once(self.priors, self.cfg.solver.max_iterations, dtype=sdt)

        self._after_solve(pf, (old_P, old_Q, old_V, old_Ba, old_Bg), G, psi,
                          asynchronous=not first)

    def _after_solve(self, pf, old, G, psi, asynchronous: bool):
        """Outlier cull, prior drag and marginalization at the solved state."""
        with perf.phase("est.mark_outliers"):
            self.f_manager.mark_outliers(
                self.Ps, self.Qs, self.tic, self.qic,
                focal=float(self.cfg.camera.fx),
                thresh_px=self.cfg.solver.outlier_reproj_px,
            )
        with perf.phase("est.drag_priors"):
            self._drag_priors(*old)
        if self.marginalization_flag == MARGIN_OLD:
            with perf.phase("est.marginalize"):
                # async in steady state (collected at the next solve); the
                # first post-init marg stays inline
                self._marginalize(pf, G, psi, asynchronous=asynchronous)

    # ---------------------------------------------- cross-frame solve pipeline
    def _steady_key(self):
        """What two pending solves must share to run as one batch."""
        return (tuple(self.dims), int(self.cfg.solver.max_iterations),
                bool(self.estimate_extrinsic), tuple(float(x) for x in self.noise),
                float(self.cfg.solver.max_depth))

    def _dispatch_steady(self, args, device=None) -> PendingSolve:
        return dispatch_steady(args, device or self.device, self.dims,
                               self.cfg.solver.max_iterations, bool(self.estimate_extrinsic),
                               self.noise, float(self.cfg.solver.max_depth))

    def dispatch_odometry(self):
        """Async steady-state odometry (solve_async mode): build the factors
        and DISPATCH the device solve without waiting for it. collect_solve()
        installs the result before the next frame's IMU feed. With
        `_defer_dispatch` set the prepared host arguments are left for the
        multi-sequence coordinator's one batched solve."""
        if self._solve_pending is not None:
            raise RuntimeError("collect_solve() first: one solve in flight at a time")
        if self.cfg.solver.solve_dtype != "float32":
            raise ValueError("solve_async requires the f32 steady path")
        G = np.asarray(self.G)
        psi = np.asarray(self.cfg.noise.pixel_sqrt_info)
        # depth seeding happens on the device inside steady_solve
        with perf.phase("est.build_proj"):
            pf, proj = self._proj_factors(self.marginalization_flag == MARGIN_OLD)
        # the previous frame's marg must land before its priors are read
        self.collect_marg()
        old = (self.Ps.copy(), self.Qs.copy(), self.Vs.copy(), self.Bas.copy(), self.Bgs.copy())
        # copies: the estimator's buffers change in place while the solve waits
        args = tree_map(np.array, (self._window_state(), self._raw_imu_factors(),
                                   self._tri_inputs(), proj, self.priors, G, psi))
        handle = None
        if not self._defer_dispatch:
            with perf.phase("est.solve_dispatch"):
                handle = self._dispatch_steady(args)
        self._solve_pending = {
            "handle": handle, "args": args, "key": self._steady_key(),
            "old": old, "pf": pf, "G": G, "psi": psi,
            "marg_flag": self.marginalization_flag,
        }

    def collect_solve(self):
        """Install a pending async solve: reanchor, state install, outlier
        cull, prior drag, async marg submit, failure check, window slide.
        No-op when nothing is pending."""
        if self._solve_pending is None:
            return
        p, self._solve_pending = self._solve_pending, None
        if p["handle"] is None:
            # deferred dispatch that no coordinator picked up: run it now
            p["handle"] = self._dispatch_steady(p["args"])
        with perf.phase("est.solve_collect"):
            new_state, cost = p["handle"].collect()
        self._count_iterations(int(p["handle"].iterations))
        old = p["old"]
        self._install_solution(new_state, float(cost), old[0][0], old[1][0])
        self.marginalization_flag = p["marg_flag"]
        self._after_solve(p["pf"], old, p["G"], p["psi"], asynchronous=True)
        if self.failure_detection():
            self.clear_state()
            return
        self._finish_frame()

    def _reanchor(self, st: WindowState, P0_old, Q0_old) -> WindowState:
        """Rotate/translate the solution so frame-0 yaw and position match
        their pre-solve values (double2vector, estimator.cpp:518–560)."""
        Q_np = np.asarray(st.Q, dtype=np.float64)
        P_np = np.asarray(st.P, dtype=np.float64)
        V_np = np.asarray(st.V, dtype=np.float64)
        ypr_old = hm.mat_to_ypr_np(hm.quat_to_mat_np(np.asarray(Q0_old)))
        ypr_new = hm.mat_to_ypr_np(hm.quat_to_mat_np(Q_np[0]))
        y_diff = ypr_old[0] - ypr_new[0]
        if abs(abs(ypr_old[1]) - 90) < 1.0 or abs(abs(ypr_new[1]) - 90) < 1.0:
            rot = hm.quat_to_mat_np(np.asarray(Q0_old)) @ hm.quat_to_mat_np(Q_np[0]).T
        else:
            rot = hm.ypr_to_mat_np([y_diff, 0.0, 0.0])
        rq = hm.mat_to_quat_np(rot)
        P = (P_np - P_np[0]) @ rot.T + np.asarray(P0_old)
        Q = np.stack([hm.quat_normalize_np(hm.quat_mul_np(rq, Q_np[k]))
                      for k in range(Q_np.shape[0])])
        V = V_np @ rot.T
        return st._replace(P=P, Q=Q, V=V)

    def _drag_priors(self, old_P, old_Q, old_V, old_Ba, old_Bg):
        """Exact drags of all pseudo-measurements to the new states (host
        numpy)."""
        pr = self.priors
        Vo = self.dims.Vo
        nP, nQ = self.Ps, self.Qs
        se3_t, se3_q = se3_prior_update_np(np.asarray(pr.se3_t), np.asarray(pr.se3_q),
                                           old_P[0], old_Q[0], nP[0], nQ[0])
        k = Vo - 1
        vb_old = np.concatenate([old_V[k], old_Ba[k], old_Bg[k]])
        vb_new_state = np.concatenate([self.Vs[k], self.Bas[k], self.Bgs[k]])
        vb_new = np.asarray(pr.vb) + (vb_new_state - vb_old)

        p_rel_dt, p_rel_dq = np.asarray(pr.rel_dt), np.asarray(pr.rel_dq)
        rel_dt, rel_dq = [], []
        for kk in range(Vo):
            i = kk - 1 if kk >= 1 else 0
            dt_k, dq_k = relpose_update_np(p_rel_dt[kk], p_rel_dq[kk],
                                           old_P[i], old_Q[i], old_P[kk], old_Q[kk],
                                           nP[i], nQ[i], nP[kk], nQ[kk])
            rel_dt.append(dt_k)
            rel_dq.append(dq_k)
        p_rp_q, p_rp_idx = np.asarray(pr.rp.q_meas), np.asarray(pr.rp.idx)
        rp_q = [rollpitch_update_np(p_rp_q[kk], old_Q[int(p_rp_idx[kk])], nQ[int(p_rp_idx[kk])])
                for kk in range(p_rp_idx.shape[0])]
        self.priors = pr._replace(
            se3_t=np.asarray(se3_t), se3_q=np.asarray(se3_q), vb=np.asarray(vb_new),
            rel_dt=np.stack(rel_dt), rel_dq=np.stack(rel_dq),
            rp=pr.rp._replace(q_meas=np.stack(rp_q)),
        )

    def _marginalize(self, pf: dict, G, psi, asynchronous: bool = False):
        """MargForward + MargBackward at the final state (:1554–1557).
        asynchronous=True runs the compute on the marg worker thread from a
        snapshot; collect_marg() installs it at the start of the next solve."""
        snap = self._marg_snapshot(pf, G, psi)
        with perf.phase("est.export_kf_points"):
            kfp = self._export_keyframe_points()
        if not asynchronous:
            self._install_marg(self._marg_compute(*snap), kfp)
            return
        if self._marg_exec is None:
            from concurrent.futures import ThreadPoolExecutor

            self._marg_exec = ThreadPoolExecutor(max_workers=1, thread_name_prefix="marg")
        if self._marg_future is not None:
            raise RuntimeError("one marg job in flight at a time")
        self._marg_job_extra = kfp
        self._marg_future = self._marg_exec.submit(self._marg_compute, *snap)

    def collect_marg(self):
        """Install a pending async marginalization, then apply the deferred
        prior slide."""
        if self._marg_future is None:
            return
        with perf.phase("est.marg_collect"):
            out = self._marg_future.result()
        self._marg_future = None
        kfp, self._marg_job_extra = self._marg_job_extra, None
        self._install_marg(out, kfp)
        self._slide_priors()

    def close(self):
        """Stop the marginalization worker (collecting any pending job)."""
        self.collect_marg()
        if self._marg_exec is not None:
            self._marg_exec.shutdown(wait=True)
            self._marg_exec = None

    def _marg_snapshot(self, pf: dict, G, psi):
        """Copy everything the marg computation reads (window state, priors,
        capped marg factor rows, segment-Vo IMU buffers)."""
        Vo = self.dims.Vo
        state = WindowState(
            P=self.Ps.copy(), Q=self.Qs.copy(), V=self.Vs.copy(),
            Ba=self.Bas.copy(), Bg=self.Bgs.copy(), tic=self.tic.copy(), qic=self.qic.copy(),
            dep=np.array(self.f_manager.depth_vector()),
        )
        pr = to_numpy_tree(self.priors)
        pr = type(pr)(*(np.array(a) if not isinstance(a, tuple) else
                        type(a)(*(np.array(x) for x in a)) for a in pr))
        L = 192
        mp_i = np.tile([[0, 0, 1.0]], (L, 1))
        mp_j = np.tile([[0, 0, 1.0]], (L, 1))
        mf = np.zeros(L, np.int32)
        mv = np.zeros(L, bool)
        n_all = len(pf["marg_fidx"])
        if n_all > L:
            # keep the top-L most informative factors by image-plane parallax
            score = np.linalg.norm(np.asarray(pf["marg_pts_i"])[:, :2]
                                   - np.asarray(pf["marg_pts_j"])[:, :2], axis=1)
            keep = np.argsort(-score)[:L]
            keep.sort()
            _log.warning("marg_forward factor cap: %d observations > L=%d; keeping the "
                         "top-%d by parallax (min kept score %.4f)",
                         n_all, L, L, float(score[keep].min()))
        else:
            keep = np.arange(n_all)
        n = len(keep)
        mp_i[:n] = pf["marg_pts_i"][keep]
        mp_j[:n] = pf["marg_pts_j"][keep]
        mf[:n] = pf["marg_fidx"][keep]
        mv[:n] = True
        imu_seg = (self.imu_dt[Vo].copy(), self.imu_acc[Vo].copy(), self.imu_gyr[Vo].copy(),
                   self.imu_acc0[Vo].copy(), self.imu_gyr0[Vo].copy(),
                   self.Bas[Vo - 1].copy(), self.Bgs[Vo - 1].copy())
        return (state, pr, mp_i, mp_j, mf, mv, np.asarray(psi),
                float(self.Headers[0]), imu_seg, np.asarray(G))

    def _marg_compute(self, state, pr, mp_i, mp_j, mf, mv, psi, header0, imu_seg, G,
                      device="cpu"):
        """Pure compute half (marg worker thread or inline), f64 on `device`
        (the host CPU unless asked): no estimator state is read or written."""
        Vo = self.dims.Vo
        st, pri, mpi, mpj, mfi, mva, g = from_numpy_tree(
            (state, pr, mp_i, mp_j, mf, mv, G), device, torch.float64)
        with perf.phase("est.marg_forward"):
            fwd = to_numpy_tree(marg_forward(st, pri, mpi, mpj, mfi, mva, float(psi),
                                             self.cfg.solver.alpha, header0))
        with perf.phase("est.marg_backward"):
            pre_ij = self._integrate(*imu_seg, device=device)
            back = to_numpy_tree(marg_backward(st, pre_ij, pri, g, Vo=Vo,
                                               alpha=self.cfg.solver.alpha))
        return fwd, back

    def _install_marg(self, out, kfp):
        (t1, q1, sq1, packet, kld_f), back = out
        (rel_dt, rel_dq, rel_sqrt, vb_m, vb_sqrt, rp_q, rp_sqrt, kld_b) = back
        self.pose_graph_packets.append(packet)
        self.keyframe_points.append(kfp)
        self.last_kld["forward"] = float(kld_f)
        self.last_kld["backward"] = float(kld_b)
        self._pending_se3 = (t1, q1, sq1)
        self._pending_backward = (rel_dt, rel_dq, rel_sqrt, vb_m, vb_sqrt, rp_q, rp_sqrt)

    def _export_keyframe_points(self) -> KeyframePoints:
        """World points of every solved landmark + their frame-0 normalized
        projections for the pose graph keyframe (System.cpp:356–397, widened
        as in the JAX reference)."""
        fm = self.f_manager
        good = fm.good_mask() & (fm.depth > 0)
        rows = np.where(good)[0]
        if len(rows) == 0:
            return KeyframePoints(self.Headers[0], np.zeros((0, 3)), np.zeros((0, 2)),
                                  np.zeros(0))
        hosts = fm.start[rows]
        pts_i = fm.obs[rows, hosts]
        depths = fm.depth[rows]
        R = np.stack([hm.quat_to_mat_np(self.Qs[k]) for k in range(self.dims.B)])
        Ric = hm.quat_to_mat_np(self.qic)
        pc = pts_i * depths[:, None]
        pb = pc @ Ric.T + self.tic
        pw = np.einsum("nij,nj->ni", R[hosts], pb) + self.Ps[hosts]
        Rc0 = R[0] @ Ric
        Pc0 = self.Ps[0] + R[0] @ self.tic
        p0 = (pw - Pc0) @ Rc0
        vis = p0[:, 2] > 0.1
        norm0 = p0[vis, :2] / p0[vis, 2:3]
        return KeyframePoints(self.Headers[0], pw[vis], norm0, fm.ids[rows[vis]].copy())

    # ------------------------------------------------------------- failure
    def failure_detection(self) -> bool:
        """estimator.cpp:596–665 (only the bias-norm checks are live)."""
        B1 = self.dims.B - 1
        if np.linalg.norm(self.Bas[B1]) > self.cfg.solver.bias_acc_threshold:
            self.failure_count += 1
            return True
        if np.linalg.norm(self.Bgs[B1]) > self.cfg.solver.bias_gyr_threshold:
            self.failure_count += 1
            return True
        return False

    # -------------------------------------------------------------- sliding
    def slide_window(self):
        B = self.dims.B
        if self.marginalization_flag == MARGIN_OLD:
            back_R0 = hm.quat_to_mat_np(self.Qs[0])
            back_P0 = self.Ps[0].copy()
            if self.frame_count == B - 1:
                for arr in (self.Ps, self.Qs, self.Vs, self.Bas, self.Bgs, self.Headers):
                    arr[:-1] = arr[1:]
                for arr in (self.imu_dt, self.imu_acc, self.imu_gyr, self.imu_acc0,
                            self.imu_gyr0, self.imu_cnt, self.imu_overflow):
                    arr[:-1] = arr[1:]
                self.imu_cnt[B - 1] = 0
                self.imu_dt[B - 1] = 0
                self.imu_overflow[B - 1] = False
                self.imu_acc0[B - 1] = self.acc_0
                self.imu_gyr0[B - 1] = self.gyr_0

                if self.solver_flag == NON_LINEAR and self.priors is not None:
                    if self._marg_future is None:
                        self._slide_priors()
                    # else: collect_marg() applies the slide when it lands

                Ric = hm.quat_to_mat_np(self.qic)
                R0 = back_R0 @ Ric
                P0 = back_P0 + back_R0 @ self.tic
                new_R0 = hm.quat_to_mat_np(self.Qs[0])
                R1 = new_R0 @ Ric
                P1 = self.Ps[0] + new_R0 @ self.tic
                if self.solver_flag == NON_LINEAR:
                    self.f_manager.remove_back_shift_depth(R0, P0, R1, P1)
                else:
                    self.f_manager.remove_back()
        else:
            if self.frame_count == B - 1:
                j = self.frame_count
                n_prev = self.imu_cnt[j - 1]
                n_new = self.imu_cnt[j]
                take = min(n_new, self.C - n_prev)
                self.imu_dt[j - 1, n_prev: n_prev + take] = self.imu_dt[j, :take]
                self.imu_acc[j - 1, n_prev: n_prev + take] = self.imu_acc[j, :take]
                self.imu_gyr[j - 1, n_prev: n_prev + take] = self.imu_gyr[j, :take]
                self.imu_cnt[j - 1] += take
                if take < n_new or self.imu_overflow[j]:
                    if not self.imu_overflow[j - 1]:
                        _log.warning("IMU merge overflow at segment %d; the merged "
                                     "segment is excluded from the IMU factor", j - 1)
                    self.imu_overflow[j - 1] = True
                for arr in (self.Ps, self.Qs, self.Vs, self.Bas, self.Bgs, self.Headers):
                    arr[j - 1] = arr[j]
                self.imu_cnt[j] = 0
                self.imu_dt[j] = 0
                self.imu_overflow[j] = False
                self.imu_acc0[j] = self.acc_0
                self.imu_gyr0[j] = self.gyr_0
                self.f_manager.remove_front(self.frame_count)

    def _slide_priors(self):
        """Install pending marginalization outputs + shift edge indices
        (slideWindow, estimator.cpp:1605–1638)."""
        pr = self.priors
        Vo = self.dims.Vo
        rel_dt = np.asarray(pr.rel_dt).copy()
        rel_dq = np.asarray(pr.rel_dq).copy()
        rel_sqrt = np.asarray(pr.rel_sqrt).copy()
        rel_valid = np.asarray(pr.rel_valid).copy()
        rel_dt[1: Vo - 1] = rel_dt[2:Vo]
        rel_dq[1: Vo - 1] = rel_dq[2:Vo]
        rel_sqrt[1: Vo - 1] = rel_sqrt[2:Vo]
        rel_valid[1: Vo - 1] = rel_valid[2:Vo]

        b_dt, b_dq, b_sqrt, vb_m, vb_sqrt, rp_q, rp_sqrt = self._pending_backward
        rel_dt[Vo - 1] = np.asarray(b_dt)
        rel_dq[Vo - 1] = np.asarray(b_dq)
        rel_sqrt[Vo - 1] = np.asarray(b_sqrt)
        rel_valid[Vo - 1] = True

        rp_qs = list(np.asarray(pr.rp.q_meas))
        rp_sqs = list(np.asarray(pr.rp.sqrt_info))
        rp_idx = list(np.asarray(pr.rp.idx))
        rp_val = list(np.asarray(pr.rp.valid))
        slot = rp_val.index(False) if False in rp_val else int(np.argmin(rp_idx))
        rp_qs[slot] = np.asarray(rp_q)
        rp_sqs[slot] = np.asarray(rp_sqrt)
        rp_idx[slot] = Vo - 1
        rp_val[slot] = True
        new_idx = np.asarray(rp_idx) - 1
        new_val = np.asarray(rp_val) & (new_idx >= 0)

        t1, q1, sq1 = self._pending_se3
        self.priors = PriorState(
            se3_t=np.asarray(t1), se3_q=np.asarray(q1), se3_sqrt=np.asarray(sq1),
            se3_valid=np.asarray(True),
            vb=np.asarray(vb_m), vb_sqrt=np.asarray(vb_sqrt), vb_valid=np.asarray(True),
            rel_dt=rel_dt, rel_dq=rel_dq, rel_sqrt=rel_sqrt, rel_valid=rel_valid,
            rp=RollPitchFactors(q_meas=np.asarray(rp_qs), sqrt_info=np.asarray(rp_sqs),
                                idx=new_idx.astype(np.int32), valid=new_val),
        )

    # ------------------------------------------------------------- outputs
    def latest_pose(self):
        j = self.dims.B - 1
        return self.Headers[j], self.Ps[j].copy(), self.Qs[j].copy()
