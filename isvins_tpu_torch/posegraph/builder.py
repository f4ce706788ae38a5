"""Pose-graph builder orchestration (torch port of
isvins_tpu/posegraph/builder.py; reference PoseGraphBuilder thread,
KeyFrame construction and PoseGraph bookkeeping: pose_graph_builder.cpp,
keyframe.cpp, pose_graph.cpp).

Consumes the estimator's per-marginalization PoseGraphPacket, the keyframe
point exports and camera images; accumulates VIO edges with adjoint
covariance transport until the keyframe distance gate (pose_graph_factors.h
operator+, builder :157-216); on each keyframe runs one fused device step
(window-point projection, BRIEF, Shi-Tomasi/NMS detection, undistortion),
adds the keyframe to the database, retrieves candidates (kernel K6 until
the vocabulary freezes), verifies them (Hamming match, PnP-RANSAC, gates),
and dispatches the dense pose-graph optimization asynchronously when a
loop closes; the drift it returns is applied to the incoming stream.

Everything numeric runs on the builder's device; host bookkeeping is f64
numpy.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..factors.priors import relpose_update_anchor_np
from ..frontend.image_ops import nms_topk, shi_tomasi_response
from ..geom import hostmath as hm
from ..initial.pnp import pnp_ransac_gn
from ..utils import perf
from .brief import brief_descriptors, make_brief_pattern, match_descriptors_clean
from .keyframe_db import KeyframeDB
from .optimize import _optimize_core, optimize_pose_graph

_log = logging.getLogger(__name__)


@dataclass
class _Accum:
    dt: np.ndarray
    dq: np.ndarray
    cov: np.ndarray
    anchor_t: Optional[np.ndarray] = None
    anchor_q: Optional[np.ndarray] = None
    ts: float = 0.0
    rp_q: Optional[np.ndarray] = None
    rp_cov: Optional[np.ndarray] = None
    has_rp: bool = False
    kf_points: object = None
    image: Optional[np.ndarray] = None

    @staticmethod
    def identity():
        return _Accum(np.zeros(3), np.array([1.0, 0, 0, 0]), np.zeros((6, 6)))


def _desc_tensor(a: np.ndarray, device):
    """uint32 descriptor words (host) -> int32 tensor with the same bits."""
    return torch.as_tensor(np.ascontiguousarray(a).view(np.int32), device=device)


class PoseGraphBuilder:
    def __init__(self, cfg, camera=None, device=None):
        """`camera`: the camera model (frontend.camera.make_camera) that maps
        normalized points to pixels; None treats the exported points as
        pixel coordinates. `device`: where the keyframe step, retrieval,
        verification and optimization run (None: the CUDA card; the CPU
        only on `device="cpu"`)."""
        pg = cfg.posegraph
        self.cfg = cfg
        self.pg = pg
        self.device = resolve_device(device)
        self.db = KeyframeDB(pg.max_keyframes, pg.max_kp_per_kf, 256, device=self.device)
        self.pattern = make_brief_pattern(pg.brief_bits)
        self.camera = camera
        self.accum = _Accum.identity()
        self.last_kf: Optional[int] = None
        self.earliest_loop = -1
        self.r_drift = np.eye(3)
        self.t_drift = np.zeros(3)
        self.n_loops = 0
        self._pending_opt = None  # in-flight async optimization
        self._opt_dirty = None  # newest loop idx that fired while in flight
        self._opt_align_epoch = 0
        # async solves dispatched, collected, and collected with finite
        # poses (finalize() discards a diverged solve)
        self.n_async_dispatches = 0
        self.n_async_collects = 0
        self.n_async_landed = 0

        # multi-sequence state (pose_graph_builder.h:70, pose_graph.cpp:33-48,
        # 84-105): live sequences start at 1 (0 is reserved for a loaded
        # map); each sequence's VIO poses are shifted into the common world
        # by (w_r_vio, w_t_vio), identity until its first inter-sequence loop
        self.sequence = 1
        self.sequence_loop = {0: True, 1: False}
        self.w_r_vio = np.eye(3)
        self.w_t_vio = np.zeros(3)
        self._db_seq_cnt = 1  # sequence of the last added keyframe
        self.n_sequence_aligns = 0

    def prewarm(self):
        """Run the builder's device work once before streaming (System runs
        it first on its pose-graph worker): the kernel library's build, the
        keyframe step on a zero image, the descriptor matcher, PnP at 16,
        64, 128 and 256 points, and an optimization of 64 poses and 64
        loops (the reference's first capacity rung).
        On the card the first of each pays the CUDA libraries' start-up
        (cuBLAS, cuSOLVER), which would otherwise land mid-stream at the
        first keyframe or loop. Nothing here touches the database; a
        failure raises."""
        dev = self.device
        if dev.type == "cuda":
            from ..ops import _lib

            _lib.lib()
        P, D = self.db.P, self.db.D
        cc = self.cfg.camera
        self._kf_device_step(np.zeros((cc.height, cc.width), np.float32), np.zeros((P, 2)),
                             np.zeros(P, bool))
        words = lambda n: torch.zeros((n, 8), dtype=torch.int32, device=dev)
        flags = lambda n: torch.zeros(n, dtype=torch.bool, device=dev)
        match_descriptors_clean(words(P), flags(P), words(D), flags(D),
                                ham_thresh=self.pg.hamming_thresh)
        rng = np.random.default_rng(0)
        q0 = np.array([1.0, 0.0, 0.0, 0.0])
        for n in (16, 64, 128, 256):
            if n > P:
                break
            pnp_ransac_gn(rng.normal(size=(n, 3)) + np.array([0.0, 0.0, 5.0]),
                          rng.normal(size=(n, 2)) * 0.1, q0, np.zeros(3),
                          thresh=self.pg.pnp_inlier_thresh, device=dev)
        K = L = 64
        sdtype = torch.float64 if dev.type == "cpu" else torch.float32
        z = lambda *s: torch.zeros(s, dtype=sdtype, device=dev)
        qs = lambda n: torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=sdtype, device=dev).repeat(n, 1)
        idx = torch.zeros(L, dtype=torch.int64, device=dev)
        _optimize_core(z(K, 3), qs(K), z(K, 3), qs(K), z(K, 6, 6), flags(K),
                       qs(K), z(K, 2, 2), flags(K),
                       idx, idx, z(L, 3), qs(L), z(L), flags(L), flags(K), iters=10)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

    def new_sequence(self):
        """Stream discontinuity: start a new pose-graph sequence
        (pose_graph_builder.cpp:3-19); the partially accumulated edge is
        discarded."""
        self.sequence += 1
        self.sequence_loop[self.sequence] = False
        self.accum = _Accum.identity()
        _log.info("pose graph: new sequence %d", self.sequence)

    # ----------------------------------------------------------- accumulate
    def push(self, packet, kf_points, image=None) -> Optional[int]:
        """Feed one marginalization packet (+ the keyframe's exported points
        and grayscale image). Returns the new keyframe index if the distance
        gate fired, else None."""
        a = self.accum
        # T = T0 * T1; cov += Adj(T0) cov1 Adj(T0)^T (pose_graph_factors.h:27-51)
        Adj0 = hm.se3_adjoint_np(a.dt, a.dq)
        a.cov = a.cov + Adj0 @ np.asarray(packet.cov_rel) @ Adj0.T
        a.dt = hm.quat_to_mat_np(a.dq) @ np.asarray(packet.rel_dt) + a.dt
        a.dq = hm.quat_normalize_np(hm.quat_mul_np(a.dq, np.asarray(packet.rel_dq)))
        a.rp_q = np.asarray(packet.rp_q)
        a.rp_cov = np.asarray(packet.cov_abs)
        a.has_rp = bool(packet.has_rollpitch)
        if a.anchor_t is None:
            a.anchor_t = np.asarray(packet.anchor_t)
            a.anchor_q = np.asarray(packet.anchor_q)
            a.ts = float(packet.ts)
            a.kf_points = kf_points
            a.image = image
        if np.linalg.norm(a.dt) <= self.pg.keyframe_min_dist:
            return None
        return self._make_keyframe()

    # ------------------------------------------------------------- keyframe
    def _make_keyframe(self) -> int:
        # collect a finished in-flight optimization first: its drift must
        # land before this keyframe reads r_drift
        self._poll_optimize()
        a = self.accum
        db = self.db

        # first keyframe of a new sequence: reset the world alignment and
        # the drift (pose_graph.cpp:33-43)
        if self.sequence != self._db_seq_cnt:
            self._db_seq_cnt = self.sequence
            self.w_r_vio = np.eye(3)
            self.w_t_vio = np.zeros(3)
            self.r_drift = np.eye(3)
            self.t_drift = np.zeros(3)

        # shift the incoming VIO anchor into the common world (pose_graph.cpp:45-48)
        anchor_t = self.w_r_vio @ np.asarray(a.anchor_t) + self.w_t_vio
        anchor_q = hm.quat_normalize_np(
            hm.quat_mul_np(hm.mat_to_quat_np(self.w_r_vio), np.asarray(a.anchor_q)))

        # retro-update the previous keyframe's edge to the actual new anchor
        # (pose_graph_builder.cpp:192-199)
        if self.last_kf is not None:
            j = self.last_kf
            tj_pred = hm.quat_to_mat_np(db.vio_q[j]) @ db.edge_dt[j] + db.vio_t[j]
            qj_pred = hm.quat_normalize_np(hm.quat_mul_np(db.vio_q[j], db.edge_dq[j]))
            db.edge_dt[j], db.edge_dq[j] = relpose_update_anchor_np(
                db.edge_dt[j], db.edge_dq[j], db.vio_t[j], db.vio_q[j],
                tj_pred, qj_pred, anchor_t, anchor_q)

        # descriptors
        kf_pts = a.kf_points
        P = db.P
        win_desc = np.zeros((P, 8), np.uint32)
        win_valid = np.zeros(P, bool)
        win_pts3d = np.zeros((P, 3))
        kp_desc = np.zeros((db.D, 8), np.uint32)
        kp_norm = np.zeros((db.D, 2))
        kp_valid = np.zeros(db.D, bool)
        if a.image is not None:
            norm = np.zeros((P, 2))
            normv = np.zeros(P, bool)
            pts_w_pad = np.zeros((P, 3))
            if kf_pts is not None and len(kf_pts.points_w) > 0:
                m = len(kf_pts.points_w)
                if m > P:
                    _log.warning("keyframe window-point cap: %d points > P=%d; dropping %d",
                                 m, P, m - P)
                    m = P
                norm[:m] = kf_pts.pts_norm[:m]
                pts_w_pad[:m] = kf_pts.points_w[:m]
                normv[:m] = True
            with perf.phase("pg.kf_device_step"):
                px, inb, wd, cand, okc, kd, un = self._kf_device_step(a.image, norm, normv)

            rows = np.where(inb)[0]
            n_w = len(rows)
            win_desc[:n_w] = wd[rows]
            win_valid[:n_w] = True
            win_pts3d[:n_w] = pts_w_pad[rows]
            # window descriptors are also matchable (the reference adds both)
            kp_desc[:n_w] = wd[rows]
            kp_norm[:n_w] = norm[rows]
            kp_valid[:n_w] = True
            # extra detected keypoints over the full frame (keyframe.cpp:55-69)
            n_det = int(min(db.D - n_w, okc.sum()))
            kp_desc[n_w:n_w + n_det] = kd[:n_det]
            kp_valid[n_w:n_w + n_det] = True
            kp_norm[n_w:n_w + n_det] = un[:n_det]

        idx = db.add(
            ts=a.ts, seq=self.sequence, vio_t=anchor_t, vio_q=anchor_q,
            opt_t=self.r_drift @ anchor_t + self.t_drift,
            opt_q=hm.quat_normalize_np(hm.quat_mul_np(hm.mat_to_quat_np(self.r_drift), anchor_q)),
            rp_q=a.rp_q if a.has_rp else np.array([1.0, 0, 0, 0]),
            rp_sqrt=(np.linalg.cholesky(np.linalg.inv(a.rp_cov + 1e-12 * np.eye(2))).T
                     if a.has_rp else np.zeros((2, 2))),
            rp_valid=a.has_rp, win_pts3d=win_pts3d, win_desc=win_desc, win_valid=win_valid,
            kp_desc=kp_desc, kp_norm=kp_norm, kp_valid=kp_valid,
        )
        # the accumulated chain is the NEW keyframe's own outgoing edge,
        # dragged to the next keyframe's anchor when that one arrives
        # (pose_graph_builder.cpp:200-204)
        db.edge_dt[idx] = a.dt
        db.edge_dq[idx] = a.dq
        info = np.linalg.inv(a.cov + 1e-10 * np.eye(6))
        w, V = np.linalg.eigh(0.5 * (info + info.T))
        db.edge_sqrt[idx] = (V * np.sqrt(np.clip(w, 0.0, None))[None, :]) @ V.T
        db.edge_valid[idx] = True
        self.last_kf = idx

        # loop closure: geometric verification arbitrates among the
        # retrieval candidates, best first
        if self.pg.enabled:
            with perf.phase("pg.query"):
                cands = db.query(idx, self.pg.skip_recent, self.pg.top_k,
                                 match_thresh=self.pg.retrieval_match_thresh,
                                 abs_frac=self.pg.retrieval_abs_frac,
                                 bow_abs=self.pg.bow_abs_score)
            with perf.phase("pg.find_connection"):
                old = next((c for c in cands if self._find_connection(idx, c)), -1)
            if old >= 0:
                self.n_loops += 1
                # inter-sequence loop: align the current sequence's VIO frame
                # onto the old world, once per sequence (pose_graph.cpp:84-105)
                seq_cur = int(db.seq[idx])
                if int(db.seq[old]) != seq_cur and not self.sequence_loop.get(seq_cur, False):
                    self._align_sequence(idx, old)
                    self.sequence_loop[seq_cur] = True
                    self.n_sequence_aligns += 1
                if self.earliest_loop < 0 or db.loop_idx[idx] < self.earliest_loop:
                    self.earliest_loop = int(db.loop_idx[idx])
                self._request_optimize(idx)

        self.accum = _Accum.identity()
        return idx

    def _kf_device_step(self, image, norm, normv):
        """The per-keyframe device step: project the exported window points
        through the camera, gate to the image bounds, BRIEF at the
        projections, up to D Shi-Tomasi corners (NMS), BRIEF at the corners,
        undistort them. Projection and lifting run in f64 (the reference's
        camera constants are f64, so its jitted step projects in f64); the
        image work is f32. Returns host numpy arrays."""
        dev = self.device
        cc = self.cfg.camera
        img = torch.as_tensor(np.asarray(image, np.float32), device=dev)
        norm_t = torch.as_tensor(np.asarray(norm, np.float32), device=dev)
        inb = torch.as_tensor(np.asarray(normv, bool), device=dev)
        cam = self.camera
        if cam is not None:
            n64 = norm_t.to(torch.float64)
            px = cam.space_to_plane(torch.cat([n64, torch.ones_like(n64[:, :1])], dim=1))
            inb = (inb & (px[:, 0] >= 14) & (px[:, 0] <= cc.width - 15)
                   & (px[:, 1] >= 14) & (px[:, 1] <= cc.height - 15))
        else:
            px = norm_t  # tests may pass pixel coordinates directly
        wd = brief_descriptors(img, px, inb, self.pattern)
        # border >= the BRIEF patch half-size (14): a corner closer to an
        # edge would get a silently shifted patch
        cand, _, okc = nms_topk(shi_tomasi_response(img), self.db.D, 10, border=14)
        kd = brief_descriptors(img, cand, okc, self.pattern)
        un = cam.lift_projective(cand.to(torch.float64))[:, :2] if cam is not None else cand
        f32 = torch.float32
        fbuf = torch.cat([px.to(f32), inb[:, None].to(f32)], dim=1).cpu().numpy()
        fbuf2 = torch.cat([cand.to(f32), okc[:, None].to(f32), un.to(f32)], dim=1).cpu().numpy()
        desc = torch.cat([wd, kd]).cpu().numpy().view(np.uint32)
        P = len(norm)
        return (fbuf[:, :2], fbuf[:, 2] > 0.5, desc[:P], fbuf2[:, :2], fbuf2[:, 2] > 0.5,
                desc[P:], fbuf2[:, 3:5])

    # ---------------------------------------------- async loop optimization
    def _request_optimize(self, idx: int):
        """Optimize the active segment [earliest_loop..idx]: dispatched
        asynchronously and collected at the next keyframe when
        cfg.posegraph.async_optimize (pose_graph.cpp:425-426), else solved
        now."""
        if not self.pg.async_optimize:
            self.r_drift, self.t_drift, _ = optimize_pose_graph(
                self.db, self.earliest_loop, idx, dist_min_poses=self.pg.dist_min_poses,
                max_active=self.pg.max_active_poses)
            return
        if self._pending_opt is not None:
            # one solve in flight at a time; a newer loop asks for a re-run
            # with the larger range
            self._opt_dirty = max(self._opt_dirty or idx, idx)
            return
        with perf.phase("pg.opt_dispatch"):
            self._pending_opt = optimize_pose_graph(
                self.db, self.earliest_loop, idx, dist_min_poses=self.pg.dist_min_poses,
                max_active=self.pg.max_active_poses, async_dispatch=True)
        self.n_async_dispatches += 1
        self._opt_align_epoch = self.n_sequence_aligns

    def _poll_optimize(self):
        """Collect the in-flight optimization (at each new keyframe and from
        the output accessors): apply its poses, covariances, retro-updated
        edges and drift; re-dispatch when more loops fired meanwhile. A
        sequence alignment since the dispatch invalidates the solve's seed:
        it is discarded and re-dispatched."""
        if self._pending_opt is None:
            return
        pend = self._pending_opt
        self._pending_opt = None
        if self._opt_align_epoch == self.n_sequence_aligns:
            with perf.phase("pg.opt_finalize"):
                self.r_drift, self.t_drift, _ = pend.finalize()
            self.n_async_collects += 1
            self.n_async_landed += pend.landed
        redo = self._opt_dirty
        self._opt_dirty = None
        if redo is not None or self._opt_align_epoch != self.n_sequence_aligns:
            self._request_optimize(redo if redo is not None else pend.cur_idx)

    def flush_optimize(self):
        """End of stream: collect any in-flight optimization."""
        while self._pending_opt is not None:
            self._poll_optimize()

    # --------------------------------------------------------------- loops
    def _align_sequence(self, cur: int, old: int):
        """First loop between the current sequence and an earlier one: the
        world shift (w_r_vio, w_t_vio) that puts the current keyframe where
        the loop measurement says it is in the old world, applied to the
        current sequence's keyframes (pose_graph.cpp:84-105, with VINS-Mono
        upstream's same-sequence filter)."""
        db = self.db
        R_old = hm.quat_to_mat_np(db.vio_q[old])
        w_P_cur = R_old @ db.loop_dt[cur] + db.vio_t[old]
        w_R_cur = R_old @ hm.quat_to_mat_np(db.loop_dq[cur])
        shift_r = w_R_cur @ hm.quat_to_mat_np(db.vio_q[cur]).T
        shift_t = w_P_cur - shift_r @ db.vio_t[cur]
        self.w_r_vio = shift_r
        self.w_t_vio = shift_t
        q_shift = hm.mat_to_quat_np(shift_r)
        seq_cur = int(db.seq[cur])
        for k in range(db.n):
            if int(db.seq[k]) != seq_cur:
                continue
            db.vio_t[k] = shift_r @ db.vio_t[k] + shift_t
            db.vio_q[k] = hm.quat_normalize_np(hm.quat_mul_np(q_shift, db.vio_q[k]))
        _log.info("pose graph: sequence %d aligned onto sequence %d via loop %d->%d",
                  seq_cur, int(db.seq[old]), cur, old)

    def _find_connection(self, cur: int, old: int) -> bool:
        """keyframe.cpp findConnection (:232-282): Hamming match of cur's
        window descriptors against old's keypoints (ratio test and
        cross-check), initialization-free PnP-RANSAC, then the gates. On the
        builder's device; the PnP in f64."""
        db = self.db
        dev = self.device
        wv = db.win_valid[cur]
        if wv.sum() < self.pg.min_loop_matches:
            return False
        best, keep = match_descriptors_clean(
            _desc_tensor(db.win_desc[cur], dev), torch.as_tensor(wv, device=dev),
            _desc_tensor(db.kp_desc[old], dev), torch.as_tensor(db.kp_valid[old], device=dev),
            ham_thresh=self.pg.hamming_thresh)
        best = best.cpu().numpy()
        m = keep.cpu().numpy()
        if m.sum() <= self.pg.min_loop_matches:
            return False

        pts3d = db.win_pts3d[cur][m]
        pts2d_old = db.kp_norm[old][best[m]]
        # initial guess: cur keyframe's camera pose (keyframe.cpp:168-175)
        RIC = np.asarray(self.cfg.ric_np)
        TIC = np.asarray(self.cfg.tic_np)
        R_w_b = hm.quat_to_mat_np(db.vio_q[cur])
        R_w_c = R_w_b @ RIC
        T_w_c = db.vio_t[cur] + R_w_b @ TIC
        ok, q_cw, t_cw, inl = pnp_ransac_gn(
            pts3d, pts2d_old, hm.mat_to_quat_np(R_w_c.T), -R_w_c.T @ T_w_c,
            thresh=self.pg.pnp_inlier_thresh, device=dev)
        n_in = int(inl.sum())
        if not ok or n_in <= 0.6 * self.pg.min_loop_matches:
            return False

        # old body pose in cur's world
        R_cw = hm.quat_to_mat_np(q_cw)
        R_w_c_old = R_cw.T
        T_w_c_old = -R_w_c_old @ t_cw
        R_old = R_w_c_old @ RIC.T
        T_old = T_w_c_old - R_old @ TIC

        # loop weight (keyframe.cpp:211-227): (m-6)/res^2 over the inliers,
        # the residual divided by FOCAL_LENGTH=460 once more on top of the
        # normalized coordinates; floored at a quarter pixel per match and
        # capped at 1e9 (an f32 solve went non-finite above that)
        pc = (R_cw @ (pts3d[inl] - T_w_c_old).T).T
        pc = pc / pc[:, 2:3]
        res = np.linalg.norm(pc[:, :2] - pts2d_old[inl], axis=1).sum() / 460.0
        if n_in <= 6:
            return False
        res = max(res, n_in * 0.25 / (460.0 * 460.0))
        loop_weight = min((n_in - 6) / (res * res), 1e9)

        # relative pose cur-in-old + gates (keyframe.cpp:276-282)
        rel_t = R_old.T @ (db.vio_t[cur] - T_old)
        rel_R = R_old.T @ R_w_b
        rel_yaw = (hm.mat_to_ypr_np(R_w_b)[0] - hm.mat_to_ypr_np(R_old)[0] + 180.0) % 360.0 - 180.0
        if abs(rel_yaw) >= self.pg.max_yaw_deg or np.linalg.norm(rel_t) >= self.pg.max_dist:
            return False

        db.loop_idx[cur] = old
        db.loop_dt[cur] = rel_t
        db.loop_dq[cur] = hm.mat_to_quat_np(rel_R)
        db.loop_weight[cur] = loop_weight
        return True

    # --------------------------------------------------------------- output
    def trajectory(self):
        """(ts, t, q) arrays of the optimized keyframe poses
        (loop_pose_output.txt equivalent, pose_graph.cpp:412-423)."""
        self.flush_optimize()
        n = self.db.n
        return self.db.ts[:n].copy(), self.db.opt_t[:n].copy(), self.db.opt_q[:n].copy()

    def covariances(self):
        """(ts, opt_t, cov (n,6,6)): the per-keyframe 6x6 covariance blocks
        of the latest pose-graph solve (ceres::Covariance parity)."""
        self.flush_optimize()
        n = self.db.n
        return self.db.ts[:n].copy(), self.db.opt_t[:n].copy(), self.db.cov[:n].copy()
