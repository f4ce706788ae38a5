"""Feature/track manager: fixed-capacity structure-of-arrays replacement for
the reference's pointer-rich `list<IDFeatures>` (feature_manager.{h,cpp}).

Torch port of isvins_tpu/estimator/feature_manager.py. Host-side
bookkeeping is numpy (insertion/removal is inherently sequential); the f64
multi-view DLT triangulation is batched torch over all tracks at once, on
the estimator's device. Rows of the SoA double as the solver's landmark slots, so
`ProjFactors.fidx` indexes straight into `WindowState.dep`.

Semantics parity (file:line into the reference):
- keyframe decision by mean compensated parallax (addFeatureAndCheckParallax,
  feature_manager.cpp:54–101; threshold MIN_PARALLAX = keyframe_parallax/460)
- goodFeature = used_num >= 2 && start_frame < Vo_SIZE (:27–31)
- triangulation via masked SVD, depth clamped to [0.1, 8] else INIT_DEPTH
  (:206–258)
- depth re-anchoring on window slide (removeBackShiftDepth :275–313,
  removeBack :315, removeFront :334)
- solve_flag == 2 (failed depth) rows removed by remove_failures (:156–174)
"""

from __future__ import annotations

import numpy as np
import torch

from ..geom import quat_to_mat


class FeatureManager:
    def __init__(self, capacity: int, window: int, vo_size: int, min_parallax: float,
                 init_depth: float = 5.0, max_depth: float = 200.0, *, device):
        self.device = torch.device(device)
        self.F = capacity
        self.B = window
        self.Vo = vo_size
        self.min_parallax = min_parallax
        self.init_depth = init_depth
        self.max_depth = max_depth

        F, B = capacity, window
        self.ids = np.full(F, -1, dtype=np.int64)  # -1 = free slot
        self.start = np.zeros(F, dtype=np.int32)
        self.obs = np.zeros((F, B, 3))  # normalized [x,y,1]
        self.vel = np.zeros((F, B, 2))  # normalized-plane velocity
        self.has_obs = np.zeros((F, B), dtype=bool)
        self.depth = np.full(F, -1.0)  # estimated depth in host frame; -1 = unset
        self.solve_flag = np.zeros(F, dtype=np.int8)
        self.outlier = np.zeros(F, dtype=bool)
        self.last_track_num = 0

    # -------------------------------------------------------------- helpers
    def active(self) -> np.ndarray:
        return self.ids >= 0

    def used_num(self) -> np.ndarray:
        return self.has_obs.sum(axis=1)

    def end_frame(self) -> np.ndarray:
        """Index of last observation (tracks are contiguous from start)."""
        last = np.where(
            self.has_obs.any(axis=1), self.B - 1 - np.argmax(self.has_obs[:, ::-1], axis=1), -1
        )
        return last

    def good_mask(self) -> np.ndarray:
        """goodFeature (feature_manager.cpp:27–31)."""
        return self.active() & (self.used_num() >= 2) & (self.start < self.Vo)

    def feature_count(self) -> int:
        return int(self.good_mask().sum())

    # -------------------------------------------------------------- ingest
    def add_features(self, frame_count: int, feat_ids, pts, vels=None) -> bool:
        """Insert the frame's feature packet; returns True if the frame is a
        keyframe (-> MARGIN_OLD) per the parallax test."""
        feat_ids = np.asarray(feat_ids, dtype=np.int64)
        pts = np.asarray(pts)
        # vectorized id -> row match via sorted search over active slots
        act_rows = np.where(self.ids >= 0)[0]
        if len(act_rows) and len(feat_ids):
            order = np.argsort(self.ids[act_rows])
            sorted_ids = self.ids[act_rows][order]
            pos = np.searchsorted(sorted_ids, feat_ids)
            pos_c = np.clip(pos, 0, len(sorted_ids) - 1)
            found = sorted_ids[pos_c] == feat_ids
            match_rows = act_rows[order][pos_c]
        else:
            found = np.zeros(len(feat_ids), bool)
            match_rows = np.zeros(len(feat_ids), np.int64)
        self.last_track_num = int(found.sum())

        # existing tracks: batched observation write
        er = match_rows[found]
        self.obs[er, frame_count] = pts[found]
        if vels is not None:
            self.vel[er, frame_count] = np.asarray(vels)[found]
        self.has_obs[er, frame_count] = True

        # new tracks: assign free slots in order; overflow drops the rest
        new_idx = np.where(~found)[0]
        free_rows = np.where(self.ids < 0)[0]
        if len(new_idx) > len(free_rows):
            import logging

            logging.getLogger(__name__).warning(
                "feature capacity full: dropping %d new tracks",
                len(new_idx) - len(free_rows),
            )
            new_idx = new_idx[: len(free_rows)]
        nr = free_rows[: len(new_idx)]
        self.ids[nr] = feat_ids[new_idx]
        self.start[nr] = frame_count
        self.has_obs[nr, :] = False
        self.depth[nr] = -1.0
        self.solve_flag[nr] = 0
        self.outlier[nr] = False
        self.obs[nr, frame_count] = pts[new_idx]
        if vels is not None:
            self.vel[nr, frame_count] = np.asarray(vels)[new_idx]
        self.has_obs[nr, frame_count] = True

        if frame_count < 2 or self.last_track_num < 20:
            return True
        # compensated parallax between frame_count-2 and frame_count-1
        sel = (
            self.active()
            & (self.start <= frame_count - 2)
            & (self.end_frame() >= frame_count - 1)
        )
        if not sel.any():
            return True
        p2 = self.obs[sel, frame_count - 2]
        p1 = self.obs[sel, frame_count - 1]
        du = p2[:, 0] / p2[:, 2] - p1[:, 0]
        dv = p2[:, 1] / p2[:, 2] - p1[:, 1]
        parallax = np.sqrt(du * du + dv * dv)
        return float(parallax.mean()) >= self.min_parallax

    def get_corresponding(self, l: int, r: int):
        sel = self.active() & self.has_obs[:, l] & self.has_obs[:, r]
        return self.obs[sel, l], self.obs[sel, r]

    # ------------------------------------------------------- triangulation
    def triangulate(self, P, Q, tic, qic):
        """Batched multi-view DLT for all good features without depth
        (feature_manager.cpp:206–258). P (B,3), Q (B,4) window states."""
        need = self.good_mask() & (self.depth <= 0) & ~self.outlier
        if not need.any():
            return
        rows = np.where(need)[0]
        dev = self.device
        t = lambda a, dt=torch.float64: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
        depths = _triangulate_batch(
            t(self.obs), t(self.has_obs, torch.bool), t(self.start, torch.int64),
            t(P), t(Q), t(tic), t(qic),
        ).cpu().numpy()[rows]
        # Degenerate DLT (behind the camera / tiny depth / non-finite) falls
        # back to INIT_DEPTH like the reference (feature_manager.cpp:252–255).
        # The reference ALSO resets depths > 8 m to 5 m — that destroys
        # genuinely far points (low-parallax tracks: sky, distant structure),
        # planting a 5 m landmark where an ~infinite one belongs and biasing
        # the solve; we instead keep the DLT estimate, clipped to max_depth,
        # which approximates the far point and still contributes its
        # rotational information.
        bad = (depths < 0.1) | ~np.isfinite(depths)
        depths = np.where(bad, self.init_depth, np.minimum(depths, self.max_depth))
        self.depth[rows] = depths

    # --------------------------------------------------------- depth <-> solver
    def depth_vector(self) -> np.ndarray:
        """(F,) inverse depths for solver slots; zeros for non-good rows."""
        out = np.zeros(self.F)
        good = self.good_mask()
        d = np.where(self.depth[good] > 1e-6, self.depth[good], self.init_depth)
        out[good] = 1.0 / d
        return out

    def set_depths(self, inv_dep: np.ndarray):
        """Write back solver results (setDepth, feature_manager.cpp:145–163).

        Failure flag (solve_flag=2 -> removed) only for NEGATIVE solved depth,
        like the reference. An earlier >10 m kill-gate here was wrong: scenes
        with legitimately far structure (machine-hall walls at 6–12 m) lost
        most of their tracks every solve and the starved window dead-reckoned
        to divergence (measured on the loop-closure e2e world: good-feature
        count 50 -> <10 within 40 frames). Far depths are clamped to
        max_depth instead."""
        good = self.good_mask()
        rows = np.where(good)[0]
        inv = np.asarray(inv_dep)[rows]
        depth = np.where(np.abs(inv) > 1e-8, 1.0 / inv, -1.0)
        self.solve_flag[rows] = np.where(depth < 0, 2, 1)
        self.depth[rows] = np.where(depth > 0, np.minimum(depth, self.max_depth), depth)

    def remove_failures(self):
        kill = self.active() & ((self.solve_flag == 2) | self.outlier)
        self.ids[kill] = -1
        self.has_obs[kill] = False

    def mark_outliers(self, Ps, Qs, tic, qic, focal: float,
                      thresh_px: float = 3.0) -> int:
        """Post-solve reprojection outlier culling (vectorized host pass).

        The reference carries an `is_outlier` flag whose only setter is
        commented out (feature_manager.cpp:249) — it ships with the frontend
        RANSAC as the sole visual outlier gate. A mistracked feature that
        survives RANSAC then sits in the window for its whole track life,
        biasing every solve through the Cauchy tail. Here: reproject every
        observation at the solved state, flag tracks whose mean error
        exceeds thresh_px. Returns the number flagged."""
        good = self.good_mask() & (self.depth > 0)
        rows = np.where(good)[0]
        if len(rows) == 0:
            return 0
        from ..geom.hostmath import quat_to_mat_np

        R = np.stack([quat_to_mat_np(Qs[k]) for k in range(len(Qs))])  # (B,3,3)
        Ric = quat_to_mat_np(np.asarray(qic))
        tic = np.asarray(tic)
        hosts = self.start[rows]
        # world point of each track from its host observation + depth
        pc = self.obs[rows, hosts] * self.depth[rows, None]
        pb = pc @ Ric.T + tic
        pw = np.einsum("nij,nj->ni", R[hosts], pb) + np.asarray(Ps)[hosts]
        # reproject into every observed frame
        diff = pw[:, None, :] - np.asarray(Ps)[None, :, :]  # (n, B, 3)
        pb_all = np.einsum("bji,nbj->nbi", R, diff)  # R_b^T (pw - P_b)
        pc_all = np.einsum("ji,nbj->nbi", Ric, pb_all - tic)
        z = pc_all[:, :, 2]
        z_safe = np.where(np.abs(z) > 1e-6, z, 1.0)
        uv = pc_all[:, :, :2] / z_safe[:, :, None]
        err = np.linalg.norm(uv - self.obs[rows][:, :, :2], axis=2) * focal
        m = self.has_obs[rows] & (z > 0.05)
        n_obs = np.maximum(m.sum(axis=1), 1)
        mean_err = np.where(m, err, 0.0).sum(axis=1) / n_obs
        # Outliers are *relative*: under a model error (biased init, gravity
        # tilt mid-correction) EVERY track reprojects badly and an absolute
        # gate strips the window of the only information that can fix the
        # state — measured on the noisy loop e2e, a plain 3 px gate culled
        # 50 -> 0 tracks within 20 frames and the run dead-reckoned to
        # divergence. Gate at max(thresh, 5x median), cap the cull at 20% of
        # tracks per pass, and never cull a starved window.
        if len(rows) < 20:
            return 0
        med = float(np.median(mean_err))
        gate = max(thresh_px, 5.0 * med)
        bad = (mean_err > gate) | ((m.sum(axis=1) == 0) & (self.used_num()[rows] >= 2))
        max_cull = max(1, int(0.2 * len(rows)))
        if bad.sum() > max_cull:
            worst = np.argsort(mean_err)[::-1][:max_cull]
            keep = np.zeros_like(bad)
            keep[worst] = True
            bad &= keep
        self.outlier[rows[bad]] = True
        return int(bad.sum())

    # ----------------------------------------------------------- window shifts
    def _shift_all_left(self):
        """Window slid by one: every slot-indexed observation moves down one.
        (The reference stores obs relative to start_frame, so only the
        start_frame decrement is needed there; our SoA is slot-indexed.)"""
        self.obs[:, :-1] = self.obs[:, 1:]
        self.vel[:, :-1] = self.vel[:, 1:]
        self.has_obs[:, :-1] = self.has_obs[:, 1:]
        self.has_obs[:, -1] = False

    def remove_back_shift_depth(self, marg_R, marg_P, new_R, new_P):
        """MARGIN_OLD after NON_LINEAR: drop frame-0 obs, re-anchor host depth
        to the next frame (feature_manager.cpp:275–313). marg_* = camera pose
        of the dropped frame, new_* = camera pose of the new frame 0."""
        act = self.active()
        starts0 = act & (self.start == 0)
        uv0 = self.obs[:, 0].copy()

        self._shift_all_left()
        self.start[act & (self.start != 0)] -= 1

        for r in np.where(starts0)[0]:
            if self.has_obs[r].sum() < 2:
                self.ids[r] = -1
                self.has_obs[r] = False
                continue
            if self.depth[r] > 0:
                pts_i = uv0[r] * self.depth[r]
                w_pts = marg_R @ pts_i + marg_P
                pts_j = new_R.T @ (w_pts - new_P)
                self.depth[r] = pts_j[2] if pts_j[2] > 0 else self.init_depth
            else:
                self.depth[r] = -1.0

    def remove_back(self):
        """MARGIN_OLD during INITIAL (feature_manager.cpp:315–331)."""
        act = self.active()
        self._shift_all_left()
        self.start[act & (self.start != 0)] -= 1
        dead = act & ~self.has_obs.any(axis=1)
        self.ids[dead] = -1

    def remove_front(self, frame_count: int):
        """MARGIN_NEW: the second-newest frame is dropped and the newest frame
        takes its slot (feature_manager.cpp:334–354). Slot-indexed: delete
        slot frame_count-1, shift the newest obs down."""
        act = self.active()
        j = frame_count - 1
        self.obs[:, j:-1] = self.obs[:, j + 1 :]
        self.vel[:, j:-1] = self.vel[:, j + 1 :]
        self.has_obs[:, j:-1] = self.has_obs[:, j + 1 :]
        self.has_obs[:, -1] = False
        self.start[act & (self.start == frame_count)] -= 1
        dead = act & ~self.has_obs.any(axis=1)
        self.ids[dead] = -1

    # ------------------------------------------------------------- export
    def build_proj_factors(self, N: int, marg_old: bool = False):
        """Flatten good tracks into padded ProjFactors arrays + the forward-
        marginalization subset (host frame 0, observed at frame 1 — the
        estimator.cpp:1083–1087 tagging). Returns dict of numpy arrays."""
        # outlier-flagged tracks are dead weight awaiting remove_failures —
        # never let them contribute another factor
        good = self.good_mask() & ~self.outlier
        rows = np.where(good)[0]
        # vectorized flattening (the per-observation Python loop here ran
        # ~10^3 iterations per frame and was a host bottleneck): observation
        # mask with the host column cleared, then one np.where — row-major
        # order matches the original (row asc, frame asc) exactly
        m = self.has_obs[rows].copy()
        m[np.arange(len(rows)), self.start[rows]] = False
        rr, ff = np.where(m)
        fidx_a = rows[rr].astype(np.int32)
        idx_j_a = ff.astype(np.int32)
        idx_i_a = self.start[rows][rr].astype(np.int32)
        pts_i_a = self.obs[fidx_a, idx_i_a]
        pts_j_a = self.obs[fidx_a, idx_j_a]

        if marg_old:
            msel = (idx_i_a == 0) & (idx_j_a == 1)
            m_pts_i = pts_i_a[msel]
            m_pts_j = pts_j_a[msel]
            m_fidx = fidx_a[msel]
        else:
            m_pts_i = np.zeros((0, 3))
            m_pts_j = np.zeros((0, 3))
            m_fidx = np.zeros(0, np.int32)

        n = len(fidx_a)
        if n > N:
            import logging

            logging.getLogger(__name__).warning(
                "proj-factor capacity overflow: %d observations > N=%d; "
                "dropping the %d newest-frame observations", n, N, n - N
            )
            fidx_a, idx_i_a, idx_j_a = fidx_a[:N], idx_i_a[:N], idx_j_a[:N]
            pts_i_a, pts_j_a = pts_i_a[:N], pts_j_a[:N]
            n = N
        pad = N - n

        out = {
            "idx_i": np.concatenate([idx_i_a, np.zeros(pad, np.int32)]),
            "idx_j": np.concatenate([idx_j_a, np.ones(pad, np.int32)]),
            "fidx": np.concatenate([fidx_a, np.zeros(pad, np.int32)]),
            "pts_i": np.concatenate([pts_i_a, np.tile([0.0, 0.0, 1.0], (pad, 1))]),
            "pts_j": np.concatenate([pts_j_a, np.tile([0.0, 0.0, 1.0], (pad, 1))]),
            "valid": np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
            "marg_pts_i": m_pts_i.reshape(-1, 3),
            "marg_pts_j": m_pts_j.reshape(-1, 3),
            "marg_fidx": m_fidx.reshape(-1),
        }
        return out


def _triangulate_batch(obs, has_obs, start, P, Q, tic, qic):
    """Masked multi-view DLT (feature_manager.cpp:216–246), batched over
    tracks. obs (n,B,3), has_obs (n,B), start (n,); returns host-frame depths
    (n,). The nullspace is the right singular vector of the smallest
    singular value of each (2B,4) system."""
    A = _dlt_systems(obs, has_obs, start, P, Q, tic, qic)
    _, _, Vh = torch.linalg.svd(A, full_matrices=False)
    v = Vh[:, -1]
    return v[:, 2] / torch.where(v[:, 3].abs() > 1e-12, v[:, 3], torch.full_like(v[:, 3], 1e-12))


def _dlt_systems(obs, has_obs, start, P, Q, tic, qic):
    """(n, 2B, 4) masked DLT rows of every track in its host camera frame.
    Every argument may carry the same leading sequence axes."""
    R = quat_to_mat(Q)  # (B,3,3)
    Ric = quat_to_mat(qic)
    t_cam = P + (R @ tic[..., None, :, None])[..., 0]  # (B,3)
    R_cam = R @ Ric[..., None, :, :]  # (B,3,3)
    t0 = torch.gather(t_cam, -2, start[..., None].expand(start.shape + (3,)))  # (n,3)
    R0 = torch.gather(R_cam, -3, start[..., None, None].expand(start.shape + (3, 3)))  # (n,3,3)
    # relative transforms host -> each frame, exactly as the JAX reference
    # computes them (einsum "ji,bi->bj" / "ji,bik->bjk"): R0 (t_b - t0) and
    # R0 R_b. The reference's comment and feature_manager.cpp use R0^T; the
    # port keeps the reference's product so both packages seed the same
    # depths (ROADMAP, queue C, item 7).
    t_rel = torch.einsum("...nji,...nbi->...nbj", R0,
                         t_cam[..., None, :, :] - t0[..., :, None, :])
    R_rel = torch.einsum("...nji,...bik->...nbjk", R0, R_cam)
    Pl = R_rel.transpose(-1, -2)
    Pt = -(Pl @ t_rel[..., None])[..., 0]
    Pm = torch.cat([Pl, Pt[..., None]], dim=-1)  # (n,B,3,4)
    # sanitize BEFORE the normalize: unobserved rows are zero-padded and
    # 0/0 -> NaN would poison the system through the mask (NaN * 0 = NaN)
    unit_z = torch.tensor([0.0, 0.0, 1.0], dtype=obs.dtype, device=obs.device)
    o = torch.where(has_obs[..., None], obs, unit_z)
    f = o / torch.linalg.norm(o, dim=-1, keepdim=True)
    row0 = f[..., 0:1] * Pm[..., 2, :] - f[..., 2:3] * Pm[..., 0, :]
    row1 = f[..., 1:2] * Pm[..., 2, :] - f[..., 2:3] * Pm[..., 1, :]
    w = has_obs.to(obs.dtype)[..., None]
    return torch.cat([row0 * w, row1 * w], dim=-2)
