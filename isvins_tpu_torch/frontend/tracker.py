"""Feature tracker orchestration (torch port of
isvins_tpu/frontend/tracker.py; replaces FeatureTracker,
src/feature_tracker/feature_tracker_simple.cpp).

Per frame (readImage, :81-151): CLAHE -> pyramidal LK from the previous
frame -> border/err rejection -> epipolar RANSAC outlier rejection on the
normalized plane (rejectWithF, :153-180; the reference's virtual-pinhole
pixel threshold F_THRESHOLD/460 becomes a normalized-plane threshold) ->
min-distance dedup preferring the longest-lived tracks (setMask, :37-69)
-> Shi-Tomasi + NMS refill to max_cnt (:140) -> undistortion +
normalized-plane velocities (:197-244) -> monotonic id assignment
(:182-188).

The host object holds fixed-capacity SoA state (numpy); the per-frame
device work is one f32 step on the tracker's device (`_step`): CLAHE, LK
forward and back, the border gate, undistortion of the tracked points and
of the detection candidates, the fused epipolar RANSAC (on the card), and
Shi-Tomasi + NMS, at static shapes (capacity M + masks). `dispatch`
uploads the frame in its native dtype from a pinned buffer kept for it,
enqueues the step and starts the download of its packed (M, 11) result
into another kept pinned buffer behind an event,
without reading the device on the host; `collect` waits on that event and
runs the host half. Each frame's padded pyramid is built once and kept for
the next frame's LK.

The host path's epipolar RANSAC (8-point + SVD, f64) runs on CPU tensors,
as the reference pins it to the host CPU."""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..initial.five_point import _ransac_core, epipolar_inliers
from ..utils import perf
from .camera import make_camera
from .image_ops import clahe, min_dist_mask, nms_topk, shi_tomasi_response
from .lk import padded_pyramid, pyramidal_lk

# the host state that load_state installs (prev_img aside)
STATE_KEYS = ("pts", "ids", "track_cnt", "valid", "prev_un", "prev_time", "next_id",
              "_ransac_seed")


def _round_f32(cam):
    """The camera model with every parameter rounded to f32 (the f32 twin
    of the device step, as the reference's cam32)."""
    r = lambda v: (tuple(float(np.float32(c)) for c in v) if isinstance(v, tuple)
                   else float(np.float32(v)))
    return type(cam)(*(r(v) for v in cam))


class PendingTrack:
    """A dispatched, not yet collected tracker step: the packed (M, 11)
    result in a host buffer (pinned, on the card) that the step's event
    guards, and, on the card while utils.perf is on at the dispatch, the
    span of the stream from the upload's start to the download's end
    (`stream_ms()` after `collect`, else None; the stream trails the host's
    enqueue, so this is not the card's busy time)."""

    def __init__(self, t, first, packed, event=None, start=None):
        self.t, self.first = t, first
        self._packed, self._event, self._start = packed, event, start

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._packed.numpy().astype(np.float64)

    def stream_ms(self):
        return None if self._start is None else self._start.elapsed_time(self._event)


class FeatureTracker:
    def __init__(self, cam_cfg, tracker_cfg, device=None):
        """`device`: where the per-frame step runs (None: the CUDA card;
        the CPU only on `device="cpu"`)."""
        self.device = resolve_device(device)
        self.cam = make_camera(cam_cfg)
        self.cam32 = _round_f32(self.cam)
        self.cfg = tracker_cfg
        self.W = cam_cfg.width
        self.H = cam_cfg.height
        M = tracker_cfg.max_cnt
        self.M = M

        self.pts = np.zeros((M, 2))
        self.ids = np.full(M, -1, dtype=np.int64)
        self.track_cnt = np.zeros(M, dtype=np.int32)
        self.valid = np.zeros(M, dtype=bool)
        self.prev_un = np.zeros((M, 3))
        self.prev_img = None  # device tensor, CLAHE'd f32, output of _step
        self._prev_pyr = None  # its padded pyramid
        self.prev_time = None
        self.next_id = 0
        self._ransac_seed = 0
        self._pending = None
        self._staging = {}  # the card's pinned upload and download buffers, by name

        # epipolar RANSAC placement (TrackerConfig.fused_ransac): fused into
        # the device step on the card, the f64 host path on the CPU, as the
        # reference resolves it by backend
        self.fused_ransac = (tracker_cfg.fused_ransac if tracker_cfg.fused_ransac is not None
                             else self.device.type == "cuda")
        self._n_ransac_hyp = 128
        self._half = tracker_cfg.lk_win // 2
        self._pad = self._half + 3

    def reset(self):
        """Drop all LK state after a stream discontinuity (System.cpp:72-79).
        Track ids keep counting up so the estimator never sees a stale id
        reused."""
        self.pts[:] = 0.0
        self.ids[:] = -1
        self.track_cnt[:] = 0
        self.valid[:] = False
        self.prev_un[:] = 0.0
        self.prev_img = None
        self._prev_pyr = None
        self.prev_time = None
        if self._pending is not None:
            self._pending.wait()  # the next dispatch reuses its staging buffers
        self._pending = None

    def load_state(self, state: dict):
        """Install a tracker's host state from numpy (the keys of
        STATE_KEYS and `prev_img`, the CLAHE'd previous image or None), e.g.
        utils.convert.tracker_state of the JAX package's tracker, so that
        two trackers continue from the same mid-sequence state."""
        assert self._pending is None, "collect() the pending frame first"
        for k in STATE_KEYS:
            v = state[k]
            setattr(self, k, np.array(v, dtype=getattr(self, k).dtype)
                    if isinstance(getattr(self, k), np.ndarray) else v)
        self.next_id, self._ransac_seed = int(self.next_id), int(self._ransac_seed)
        img = state.get("prev_img")
        if img is None:
            self.prev_img = self._prev_pyr = None
        else:
            self.prev_img = torch.as_tensor(np.asarray(img, np.float32)).to(self.device)
            self._prev_pyr = padded_pyramid(self.prev_img, self.cfg.lk_levels, self._pad)

    # ------------------------------------------------------------ device step
    def _step(self, img, pts, valid, prev_un2, age_ok, samples, first: bool):
        """The per-frame device work. Returns (imgf, its padded pyramid,
        packed (M, 11) f32); fixed capacity M. `img` may arrive uint8 and
        is converted here. prev_un2 (M, 2) / age_ok (M,) / samples (S, 8)
        feed the fused epipolar RANSAC (unused when it is off or on the
        first frame)."""
        cfg = self.cfg
        imgf = img.to(torch.float32)
        if cfg.equalize:
            imgf = clahe(imgf)
        pyr = padded_pyramid(imgf, cfg.lk_levels, self._pad)

        if first:
            pts1 = pts
            ok = torch.zeros_like(valid)
        else:
            pts1, okl, _ = pyramidal_lk(self.prev_img, imgf, pts, valid, levels=cfg.lk_levels,
                                        half=self._half, pyr0=self._prev_pyr, pyr1=pyr)
            b = float(cfg.border)
            inb = ((pts1[:, 0] >= b) & (pts1[:, 0] < self.W - b)
                   & (pts1[:, 1] >= b) & (pts1[:, 1] < self.H - b))
            ok = okl & valid & inb
            if cfg.flow_back:
                # forward-backward consistency (VINS-Fusion FLOW_BACK),
                # single-level with the original position as the initial
                # guess (cv::OPTFLOW_USE_INITIAL_FLOW); both pyramids' first
                # levels are the forward pass's
                pts0b, okb, _ = pyramidal_lk(imgf, self.prev_img, pts1, ok, levels=1,
                                             half=self._half, iters=8, guess0=pts,
                                             pyr0=pyr[:1], pyr1=self._prev_pyr[:1])
                rt = torch.linalg.vector_norm(pts0b - pts, dim=1)
                ok = ok & okb & (rt < cfg.flow_back_thresh)

        un1 = self.cam32.lift_projective(pts1)

        if (not first) and self.fused_ransac:
            # fused epipolar rejection (rejectWithF semantics): candidate
            # rows sampled on the host PRE-LK (a superset; hypotheses that
            # drew an LK casualty lose the argmax). Degeneracy guard as in
            # the host path: a winner that explains < half the candidates
            # (near-planar view) is ignored.
            m = ok & age_ok
            thresh = float(cfg.f_threshold) / float(self.cam.focal)
            inl, n_inl = epipolar_inliers(prev_un2, un1[:, :2], m, samples, thresh * thresh)
            n_m = torch.sum(m)
            trust = (n_m >= 15) & (n_inl >= 0.5 * n_m)
            ok = torch.where(trust, ok & (inl | ~m), ok)

        # detection candidates for the refill, min_dist away from every
        # point that is still tracked (a superset of the host culls' survivors)
        resp = shi_tomasi_response(imgf)
        forbid = min_dist_mask(self.H, self.W, pts1, ok, cfg.min_dist)
        cand, cand_vals, cand_ok = nms_topk(resp, self.M, cfg.min_dist, border=cfg.border + 2,
                                            forbid_mask=forbid)
        un_cand = self.cam32.lift_projective(cand)
        # all camera models return lift_projective with z = 1: only xy travel
        packed = torch.cat([pts1, un1[:, :2], cand, cand_vals[:, None], un_cand[:, :2],
                            ok[:, None].to(torch.float32), cand_ok[:, None].to(torch.float32)],
                           dim=1)
        return imgf, pyr, packed  # (M, 11)

    # ------------------------------------------------------------- pipeline
    def _pinned(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """This tracker's pinned staging buffer `name`, made on first use
        (again if the shape or dtype changes) and reused: the one pending
        step's copies from and into it have ended when the next dispatch
        writes it (collect and reset wait on the step's event)."""
        buf = self._staging.get(name)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = self._staging[name] = torch.empty(like.shape, dtype=like.dtype,
                                                    pin_memory=True)
        return buf

    def _upload(self, name: str, a: np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return self._pinned(name, t).copy_(t).to(self.device, non_blocking=True)

    def dispatch(self, img: np.ndarray, t: float) -> PendingTrack:
        """Enqueue this frame's device step WITHOUT waiting for the device
        and return the pending token for `collect`: the frontend half of a
        dispatch-level pipeline (the device tracks this frame while the
        host runs the previous frame's estimator update). One dispatch may
        be pending at a time (the next needs the host track state that
        collect installs). The image travels in its native dtype (uint8
        stays uint8; f64 becomes f32) and is converted on the device."""
        assert self._pending is None, "collect() the previous frame first"
        img = np.ascontiguousarray(img)
        if img.dtype == np.float64:
            img = img.astype(np.float32)
        first = self.prev_img is None
        # fused-RANSAC side inputs: hypothesis rows from the PRE-LK track set
        S = self._n_ransac_hyp
        samples = np.zeros((S, 8), np.int64)
        age_ok = np.zeros(self.M, bool)
        if self.fused_ransac and not first:
            rows = np.where(self.valid & (self.track_cnt >= 1))[0]
            if len(rows) >= 15:
                rng = np.random.default_rng(self._ransac_seed)
                self._ransac_seed += 1
                samples = np.stack([rng.choice(rows, size=8, replace=False)
                                    for _ in range(S)]).astype(np.int64)
                age_ok[rows] = True
        # one f32 upload of the per-slot inputs: pts, prev_un xy, valid, age_ok
        slots = np.concatenate([self.pts, self.prev_un[:, :2], self.valid[:, None],
                                age_ok[:, None]], axis=1).astype(np.float32)

        cuda = self.device.type == "cuda"
        timed = cuda and perf.enabled()
        start = end = None
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        img_d = self._upload("img", img)
        slots_d = self._upload("slots", slots)
        samples_d = self._upload("samples", samples)
        imgf, pyr, packed = self._step(img_d, slots_d[:, 0:2], slots_d[:, 4] > 0.5,
                                       slots_d[:, 2:4], slots_d[:, 5] > 0.5, samples_d, first)
        if cuda:
            host = self._pinned("packed", packed)
            host.copy_(packed, non_blocking=True)
            end = torch.cuda.Event(enable_timing=timed)
            end.record()
        else:
            host = packed
        self.prev_img, self._prev_pyr = imgf, pyr
        self._pending = PendingTrack(t, first, host, end, start)
        return self._pending

    def collect(self, pending=None):
        """Wait for the pending step and run the host half: epipolar RANSAC
        (host path), min-dist dedup, refill bookkeeping, velocities.
        Returns the feature packet dict (same contract as read_image)."""
        pending = pending or self._pending
        assert pending is not None and pending is self._pending
        self._pending = None
        t = pending.t
        packed_f = pending.wait()
        pts1 = packed_f[:, 0:2]
        un1 = np.concatenate([packed_f[:, 2:4], np.ones((self.M, 1))], axis=1)
        cand = packed_f[:, 4:6]
        cand_vals = packed_f[:, 6]
        un_cand = np.concatenate([packed_f[:, 7:9], np.ones((self.M, 1))], axis=1)
        ok = packed_f[:, 9] > 0.5
        cand_ok = packed_f[:, 10] > 0.5

        if not pending.first:
            self.pts = pts1.copy()
            self.valid = ok
            self.track_cnt = np.where(ok, self.track_cnt + 1, 0)
            if not self.fused_ransac:
                # epipolar outlier rejection (rejectWithF) on the host; the
                # fused path applied it in the device step
                self._reject_with_f(un1)

        # min-distance dedup, longest tracks win (setMask)
        self._dedup_min_dist()

        # refill with new detections
        un = un1.astype(np.float64)
        n_cur = int(self.valid.sum())
        if n_cur < self.M:
            rows, sel = self._refill(cand, cand_vals, cand_ok, self.M - n_cur)
            un[rows] = un_cand[sel]

        # velocities on the normalized plane
        vel = np.zeros((self.M, 2))
        if self.prev_time is not None:
            dt = max(t - self.prev_time, 1e-6)
            had_prev = self.valid & (self.track_cnt > 1)
            vel[had_prev] = (un[had_prev, :2] - self.prev_un[had_prev, :2]) / dt
        self.prev_un = un.copy()
        self.prev_time = t

        sel = self.valid
        return {
            "ids": self.ids[sel].copy(),
            "pts_norm": un[sel].copy(),
            "pts_px": self.pts[sel].copy(),
            "vel": vel[sel].copy(),
            "track_cnt": self.track_cnt[sel].copy(),
        }

    def read_image(self, img: np.ndarray, t: float):
        """img: (H, W) uint8/float. Synchronous dispatch + collect (the
        non-pipelined path; tests and simple drivers)."""
        self.dispatch(img, t)
        return self.collect()

    # -------------------------------------------------------------- helpers
    def _reject_with_f(self, un_cur: np.ndarray):
        mask = self.valid & (self.track_cnt > 1)
        rows = np.where(mask)[0]
        if len(rows) < 15:
            return
        # pixel threshold -> normalized-plane units via the actual focal
        thresh = self.cfg.f_threshold / float(self.cam.focal)
        # fresh sample pattern each frame: a fixed seed correlates the
        # rejection across frames (same-sample failure modes recur)
        rng = np.random.default_rng(self._ransac_seed)
        self._ransac_seed += 1
        samples = np.stack([rng.choice(rows, size=8, replace=False) for _ in range(128)])
        f64 = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64))
        _, _, inl, n_inl, _ = _ransac_core(f64(self.prev_un[:, :2]), f64(un_cur[:, :2]),
                                           torch.as_tensor(mask), torch.as_tensor(samples),
                                           thresh * thresh)
        # degeneracy guard: a (near-)planar view makes the 8-point problem
        # rank-deficient and the "best" model arbitrary; if the winner
        # explains less than half the candidates, keep the tracks
        if int(n_inl) < 0.5 * len(rows):
            return
        self.valid[mask & ~inl.numpy()] = False

    def _dedup_min_dist(self):
        """Greedy min-dist keep, longest track first (setMask): one pairwise
        distance matrix, then an O(n) suppression sweep."""
        rows = np.where(self.valid)[0]
        if len(rows) == 0:
            return
        order = rows[np.argsort(-self.track_cnt[rows])]
        P = self.pts[order]
        d2 = ((P[:, None, :] - P[None, :, :]) ** 2).sum(-1)
        r2 = self.cfg.min_dist**2
        n = len(order)
        keep = np.ones(n, bool)
        idx = np.arange(n)
        for i in range(n):
            if keep[i]:
                keep[(d2[i] < r2) & (idx > i)] = False
        self.valid[order[~keep]] = False

    def _refill(self, cand, vals, ok, n_new: int):
        """Assign detection candidates (from the device step) to free slots.
        Returns (rows, sel): the slots filled and the candidates used."""
        # GFTT-style quality floor relative to the strongest response
        # (cv::goodFeaturesToTrack qualityLevel 0.01)
        ok = np.asarray(ok) & (vals > 0.01 * max(float(vals[0]), 1e-9))
        free = np.where(~self.valid)[0]
        take = min(n_new, int(ok.sum()), len(free))
        sel = np.where(ok)[0][:take]
        rows = free[:take]
        self.pts[rows] = cand[sel]
        self.ids[rows] = np.arange(self.next_id, self.next_id + take)
        self.next_id += take
        self.track_cnt[rows] = 1
        self.valid[rows] = True
        return rows, sel
