"""Dense pose-graph Gauss-Newton with per-pose covariance (torch port of
isvins_tpu/posegraph/optimize.py; reference ceres SPARSE_NORMAL_CHOLESKY +
ceres::Covariance, pose_graph.cpp:260-351).

For the active segment [first..cur] the full 6n x 6n normal system is
assembled from batched edge terms (sequential relative-pose edges,
per-keyframe roll-pitch edges, Huber-weighted loop edges with a graduated
non-convexity anneal) by one-hot expansion, solved by dense Cholesky, and
the per-pose 6x6 covariance blocks are read off the dense inverse. The
segment is solved at its exact pose count n and loop count (no capacity
buckets: PyTorch compiles nothing per shape). The first pose is
gauge-fixed (:299-302). f32 on a CUDA device, f64 on the CPU.

Segments of at least `dist_min_poses` poses, given more than one device,
go to the nested-dissection solve of parallel/dd_solver.py instead, as in
the reference (optimize.py:345-370): padded to the reference's capacity
bucket K (64/256/1024/4096) and split over nd of the devices.

`async_dispatch=True` runs the solve on a side CUDA stream and returns a
PendingOptimize; `finalize()` waits on the stream's event, so the frame
path never blocks on the solve (the reference's optimizeCS poll thread,
pose_graph.cpp:425).
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch
import torch.nn.functional as F

from ..factors.preintegration import cholesky_nan
from ..factors.priors import relpose_residual_jacobians, rollpitch_residual_jacobians
from ..factors.priors import relpose_update_np
from ..geom import quat_mul, quat_normalize, so3_exp_quat
from ..geom.hostmath import mat_to_quat_np, quat_mul_np, quat_normalize_np, quat_to_mat_np
from ..parallel.dd_solver import dd_pose_graph_solve
from ..parallel.distributed import _huber_weight
from ..parallel.sharded import make_mesh

_log = logging.getLogger(__name__)


def _optimize_core(t, q, edge_dt, edge_dq, edge_sqrt, edge_valid,
                   rp_q, rp_sqrt, rp_valid,
                   loop_i, loop_j, loop_dt, loop_dq, loop_w, loop_valid,
                   fixed_mask, iters: int, huber_delta: float = 0.1):
    """t (K,3), q (K,4) seed poses of the active segment, fixed_mask (K,)
    bool gauge-fixed poses; sequential edge k joins poses k and k+1 (rows
    [0, K-1) used); loop edges (L,) join loop_i (old) and loop_j (cur).
    Returns (t, q, cov blocks (K,6,6), cost)."""
    K = t.shape[0]
    D = 6 * K
    dtype, dev = t.dtype, t.device
    oh = lambda idx: F.one_hot(idx.long(), K).to(dtype)
    seq_oh_i, seq_oh_j = oh(torch.arange(K - 1, device=dev)), oh(torch.arange(1, K, device=dev))
    rp_oh = oh(torch.arange(K, device=dev))
    loop_oh_i, loop_oh_j = oh(loop_i), oh(loop_j)
    seq_m = edge_valid[:-1].to(dtype)
    rp_m = rp_valid.to(dtype)
    loop_s = torch.sqrt(torch.clamp(loop_w, min=0.0))
    colmask = torch.repeat_interleave(~fixed_mask, 6).to(dtype)
    eye = torch.eye(D, dtype=dtype, device=dev)

    def expand(Jb, onehot):
        return torch.einsum("nrk,nb->nrbk", Jb, onehot).reshape(Jb.shape[0], Jb.shape[1], D)

    def build(tt, qq, anneal=None):
        """H, b, cost at (tt, qq). anneal: None for plain Huber(delta);
        else a scalar in (0, 1] that raises each loop edge's Huber delta to
        max(delta, anneal * ||r_w||) (graduated non-convexity)."""
        r, Ji, Jj = relpose_residual_jacobians(edge_dt[:-1], edge_dq[:-1], tt[:-1], qq[:-1],
                                               tt[1:], qq[1:])
        S = edge_sqrt[:-1] * seq_m[:, None, None]
        r_s, Ji_s, Jj_s = (S @ r[..., None])[..., 0], S @ Ji, S @ Jj

        r, J = rollpitch_residual_jacobians(rp_q, qq)
        S = rp_sqrt * rp_m[:, None, None]
        r_rp, J_rp = (S @ r[..., None])[..., 0], S @ J

        r, Ji, Jj = relpose_residual_jacobians(loop_dt, loop_dq, tt[loop_i], qq[loop_i],
                                               tt[loop_j], qq[loop_j])
        r_w = loop_s[:, None] * r
        rsq = torch.sum(r_w * r_w, dim=-1)
        delta = huber_delta
        if anneal is not None:
            delta = torch.clamp(anneal * torch.sqrt(rsq + 1e-18), min=huber_delta)
        m = loop_valid.to(dtype) * _huber_weight(rsq, delta) * loop_s
        r_l, Ji_l, Jj_l = r * m[:, None], Ji * m[:, None, None], Jj * m[:, None, None]

        J = torch.cat([(expand(Ji_s, seq_oh_i) + expand(Jj_s, seq_oh_j)).reshape(-1, D),
                       expand(J_rp, rp_oh).reshape(-1, D),
                       (expand(Ji_l, loop_oh_i) + expand(Jj_l, loop_oh_j)).reshape(-1, D)])
        res = torch.cat([r_s.reshape(-1), r_rp.reshape(-1), r_l.reshape(-1)])
        J = J * colmask[None, :]  # gauge: zero columns of fixed poses
        H = J.T @ J + torch.diag(1.0 - colmask)  # unit diagonal on fixed dims
        return H, -(J.T @ res), 0.5 * torch.sum(res * res)

    for i in range(iters):
        anneal = torch.exp(torch.tensor(-1.2 * i, dtype=dtype, device=dev))
        H, b, _ = build(t, q, anneal)
        dx = torch.cholesky_solve(b[:, None], cholesky_nan(H + 1e-8 * eye))[:, 0]
        d = dx.reshape(K, 6)
        t = t + d[:, :3]
        q = quat_normalize(quat_mul(q, so3_exp_quat(d[:, 3:])))
    H, _, cost = build(t, q)
    Hinv = torch.cholesky_solve(eye, cholesky_nan(H + 1e-8 * eye))
    cov = Hinv.reshape(K, 6, K, 6).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    return t, q, cov, cost


class PendingOptimize:
    """A dispatched, not yet collected pose-graph optimization. The solve's
    outputs are copied into pinned host buffers on the solve's stream;
    `finalize()` waits on its event, writes the optimized poses,
    covariances and retro-updated edges into the db, and returns (r_drift,
    t_drift, cost); `landed` then says whether it wrote them (False: the
    solve's poses were not finite and it was discarded)."""

    def __init__(self, db, first_idx, cur_idx, n, outputs, event=None):
        self.db = db
        self.first_idx = first_idx
        self.cur_idx = cur_idx
        self._n = n
        self._outputs = outputs  # (t2, q2, cov, cost), host tensors
        self._event = event
        self.landed = False

    def finalize(self):
        if self._event is not None:
            self._event.synchronize()
        db, first_idx, cur_idx, n = self.db, self.first_idx, self.cur_idx, self._n
        t2, q2, cov, cost = (o.numpy().astype(np.float64) for o in self._outputs)
        if not (np.isfinite(t2).all() and np.isfinite(q2).all()):
            # a diverged solve must never poison the keyframe db: keep the
            # previous optimized poses and drift
            _log.warning("pose-graph optimization returned non-finite poses; "
                         "discarding this solve (segment %d..%d)", first_idx, cur_idx)
            r_keep = quat_to_mat_np(db.opt_q[cur_idx]) @ quat_to_mat_np(db.vio_q[cur_idx]).T
            t_keep = db.opt_t[cur_idx] - r_keep @ db.vio_t[cur_idx]
            return r_keep, t_keep, float("nan")
        sl = slice(first_idx, cur_idx + 1)
        # retro-update the sequential edge measurements to the optimized poses
        for k in range(n - 1):
            gi = first_idx + k
            if not db.edge_valid[gi]:
                continue
            db.edge_dt[gi], db.edge_dq[gi] = relpose_update_np(
                db.edge_dt[gi], db.edge_dq[gi], db.opt_t[gi], db.opt_q[gi],
                db.opt_t[gi + 1], db.opt_q[gi + 1], t2[k], q2[k], t2[k + 1], q2[k + 1])
        db.opt_t[sl] = t2
        db.opt_q[sl] = q2
        db.cov[sl] = cov
        self.landed = True
        # drift: optimized vs vio pose of cur (pose_graph.cpp:386-394)
        r_drift = quat_to_mat_np(q2[-1]) @ quat_to_mat_np(db.vio_q[cur_idx]).T
        t_drift = t2[-1] - r_drift @ db.vio_t[cur_idx]
        # re-apply the new drift to keyframes added after cur_idx while the
        # solve was in flight (pose_graph.cpp:408-417)
        q_drift = mat_to_quat_np(r_drift)
        for k in range(cur_idx + 1, db.n):
            db.opt_t[k] = r_drift @ db.vio_t[k] + t_drift
            db.opt_q[k] = quat_normalize_np(quat_mul_np(q_drift, db.vio_q[k]))
        return r_drift, t_drift, float(cost)


def _capacity(n):
    """The reference's capacity ladder (optimize.py:157-168): the padded
    pose and loop counts of the multi-device branch."""
    for k in (64, 256, 1024, 4096):
        if n <= k:
            return k
    return 4096


def _dd_inputs(db, first_idx, cur_idx, n, loops, fdt):
    """The multi-device branch's inputs as the reference builds them
    (optimize.py:288-329, 355-370): the segment padded to K poses (padded
    ones inactive), chain edges k -> k + 1 with a zero row appended, L loop
    rows, floats as `fdt`."""
    K = _capacity(n)
    sl = slice(first_idx, cur_idx + 1)
    ident = lambda rows: np.tile(np.array([1.0, 0, 0, 0]), (rows, 1))
    t, q = np.zeros((K, 3)), ident(K)
    t[:n], q[:n] = db.vio_t[sl], db.vio_q[sl]
    active = np.arange(K) < n
    fixed = np.zeros(K, bool)
    fixed[0] = True
    fixed[:n] |= db.seq[sl] == 0
    m = n - 1
    e_dt, e_dq, e_sqrt, e_valid = np.zeros((K, 3)), ident(K), np.zeros((K, 6, 6)), np.zeros(K, bool)
    e_dt[:m], e_dq[:m] = db.edge_dt[first_idx:first_idx + m], db.edge_dq[first_idx:first_idx + m]
    e_sqrt[:m], e_valid[:m] = (db.edge_sqrt[first_idx:first_idx + m],
                               db.edge_valid[first_idx:first_idx + m])
    e_i = np.minimum(np.arange(K, dtype=np.int32), K - 2)
    ev = np.zeros(K, bool)
    ev[:K - 1] = e_valid[:K - 1] & active[:K - 1] & active[1:]
    rp_q, rp_sqrt, rp_valid = ident(K), np.zeros((K, 2, 2)), np.zeros(K, bool)
    rp_q[:n], rp_sqrt[:n], rp_valid[:n] = db.rp_q[sl], db.rp_sqrt[sl], db.rp_valid[sl]
    L = _capacity(max(len(loops), 1))
    loop_i, loop_j = np.zeros(L, np.int32), np.zeros(L, np.int32)
    loop_dt, loop_dq, loop_w, loop_valid = np.zeros((L, 3)), ident(L), np.zeros(L), np.zeros(L, bool)
    for li, k in enumerate(loops):
        loop_i[li], loop_j[li] = db.loop_idx[k] - first_idx, k - first_idx
        loop_dt[li], loop_dq[li], loop_w[li] = db.loop_dt[k], db.loop_dq[k], db.loop_weight[k]
        loop_valid[li] = True
    f = lambda a: a.astype(fdt)
    return (f(t), f(q), active, fixed,
            e_i, e_i + 1, f(np.concatenate([e_dt[:K - 1], np.zeros((1, 3))])),
            f(np.concatenate([e_dq[:K - 1], ident(1)])),
            f(np.concatenate([e_sqrt[:K - 1], np.zeros((1, 6, 6))])), ev,
            np.arange(K, dtype=np.int32), f(rp_q), f(rp_sqrt), rp_valid & active,
            loop_i, loop_j, f(loop_dt), f(loop_dq), f(loop_w), loop_valid), K, L


def optimize_pose_graph(db, first_idx: int, cur_idx: int, iters: int = 10,
                        dist_min_poses: int = 512, max_active: int = 4096,
                        async_dispatch: bool = False, devices=None):
    """Optimize db poses [first_idx..cur_idx] in place (vio poses as initial
    values, first pose fixed), write the optimized poses and covariances
    back, and return (r_drift (3,3), t_drift (3,), cost); with
    `async_dispatch=True`, a PendingOptimize (call .finalize()). Mirrors
    optimizeCS (pose_graph.cpp:234-409). Segments longer than `max_active`
    are clamped to the most recent `max_active` poses (logged).

    `devices` is the device list the reference reads from the process
    (`jax.devices()`): None means every visible card when db.device is
    CUDA, else [db.device]; a list is taken as given. A segment of at least
    `dist_min_poses` poses, with more than one device listed, is solved by
    dd_pose_graph_solve on nd = min(largest power of two <= len(devices),
    L, K // 4, 8) of them, K and L the padded pose and loop counts; any
    other by the dense solve at its exact size on db.device. Either runs in
    f32 on a card and in f64 on the CPU."""
    dev = db.device
    n = cur_idx - first_idx + 1
    if n > max_active:
        _log.warning("pose-graph active segment %d poses > max_active=%d; clamping to the "
                     "most recent %d (older poses keep their current optimized values; loops "
                     "ending before the clamp are excluded this solve)", n, max_active, max_active)
        first_idx = cur_idx - max_active + 1
        n = max_active
    if devices is None:
        devices = make_mesh(torch.cuda.device_count()) if dev.type == "cuda" else [dev]
    devices = make_mesh(devices)
    sl = slice(first_idx, cur_idx + 1)
    loops = [k for k in range(first_idx, cur_idx + 1) if db.loop_idx[k] >= first_idx]
    if n >= dist_min_poses and len(devices) > 1:
        # domain decomposition (parallel/dd_solver.py): contiguous pose
        # segments per device and a small replicated interface, exact to the
        # dense solve with all O(D^3) work local to a shard
        fdt = np.float64 if devices[0].type == "cpu" else np.float32
        args, K, L = _dd_inputs(db, first_idx, cur_idx, n, loops, fdt)
        mesh = devices[:min(1 << (len(devices).bit_length() - 1), L, K // 4, 8)]

        def dd_solve():
            t2, q2, cov, cost = dd_pose_graph_solve(mesh, *args, iters=iters, with_cov=True)
            return t2[:n], q2[:n], cov[:n], cost
        return _dispatch(db, first_idx, cur_idx, n, mesh, dd_solve, async_dispatch)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    # poses of a loaded map (sequence 0) are held constant (pose_graph.cpp:299-302)
    fixed |= db.seq[sl] == 0
    edge_valid = np.zeros(n, bool)
    edge_valid[: n - 1] = db.edge_valid[first_idx:cur_idx]
    L = max(len(loops), 1)  # one masked row keeps the loop terms' shapes non-empty
    loop_i = np.zeros(L, np.int64)
    loop_j = np.zeros(L, np.int64)
    loop_dt = np.zeros((L, 3))
    loop_dq = np.tile(np.array([1.0, 0, 0, 0]), (L, 1))
    loop_w = np.zeros(L)
    loop_valid = np.zeros(L, bool)
    for li, k in enumerate(loops):
        loop_i[li] = db.loop_idx[k] - first_idx
        loop_j[li] = k - first_idx
        loop_dt[li] = db.loop_dt[k]
        loop_dq[li] = db.loop_dq[k]
        loop_w[li] = db.loop_weight[k]
        loop_valid[li] = True

    # f32 on the card (position magnitudes O(100 m) keep ~1e-5 m of
    # headroom), f64 on the CPU, as the reference (optimize.py:330-334)
    sdtype = torch.float64 if dev.type == "cpu" else torch.float32
    host = (db.vio_t[sl], db.vio_q[sl], db.edge_dt[sl], db.edge_dq[sl], db.edge_sqrt[sl], edge_valid,
            db.rp_q[sl], db.rp_sqrt[sl], db.rp_valid[sl],
            loop_i, loop_j, loop_dt, loop_dq, loop_w, loop_valid, fixed)

    def solve():
        args = [torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in host]
        args = [a.to(sdtype) if a.is_floating_point() else a for a in args]
        return _optimize_core(*args, iters=iters)

    return _dispatch(db, first_idx, cur_idx, n, [dev], solve, async_dispatch)


def _dispatch(db, first_idx, cur_idx, n, devices, solve, async_dispatch):
    """solve() -> (t, q, cov, cost) of the segment's n poses. On the CPU it
    runs at once; on the card(s) under a side CUDA stream of each, its
    outputs copied into pinned host buffers behind an event on the first
    card's stream. Returns the PendingOptimize, or what its finalize()
    returns."""
    if devices[0].type != "cuda":
        pending = PendingOptimize(db, first_idx, cur_idx, n, solve())
    else:
        streams = [torch.cuda.Stream(d) for d in dict.fromkeys(devices)]
        with contextlib.ExitStack() as stack:
            for st in streams:
                stack.enter_context(torch.cuda.stream(st))
            outs = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True).copy_(o, non_blocking=True)
                    for o in solve()]
            event = torch.cuda.Event()
            event.record(streams[0])
        pending = PendingOptimize(db, first_idx, cur_idx, n, outs, event)
    if async_dispatch:
        return pending
    return pending.finalize()
