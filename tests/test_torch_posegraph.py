"""The port's pose graph (isvins_tpu_torch.posegraph, initial.pnp, K6's
plain version, RoomRenderer, load_pose_graph) against the JAX package on
the CPU: the same numpy inputs through both, each test stating its
tolerance. The builder as a whole runs on the inputs of
tests/test_posegraph.py::test_builder_loop_closure_pipeline (26 keyframes,
skip_recent=8, so retrieval goes through K6's plain version). The CUDA
kernel itself is held against the plain version on the card in
tests/test_torch_gpu.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import isvins_tpu  # noqa: F401
from isvins_tpu_torch import ops

from test_frontend import _texture

T = lambda a: torch.as_tensor(np.array(a))
I32 = lambda a: torch.as_tensor(np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32))


@pytest.mark.parametrize("thresh", [40, 64])
def test_retrieval_scores_plain_vs_reference(thresh):
    """K6's plain version equals retrieval_scores_ref, the Pallas kernel in
    interpret mode and the JAX CPU path (keyframe_db._retrieval_scores)
    exactly: integer counts over one shared denominator."""
    from isvins_tpu.ops.hamming_pallas import retrieval_scores_pallas, retrieval_scores_ref
    from isvins_tpu.posegraph.keyframe_db import _retrieval_scores

    from isvins_tpu_torch.utils.synthetic import make_retrieval_db

    qd, qv, dbd, dbv = make_retrieval_db(48, seed=thresh)
    out = ops.retrieval_scores_ref(I32(qd), T(qv), I32(dbd), T(dbv), thresh).numpy()
    assert out.dtype == np.float32
    j = [jnp.asarray(a) for a in (qd, qv, dbd, dbv)]
    for ref in (retrieval_scores_ref(*j, thresh), retrieval_scores_pallas(*j, thresh)):
        np.testing.assert_array_equal(out, np.asarray(ref))
    np.testing.assert_array_equal(out, np.asarray(_retrieval_scores(*j, thresh), np.float32))
    assert out[3] > 0.9 and 0.3 < out[17] < 0.8 and out[9] == 0.0
    # the wrapper takes the plain version on CPU tensors and launches nothing
    ops.reset_launch_counts()
    np.testing.assert_array_equal(
        ops.retrieval_scores(I32(qd), T(qv), I32(dbd), T(dbv), thresh).numpy(), out)
    assert ops.launch_counts()["retrieval_scores"] == 0


def test_hamming_and_matching_exact(rng):
    """hamming_matrix, match_descriptors and match_descriptors_clean on the
    same descriptors (with near-duplicates, so the ratio test and the
    cross-check both bite) equal the JAX functions exactly."""
    from isvins_tpu.posegraph import brief as jb
    from isvins_tpu_torch.posegraph import brief as tb

    a = rng.integers(0, 2**32, size=(70, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(90, 8), dtype=np.uint32)
    b[:40] = a[:40] ^ (rng.random((40, 8)) < 0.02) * rng.integers(0, 2**32, (40, 8),
                                                                   dtype=np.uint32)
    b[40:50] = b[:10]  # exact duplicate pairs in b: ties for argmin
    va, vb = rng.random(70) > 0.1, rng.random(90) > 0.1
    np.testing.assert_array_equal(tb.hamming_matrix(I32(a), I32(b)).numpy(),
                                  np.asarray(jb.hamming_matrix(a, b)))
    for tf, jf in ((tb.match_descriptors, jb.match_descriptors),
                   (tb.match_descriptors_clean, jb.match_descriptors_clean)):
        for o, r in zip(tf(I32(a), T(va), I32(b), T(vb)), jf(a, va, b, vb)):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    q = rng.random(70) > 0.3
    np.testing.assert_allclose(tb.global_descriptor(I32(a), T(q)).numpy(),
                               np.asarray(jb.global_descriptor(a, q)), rtol=1e-5, atol=1e-6)


def test_brief_descriptors_agree():
    """BRIEF on a textured image: >= 99.9 % of the bits agree (the two
    packages' f32 patch products sum in different orders, so a bit whose
    two samples are within rounding may flip); points near the border
    exercise the clipped patch origin; invalid rows are zero in both."""
    from isvins_tpu.posegraph.brief import brief_descriptors as jbrief
    from isvins_tpu_torch.posegraph.brief import brief_descriptors, make_brief_pattern

    rng = np.random.default_rng(0)
    img = _texture(160, 200, 4).astype(np.float32)
    pts = rng.uniform([2, 2], [198, 158], size=(300, 2))
    valid = rng.random(300) > 0.1
    pattern = make_brief_pattern()
    ours = brief_descriptors(T(img), T(pts), T(valid), pattern).numpy().view(np.uint32)
    ref = np.asarray(jbrief(jnp.asarray(img), jnp.asarray(pts), jnp.asarray(valid), pattern))
    diff = np.bitwise_count(ours ^ ref).sum()
    assert diff <= 1e-3 * ours.size * 32, diff
    assert not ours[~valid].any()


def _pnp_problem(rng, n=60, n_out=15):
    """Points in front of a camera at a known pose, 1/4 outlier matches,
    and a guess 0.3 rad / 0.5 m off."""
    from isvins_tpu_torch.geom.hostmath import mat_to_quat_np, quat_to_mat_np

    X = rng.uniform([-3, -2, 4], [3, 2, 9], size=(n, 3))
    q = np.array([0.97, 0.1, -0.15, 0.12])
    q /= np.linalg.norm(q)
    t = np.array([0.3, -0.2, 0.5])
    pc = X @ quat_to_mat_np(q).T + t
    uv = pc[:, :2] / pc[:, 2:3]
    uv[:n_out] = rng.uniform(-0.6, 0.6, size=(n_out, 2))
    dR = quat_to_mat_np(mat_to_quat_np(np.eye(3)) + np.array([0.0, 0.15, 0.0, 0.0]))
    q0 = mat_to_quat_np(dR @ quat_to_mat_np(q))
    return X, uv, q0, t + 0.5, q, t


def test_pnp_ransac_matches_reference():
    """pnp_ransac_gn in f64 on the same matches: the same subsets (numpy
    generator, same call order), the same inliers, and the pose within
    1e-9 of the JAX package's; pnp_gn alone within 1e-9 too."""
    from isvins_tpu.initial.pnp import pnp_gn as j_gn
    from isvins_tpu.initial.pnp import pnp_ransac_gn as j_ransac
    from isvins_tpu_torch.initial.pnp import pnp_gn, pnp_ransac_gn

    X, uv, q0, t0, q_true, t_true = _pnp_problem(np.random.default_rng(5))
    ok, q, t, inl = pnp_ransac_gn(X, uv, q0, t0, device="cpu")
    jok, jq, jt, jinl = j_ransac(X, uv, q0, t0)
    assert ok and jok
    np.testing.assert_array_equal(inl, jinl)
    assert inl[15:].all() and not inl[:15].any()
    np.testing.assert_allclose(q, jq, atol=1e-9)
    np.testing.assert_allclose(t, jt, atol=1e-9)
    np.testing.assert_allclose(q, q_true, atol=1e-7)
    w = np.r_[np.zeros(15), np.ones(len(X) - 15)]
    ours = pnp_gn(T(X), T(uv), T(q0), T(t0), weights=T(w))
    for o, r in zip(ours, j_gn(X, uv, q0, t0, weights=w)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-9)
    # fewer than min_set matches: refused without a solve
    assert not pnp_ransac_gn(X[:5], uv[:5], q0, t0, device="cpu")[0]


def _drifted_loop_db(KeyframeDB, n=40):
    """tests/test_posegraph.py:60-105: a circle of keyframes with yaw and
    translation drift in the vio poses, sequential edges from GT with 1 cm
    of seeded noise (so the optimum has a cost well above rounding), one
    loop edge, and roll-pitch edges on every third keyframe."""
    from isvins_tpu_torch.geom.hostmath import (mat_to_quat_np, quat_conj_np, quat_mul_np,
                                                quat_normalize_np, quat_to_mat_np)

    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    t_gt = np.stack([5 * np.cos(th), 5 * np.sin(th), np.zeros(n)], axis=1)
    q_gt = np.stack([np.cos((th + np.pi / 2) / 2), 0 * th, 0 * th,
                     np.sin((th + np.pi / 2) / 2)], axis=1)
    db = KeyframeDB(64, 8, 8)
    noise = np.random.default_rng(3).normal(scale=0.01, size=(n, 3))
    for k in range(n):
        dy = 0.004 * k
        Rz = np.array([[np.cos(dy), -np.sin(dy), 0], [np.sin(dy), np.cos(dy), 0], [0, 0, 1]])
        tv = Rz @ t_gt[k] + np.array([0.002, 0.001, 0.0]) * k
        qv = quat_normalize_np(quat_mul_np(mat_to_quat_np(Rz), q_gt[k]))
        db.add(ts=float(k), vio_t=tv, vio_q=qv, opt_t=tv, opt_q=qv)
    for k in range(n - 1):
        db.edge_dt[k] = quat_to_mat_np(q_gt[k]).T @ (t_gt[k + 1] - t_gt[k]) + noise[k]
        db.edge_dq[k] = quat_normalize_np(quat_mul_np(quat_conj_np(q_gt[k]), q_gt[k + 1]))
        db.edge_sqrt[k] = np.eye(6) * 30.0
        db.edge_valid[k] = True
    for k in range(0, n, 3):
        db.rp_q[k] = q_gt[k]
        db.rp_sqrt[k] = np.eye(2) * 50.0
        db.rp_valid[k] = True
    db.loop_idx[n - 1] = 0
    db.loop_dt[n - 1] = quat_to_mat_np(q_gt[0]).T @ (t_gt[n - 1] - t_gt[0])
    db.loop_dq[n - 1] = quat_normalize_np(quat_mul_np(quat_conj_np(q_gt[0]), q_gt[n - 1]))
    db.loop_weight[n - 1] = 500.0
    return db


@pytest.mark.parametrize("async_dispatch", [False, True])
def test_optimize_matches_reference(tmp_path, async_dispatch):
    """One database, saved by the JAX package's save_pose_graph and loaded
    by the port's load_pose_graph, optimized by both in f64 (JAX pads the
    segment to its 64-pose bucket, the port solves at n = 40): poses, the
    covariance blocks, the drift and the cost within 1e-6 relative; the
    retro-updated edges as well. The async form finalizes to the same."""
    from isvins_tpu.posegraph import KeyframeDB as JDB
    from isvins_tpu.posegraph import optimize_pose_graph as j_opt
    from isvins_tpu.utils.checkpoint import save_pose_graph
    from isvins_tpu_torch.posegraph import optimize_pose_graph
    from isvins_tpu_torch.utils.checkpoint import load_pose_graph

    jdb = _drifted_loop_db(JDB)
    path = str(tmp_path / "pg.npz")
    save_pose_graph(jdb, path)
    db = load_pose_graph(path, device="cpu")
    assert db.n == jdb.n and db.K == jdb.K and db.vocab_frozen == jdb.vocab_frozen
    n = db.n
    out = optimize_pose_graph(db, 0, n - 1, iters=10, async_dispatch=async_dispatch)
    if async_dispatch:
        np.testing.assert_array_equal(db.opt_t[:n], db.vio_t[:n])  # nothing landed yet
        out = out.finalize()
    r_d, t_d, cost = out
    jr, jt, jcost = j_opt(jdb, 0, n - 1, iters=10)
    scale = lambda a: np.abs(a).max()
    for name in ("opt_t", "opt_q", "cov", "edge_dt", "edge_dq"):
        a, b = getattr(db, name)[:n], getattr(jdb, name)[:n]
        np.testing.assert_allclose(a, b, atol=1e-6 * scale(b), err_msg=name)
    np.testing.assert_allclose(r_d, jr, atol=1e-6)
    np.testing.assert_allclose(t_d, jt, atol=1e-6 * scale(jt))
    np.testing.assert_allclose(cost, jcost, rtol=1e-6)
    # the loop pulled the chain back: the reference test's own bound
    assert np.linalg.norm(db.opt_t[:n] - db.opt_t[0], axis=1).max() > 0
    assert np.linalg.eigvalsh(db.cov[1]).min() > -1e-9


def _loop_closure_inputs():
    """The inputs of tests/test_posegraph.py::test_builder_loop_closure_pipeline
    (:378-482), as numpy: config pieces, and per keyframe the packet
    fields, the exported points (vio frame) and the rendered image."""
    from scipy.ndimage import gaussian_filter

    from isvins_tpu_torch.geom.hostmath import (mat_to_quat_np, quat_conj_np, quat_mul_np,
                                                quat_normalize_np, quat_to_mat_np)

    H, W, f = 240, 320, 200.0
    R_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    rng = np.random.default_rng(2)
    M = 500
    th = rng.uniform(0, 2 * np.pi, M)
    rad = rng.uniform(7.0, 12.0, M)
    z = rng.uniform(-2.0, 2.5, M)
    landmarks = np.stack([rad * np.cos(th), rad * np.sin(th), z], axis=1)
    n_kf = 26
    ang = np.linspace(0, 2 * np.pi * 1.15, n_kf)
    t_gt = np.stack([5 * np.cos(ang), 5 * np.sin(ang), 0 * ang], axis=1)
    q_gt = np.stack([np.cos(ang / 2), 0 * ang, 0 * ang, np.sin(ang / 2)], axis=1)
    base = _texture(H, W, 11) * 0.06
    stamps = []
    for m in range(M):
        s = gaussian_filter(np.random.default_rng(1000 + m).uniform(0, 1, size=(25, 25)), 0.8)
        stamps.append((s - s.mean()) * 300.0)
    t_vio, q_vio = np.zeros_like(t_gt), np.zeros_like(q_gt)
    for k in range(n_kf):
        dy = 0.003 * k
        Rz = np.array([[np.cos(dy), -np.sin(dy), 0], [np.sin(dy), np.cos(dy), 0], [0, 0, 1]])
        t_vio[k] = Rz @ t_gt[k] + np.array([0.004, -0.002, 0]) * k
        q_vio[k] = quat_normalize_np(quat_mul_np(mat_to_quat_np(Rz), q_gt[k]))
    frames = []
    for k in range(n_kf - 1):
        Rc = quat_to_mat_np(q_gt[k]) @ R_bc
        pc = (Rc.T @ (landmarks - t_gt[k]).T).T
        uv = pc[:, :2] / pc[:, 2:3]
        px = uv * f + np.array([W / 2, H / 2])
        inb = ((pc[:, 2] > 1.0) & (px[:, 0] > 14) & (px[:, 0] < W - 14) & (px[:, 1] > 14)
               & (px[:, 1] < H - 14))
        img = base.copy()
        for m in np.where(inb)[0]:
            cx, cy = int(round(px[m, 0])), int(round(px[m, 1]))
            img[cy - 12:cy + 13, cx - 12:cx + 13] += stamps[m]
        img = np.clip(img + 120.0, 0, 255)
        rows = np.where(inb)[0][:200]
        Rz_k = quat_to_mat_np(q_vio[k]) @ quat_to_mat_np(q_gt[k]).T
        pts_w = (Rz_k @ (landmarks[rows] - t_gt[k]).T).T + t_vio[k]
        dt = quat_to_mat_np(q_vio[k]).T @ (t_vio[k + 1] - t_vio[k])
        dq = quat_normalize_np(quat_mul_np(quat_conj_np(q_vio[k]), q_vio[k + 1]))
        frames.append(dict(rel_dt=dt, rel_dq=dq, anchor_t=t_vio[k], anchor_q=q_vio[k],
                           ts=float(k), points_w=pts_w, pts_norm=uv[rows], ids=rows,
                           image=img))
    return frames, t_gt, t_vio


def _run_builder(pkg, frames):
    """Feed `frames` to package `pkg`'s PoseGraphBuilder (the reference
    test's config and camera)."""
    import importlib

    cfgm = importlib.import_module(f"{pkg}.config")
    pgm = importlib.import_module(f"{pkg}.posegraph")
    cam = importlib.import_module(f"{pkg}.frontend.camera")
    cfg = cfgm.euroc_config().replace(
        posegraph=cfgm.PoseGraphConfig(skip_recent=8, min_loop_matches=12, max_keyframes=64,
                                       max_kp_per_kf=256),
        tic=(0.0, 0.0, 0.0), ric=((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0)))
    camera = cam.PinholeRadtan.from_config(cfgm.CameraConfig(
        width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0,
        k1=0.0, k2=0.0, p1=0.0, p2=0.0))
    on_cpu = {"device": "cpu"} if pkg == "isvins_tpu_torch" else {}  # the JAX one has no such argument
    builder = pgm.PoseGraphBuilder(cfg, camera=camera, **on_cpu)
    _feed_builder(pkg, builder, frames)
    return builder


def _feed_builder(pkg, builder, frames):
    """Push `frames` (packet fields, exported points, image) into package
    `pkg`'s builder."""
    import importlib

    marg = importlib.import_module(f"{pkg}.estimator.marginalization")
    est = importlib.import_module(f"{pkg}.estimator.estimator")
    for fr in frames:
        pkt = marg.PoseGraphPacket(
            rel_dt=fr["rel_dt"], rel_dq=fr["rel_dq"], cov_rel=np.eye(6) * 1e-4,
            has_rollpitch=np.asarray(False), rp_q=np.array([1.0, 0, 0, 0]), cov_abs=np.eye(2),
            anchor_t=fr["anchor_t"], anchor_q=fr["anchor_q"], ts=np.asarray(fr["ts"]),
            distance=np.asarray(float(np.linalg.norm(fr["rel_dt"]))))
        kfp = est.KeyframePoints(ts=fr["ts"], points_w=fr["points_w"],
                                 pts_norm=fr["pts_norm"], ids=fr["ids"])
        builder.push(pkt, kfp, image=fr["image"])


def test_builder_matches_reference():
    """The whole builder on test_builder_loop_closure_pipeline's inputs,
    both packages: the same keyframes, the same retrieval path (K6's plain
    version on every query here: the vocabulary never freezes at 25
    keyframes), the same loop pairs, and trajectory() within 1e-4 m of the
    JAX builder's; the port alone meets the reference test's bounds."""
    frames, t_gt, t_vio = _loop_closure_inputs()
    ops.reset_launch_counts()
    tb = _run_builder("isvins_tpu_torch", frames)
    jb = _run_builder("isvins_tpu", frames)
    n = tb.db.n
    assert n == jb.db.n and n >= 24
    np.testing.assert_array_equal(tb.db.loop_idx[:n], jb.db.loop_idx[:n])
    assert tb.n_loops == jb.n_loops >= 1
    assert tb.db.match_count_queries == list(range(9, n))  # every query with hi > 0
    assert not tb.db.vocab_frozen
    assert ops.launch_counts()["retrieval_scores"] == 0  # CPU: the plain version
    ts, t_opt, q_opt = tb.trajectory()
    jts, jt_opt, jq_opt = jb.trajectory()
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_allclose(t_opt, jt_opt, atol=1e-4)
    np.testing.assert_allclose(q_opt, jq_opt, atol=1e-4)
    np.testing.assert_allclose(tb.db.loop_weight[:n], jb.db.loop_weight[:n], rtol=1e-3)
    err_vio = np.linalg.norm(t_vio[:n] - t_gt[:n], axis=1)[-3:].mean()
    err_opt = np.linalg.norm(t_opt - t_gt[:n], axis=1)[-3:].mean()
    assert err_opt < 0.7 * err_vio, (err_vio, err_opt)
    _, _, cov = tb.covariances()
    assert np.isfinite(cov).all()
    assert tb.n_async_dispatches == tb.n_async_collects == tb.n_async_landed >= 1


def _stitch_inputs():
    """The inputs of tests/test_posegraph.py::test_builder_two_sequence_stitching
    (:234-347), as numpy: two legs of packets, each with the keyframe's
    exported points (in its sequence's vio frame) and the image rendered
    from its world pose. Leg 1 tours the full circle in the world frame;
    leg 2 restarts in its own vio frame (a yaw and translation offset from
    the world) and revisits the start. Returns (leg1, leg2, t2_w)."""
    from scipy.ndimage import gaussian_filter

    from isvins_tpu_torch.geom.hostmath import (mat_to_quat_np, quat_conj_np, quat_mul_np,
                                                quat_normalize_np, quat_to_mat_np)

    H, W, f = 240, 320, 200.0
    R_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    rng = np.random.default_rng(2)
    M = 500
    th = rng.uniform(0, 2 * np.pi, M)
    rad = rng.uniform(7.0, 12.0, M)
    z = rng.uniform(-2.0, 2.5, M)
    landmarks = np.stack([rad * np.cos(th), rad * np.sin(th), z], axis=1)
    base = _texture(H, W, 11) * 0.06
    stamps = []
    for m in range(M):
        s = gaussian_filter(np.random.default_rng(1000 + m).uniform(0, 1, size=(25, 25)), 0.8)
        stamps.append((s - s.mean()) * 300.0)

    def leg(t_vio, q_vio, ts0, offset=None):
        frames = []
        for k in range(len(t_vio) - 1):
            if offset is None:
                t_w, q_w = t_vio[k], q_vio[k]
            else:
                R_off, t_off = offset
                t_w = R_off @ t_vio[k] + t_off
                q_w = quat_normalize_np(quat_mul_np(mat_to_quat_np(R_off), q_vio[k]))
            Rc = quat_to_mat_np(q_w) @ R_bc
            pc = (Rc.T @ (landmarks - t_w).T).T
            uv = pc[:, :2] / pc[:, 2:3]
            px = uv * f + np.array([W / 2, H / 2])
            inb = ((pc[:, 2] > 1.0) & (px[:, 0] > 14) & (px[:, 0] < W - 14) & (px[:, 1] > 14)
                   & (px[:, 1] < H - 14))
            img = base.copy()
            for m in np.where(inb)[0]:
                cx, cy = int(round(px[m, 0])), int(round(px[m, 1]))
                img[cy - 12:cy + 13, cx - 12:cx + 13] += stamps[m]
            img = np.clip(img + 120.0, 0, 255)
            rows = np.where(inb)[0][:200]
            pts_w = landmarks[rows]
            if offset is not None:
                pts_w = (offset[0].T @ (pts_w - offset[1]).T).T
            dt = quat_to_mat_np(q_vio[k]).T @ (t_vio[k + 1] - t_vio[k])
            dq = quat_normalize_np(quat_mul_np(quat_conj_np(q_vio[k]), q_vio[k + 1]))
            frames.append(dict(rel_dt=dt, rel_dq=dq, anchor_t=t_vio[k], anchor_q=q_vio[k],
                               ts=ts0 + float(k), points_w=pts_w, pts_norm=uv[rows], ids=rows,
                               image=img))
        return frames

    circle = lambda ang: (np.stack([5 * np.cos(ang), 5 * np.sin(ang), 0 * ang], axis=1),
                          np.stack([np.cos(ang / 2), 0 * ang, 0 * ang, np.sin(ang / 2)], axis=1))
    t1, q1 = circle(np.linspace(0, 2 * np.pi, 21))
    psi = 0.35
    R_off = np.array([[np.cos(psi), -np.sin(psi), 0], [np.sin(psi), np.cos(psi), 0], [0, 0, 1]])
    t_off = np.array([1.4, -0.9, 0.3])
    t2_w, q2_w = circle(np.linspace(0.05 * np.pi, 0.55 * np.pi, 8))
    t2_v = (R_off.T @ (t2_w - t_off).T).T
    q2_v = np.stack([quat_normalize_np(quat_mul_np(mat_to_quat_np(R_off.T), q)) for q in q2_w])
    return leg(t1, q1, 0.0), leg(t2_v, q2_v, 100.0, offset=(R_off, t_off)), t2_w


def test_builder_two_sequence_stitching_matches_reference():
    """The multi-session stitch, both builders on the same drive
    (test_posegraph.py::test_builder_two_sequence_stitching's inputs): leg
    1, new_sequence(), leg 2; the first inter-sequence loop sets (w_r_vio,
    w_t_vio) and moves sequence 2 onto sequence 1's world. The same
    keyframes, loops, sequence alignments and loop_idx, and the builders'
    `vio_t` and trajectory() within 1e-12 m (both do the alignment's f64
    host algebra; measured ~6e-15 m); the port alone meets the reference
    test's own bounds (sequence 1 untouched, sequence 2 within 0.3 m of
    the world)."""
    leg1, leg2, t2_w = _stitch_inputs()
    builders = []
    for pkg in ("isvins_tpu_torch", "isvins_tpu"):
        b = _run_builder(pkg, leg1)
        n_seq1, seq1_vio_t = b.db.n, b.db.vio_t[:b.db.n].copy()
        b.new_sequence()
        _feed_builder(pkg, b, leg2)
        builders.append((b, n_seq1, seq1_vio_t))
    (tb, n1, seq1), (jb, jn1, _) = builders
    n = tb.db.n
    assert n == jb.db.n and n1 == jn1 >= 19
    assert tb.sequence == jb.sequence == 2
    assert int(tb.db.seq[n1]) == 2 and int(tb.db.seq[0]) == 1
    assert tb.n_loops == jb.n_loops >= 1
    assert tb.n_sequence_aligns == jb.n_sequence_aligns == 1 and tb.sequence_loop[2] is True
    np.testing.assert_array_equal(tb.db.loop_idx[:n], jb.db.loop_idx[:n])
    np.testing.assert_array_equal(tb.db.seq[:n], jb.db.seq[:n])
    np.testing.assert_allclose(tb.w_r_vio, jb.w_r_vio, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tb.w_t_vio, jb.w_t_vio, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tb.db.vio_t[:n], jb.db.vio_t[:n], rtol=0, atol=1e-12)
    ts, t_opt, q_opt = tb.trajectory()
    jts, jt_opt, jq_opt = jb.trajectory()
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_allclose(t_opt, jt_opt, rtol=0, atol=1e-12)
    np.testing.assert_allclose(q_opt, jq_opt, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tb.db.vio_t[:n1], seq1, rtol=0, atol=1e-12)
    err = np.linalg.norm(tb.db.vio_t[n1:n] - t2_w[: n - n1], axis=1)
    assert err.max() < 0.3, err


@pytest.mark.parametrize("with_camera_model", [False, True])
def test_room_renderer_matches_reference(with_camera_model):
    """RoomRenderer (numpy) renders the same image and projections as the
    JAX package's, with and without a distortion-aware camera model."""
    from isvins_tpu.config import CameraConfig
    from isvins_tpu.frontend.camera import make_camera as j_make
    from isvins_tpu.utils.synthetic import RoomRenderer as JRenderer
    from isvins_tpu.utils.synthetic import make_world as j_world
    from isvins_tpu_torch.frontend.camera import make_camera
    from isvins_tpu_torch.utils.synthetic import RoomRenderer, make_world

    cam = CameraConfig(width=96, height=72, fx=60.0, fy=60.0, cx=48.0, cy=36.0,
                       k1=-0.1, k2=0.01, p1=1e-4, p2=-1e-4)
    qic = np.array([0.5, -0.5, 0.5, -0.5])
    world, jworld = (f(n_frames=4, n_landmarks=50, seed=1) for f in (make_world, j_world))
    r = RoomRenderer(world, cam, np.zeros(3), qic,
                     camera_model=make_camera(cam) if with_camera_model else None)
    jr = JRenderer(jworld, cam, np.zeros(3), qic,
                   camera_model=j_make(cam) if with_camera_model else None)
    for k in (0, 3):
        for a, b in zip(r.render(k), jr.render(k)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 if with_camera_model else 0)


def test_keyframe_db_grow_and_query_mirror(tmp_path):
    """The device mirror of the retrieval subsample follows `add` and
    `_grow` (capacity 4 -> 8 -> 16), a pre-freeze query scores rows
    [0, hi) exactly as K6's plain version on the host arrays, and
    load_pose_graph restores the mirror from a JAX snapshot."""
    from isvins_tpu.posegraph import KeyframeDB as JDB
    from isvins_tpu.utils.checkpoint import save_pose_graph
    from isvins_tpu_torch.posegraph import KeyframeDB
    from isvins_tpu_torch.utils.checkpoint import load_pose_graph

    rng = np.random.default_rng(4)
    db, jdb = KeyframeDB(4, 80, 8, device="cpu"), JDB(4, 80, 8)
    base = rng.integers(0, 2**32, size=(80, 8), dtype=np.uint32)
    for i in range(11):
        kp = base.copy() if i % 3 == 0 else rng.integers(0, 2**32, size=(80, 8), dtype=np.uint32)
        valid = rng.random(80) > 0.2
        for d in (db, jdb):
            d.add(ts=float(i), kp_desc=kp, kp_valid=valid)
    assert db.K == 16 and db.ret_desc_dev.shape == (16, 64, 8)
    np.testing.assert_array_equal(db.ret_desc_dev.numpy().view(np.uint32), db.ret_desc)
    np.testing.assert_array_equal(db.ret_valid_dev.numpy(), db.ret_valid)
    np.testing.assert_array_equal(db.ret_desc, jdb.ret_desc[:16])
    for idx, skip in ((10, 2), (9, 1), (3, 5)):
        assert db.query(idx, skip_recent=skip) == jdb.query(idx, skip_recent=skip)
    assert db.query(9, skip_recent=1)[0] in (0, 3, 6)  # the planted duplicates rank first
    assert db.match_count_queries == [10, 9, 9]  # (3, 5) has hi <= 0: nothing to score
    path = str(tmp_path / "db.npz")
    save_pose_graph(jdb, path)
    loaded = load_pose_graph(path, capacity=32, device="cpu")
    assert loaded.K == 32 and loaded.n == 11
    np.testing.assert_array_equal(loaded.ret_desc_dev[:11].numpy().view(np.uint32),
                                  jdb.ret_desc[:11])
    assert loaded.query(10, skip_recent=2) == db.query(10, skip_recent=2)


@pytest.mark.parametrize("K", [1, 2, 129])
def test_retrieval_scores_edge_cases_vs_reference(K):
    """K6's plain version on utils.synthetic.make_retrieval_cases (near
    duplicates at thresholds 40 and 33, thresh 0, 257 and 600, random rows
    at 109, invalid database rows and a whole invalid keyframe, every query
    row invalid: the denominator is 1) against the JAX retrieval_scores_ref,
    retrieval_scores_pallas in interpret mode and the JAX CPU path
    (keyframe_db._retrieval_scores), exactly. K: one keyframe (one block of
    the kernel), two, and 129 (past a power of two)."""
    from isvins_tpu.ops.hamming_pallas import retrieval_scores_pallas, retrieval_scores_ref
    from isvins_tpu.posegraph.keyframe_db import _retrieval_scores

    from isvins_tpu_torch.utils.synthetic import make_retrieval_cases

    seen = set()
    for name, (qd, qv, dbd, dbv), thresh in make_retrieval_cases(K):
        out = ops.retrieval_scores_ref(I32(qd), T(qv), I32(dbd), T(dbv), thresh).numpy()
        j = [jnp.asarray(a) for a in (qd, qv, dbd, dbv)]
        for ref in (retrieval_scores_ref(*j, thresh), retrieval_scores_pallas(*j, thresh)):
            np.testing.assert_array_equal(out, np.asarray(ref), err_msg=f"{name} {thresh}")
        np.testing.assert_array_equal(out, np.asarray(_retrieval_scores(*j, thresh), np.float32))
        if thresh == 0 or name == "query invalid":
            assert not out.any()
        if thresh == 600:  # above an invalid row's 512: every valid query row hits
            np.testing.assert_array_equal(out, np.ones(K, np.float32))
        seen.add((name, thresh))
    assert len(seen) == 7
