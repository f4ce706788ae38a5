"""Loop-closure retrieval recall and precision (port of retrieval_bench.py).

    python -m isvins_tpu_torch.retrieval_bench [--keyframes 500] [--device cpu] [--out PATH]

Sweeps a many-keyframe textured synthetic world (RoomRenderer, keyframes
about 0.3 m apart on an r = 3 m circle, about 63 a lap, so every lap
revisits every view) through the keyframe database's retrieval path and
reports, against the renderer's ground truth:

  - retrieval recall@4: the share of queries with a true revisit (an older
    keyframe within 1 m and 30 degrees of yaw of the query's ground-truth
    pose) whose candidates hold at least one true one;
  - retrieval precision: the share of candidates that are true;
  - verified recall and precision: after the PnP-RANSAC geometric
    verification of PoseGraphBuilder._find_connection, a fired loop is
    good when its measured relative pose is within 0.3 m and 5 degrees of
    ground truth's.

Prints one JSON line with RETRIEVAL_r05.json's nine fields (unrounded),
`match_count_queries` (the queries scored by K6 before the vocabulary
froze: 0 when it freezes at the 49th keyframe and the first query is at
51), and the seconds of the build and the evaluation. The corner
detection and BRIEF run on the device (the CUDA card unless `--device
cpu`); the database's retrieval is host tf-idf once the vocabulary is
frozen. Writes a file only at `--out`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
H, W, FOCAL = 240, 320, 200.0


def ray_wall_depth(renderer, C_w, dirs_w):
    """Depth along each ray (n, 3) from the camera center C_w to the nearest
    wall (the renderer's exact geometry: the ground-truth 3D of detected
    keypoints)."""
    t_best = np.full(len(dirs_w), np.inf)
    for m in range(len(renderer.centers)):
        nrm = renderer.normals[m]
        denom = dirs_w @ nrm
        num = (renderer.centers[m] - C_w) @ nrm
        with np.errstate(divide="ignore", invalid="ignore"):
            t = num / denom
        rel = C_w + t[:, None] * dirs_w - renderer.centers[m]
        a = rel @ renderer.u_axes[m]
        b = rel @ renderer.v_axes[m]
        hit = ((denom < -1e-9) & (t > 1e-6) & (t < t_best)
               & (np.abs(a) <= renderer.half_u) & (np.abs(b) <= renderer.half_v))
        t_best = np.where(hit, t, t_best)
    return t_best


def retrieval_world(n_kf: int, seed: int = 4):
    """retrieval_bench.py:66-77's world (n_kf frames at 6 Hz: 1.8 m/s over
    0.3 m) and RoomRenderer (textures seeded seed + 1): (world, renderer)."""
    from .config import CameraConfig
    from .geom.hostmath import mat_to_quat_np
    from .utils.synthetic import RoomRenderer, make_world

    cam = CameraConfig(width=W, height=H, fx=FOCAL, fy=FOCAL, cx=W / 2, cy=H / 2,
                       k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    world = make_world(n_frames=n_kf, frame_hz=6.0, imu_hz=60.0, n_landmarks=10, seed=seed,
                       traj_r=3.0, traj_w=0.6)
    return world, RoomRenderer(world, cam, np.zeros(3), mat_to_quat_np(R_BC), seed=seed + 1)


def build_db(n_kf: int, seed: int = 4, device=None, frames=None):
    """retrieval_bench.py:62-140: one keyframe per frame of retrieval_world,
    with up to max_kp_per_kf Shi-Tomasi corners (NMS radius 10, border 14)
    and their BRIEF descriptors computed on `device`, the strongest
    detections' ground-truth 3D by ray casting as the window points, and the
    ground-truth pose. `frames`: the world's rendered frames (rendered here
    when None). Returns (db, gt_t, gt_yaw, world, R_bc)."""
    import torch

    from .config import PoseGraphConfig
    from .device import resolve_device
    from .frontend.image_ops import nms_topk, shi_tomasi_response
    from .geom.hostmath import mat_to_ypr_np, quat_to_mat_np
    from .posegraph.brief import brief_descriptors, make_brief_pattern
    from .posegraph.keyframe_db import KeyframeDB

    dev = resolve_device(device)
    world, renderer = retrieval_world(n_kf, seed)
    pg = PoseGraphConfig()
    db = KeyframeDB(max(n_kf, 128), pg.max_kp_per_kf, 256, device=dev)
    pattern = make_brief_pattern(pg.brief_bits)
    Kinv = np.linalg.inv(np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]]))
    gt_t = np.zeros((n_kf, 3))
    gt_yaw = np.zeros(n_kf)
    t0 = time.time()
    for k in range(n_kf):
        img = renderer.render(k)[0] if frames is None else frames[k]
        imgt = torch.as_tensor(np.asarray(img, np.float32), device=dev)
        cand_t, _, _ = nms_topk(shi_tomasi_response(imgt), db.D, 10, border=14)
        desc = brief_descriptors(imgt, cand_t, torch.ones(len(cand_t), dtype=torch.bool,
                                                          device=dev), pattern)
        cand = cand_t.cpu().numpy()
        desc = desc.cpu().numpy().view(np.uint32)
        kp_norm = (np.concatenate([cand, np.ones((len(cand), 1))], 1) @ Kinv.T)[:, :2]

        # the camera's ground-truth world pose
        R_wb = quat_to_mat_np(np.asarray(world.Q[k]))
        R_wc = R_wb @ R_BC
        C_w = world.P[k]
        gt_t[k] = C_w
        gt_yaw[k] = mat_to_ypr_np(R_wb)[0]

        # window points: the ground-truth 3D of the strongest detections
        P = db.P
        n_w = min(len(cand), P)
        dirs_w = np.concatenate([kp_norm[:n_w], np.ones((n_w, 1))], axis=1) @ R_wc.T
        depth = ray_wall_depth(renderer, C_w, dirs_w)
        okd = np.isfinite(depth)
        pts_w = C_w + depth[:, None] * dirs_w

        kp_desc = np.zeros((db.D, 8), np.uint32)
        kp_normf = np.zeros((db.D, 2))
        kp_valid = np.zeros(db.D, bool)
        kp_desc[: len(cand)] = desc
        kp_normf[: len(cand)] = kp_norm
        kp_valid[: len(cand)] = True
        win_desc = np.zeros((P, 8), np.uint32)
        win_valid = np.zeros(P, bool)
        win_pts3d = np.zeros((P, 3))
        win_desc[:n_w] = desc[:n_w]
        win_valid[:n_w] = okd[:n_w]
        win_pts3d[:n_w] = np.where(okd[:n_w, None], pts_w[:n_w], 0.0)
        db.add(ts=float(world.frame_times[k]), seq=1, vio_t=world.P[k], vio_q=world.Q[k],
               opt_t=world.P[k], opt_q=world.Q[k], kp_desc=kp_desc, kp_norm=kp_normf,
               kp_valid=kp_valid, win_desc=win_desc, win_valid=win_valid, win_pts3d=win_pts3d)
        if (k + 1) % 100 == 0:
            print(f"# built {k + 1}/{n_kf} keyframes ({time.time() - t0:.0f}s)",
                  file=sys.stderr, flush=True)
    return db, gt_t, gt_yaw, world, R_BC


def evaluate(db, gt_t, gt_yaw, cfg_pg, dist_gate=1.0, yaw_gate=30.0, rel_t_gate=0.3,
             rel_yaw_gate=5.0):
    """retrieval_bench.py:143-204. Retrieval truth: an older keyframe within
    (dist_gate, yaw_gate) of the query's ground-truth pose. Verified-loop
    truth: the measured loop relative pose (loop_dt, loop_dq) within
    (rel_t_gate, rel_yaw_gate) of ground truth's. Returns the counts, the
    relative-pose errors of the fired loops, and the wall time of each
    _find_connection call (ms), which runs on the database's device."""
    from .config import euroc_config
    from .geom.hostmath import mat_to_ypr_np, quat_to_mat_np
    from .posegraph.builder import PoseGraphBuilder

    skip = cfg_pg.skip_recent
    stats = dict(q_with_truth=0, q_recall_hits=0, cand_total=0, cand_true=0,
                 ver_fired=0, ver_true=0, q_ver_hits=0, rel_errs=[], find_connection_ms=[])
    # a builder shell for _find_connection (no camera: normalized points)
    shell = PoseGraphBuilder.__new__(PoseGraphBuilder)
    shell.cfg = euroc_config().replace(posegraph=cfg_pg, tic=(0.0, 0.0, 0.0),
                                       ric=tuple(map(tuple, R_BC)))
    shell.pg = cfg_pg
    shell.db = db
    shell.device = db.device
    for idx in range(skip + 1, db.n):
        hi = idx - skip
        d = np.linalg.norm(gt_t[:hi] - gt_t[idx], axis=1)
        dy = np.abs((gt_yaw[:hi] - gt_yaw[idx] + 180) % 360 - 180)
        truth = (d < dist_gate) & (dy < yaw_gate)
        cands = db.query(idx, skip, cfg_pg.top_k, match_thresh=cfg_pg.retrieval_match_thresh,
                         abs_frac=cfg_pg.retrieval_abs_frac)
        if truth.any():
            stats["q_with_truth"] += 1
            if any(truth[c] for c in cands):
                stats["q_recall_hits"] += 1
        stats["cand_total"] += len(cands)
        stats["cand_true"] += int(sum(bool(truth[c]) for c in cands))
        fired = -1
        for c in cands:
            t0 = time.perf_counter()
            ok = shell._find_connection(idx, c)
            stats["find_connection_ms"].append((time.perf_counter() - t0) * 1e3)
            if ok:
                fired = c
                break
        if fired < 0:
            continue
        stats["ver_fired"] += 1
        R_old = quat_to_mat_np(db.vio_q[fired])
        rel_t_gt = R_old.T @ (gt_t[idx] - gt_t[fired])
        e_t = np.linalg.norm(db.loop_dt[idx] - rel_t_gt)
        yaw_meas = mat_to_ypr_np(quat_to_mat_np(db.loop_dq[idx]))[0]
        e_y = abs((yaw_meas - (gt_yaw[idx] - gt_yaw[fired]) + 180.0) % 360.0 - 180.0)
        stats["rel_errs"].append((e_t, e_y))
        good_loop = e_t < rel_t_gate and e_y < rel_yaw_gate
        stats["ver_true"] += int(good_loop)
        stats["q_ver_hits"] += int(truth.any() and good_loop)
    return stats


def summarize(st, n_keyframes: int) -> dict:
    """retrieval_bench.py:211-229's nine fields, unrounded."""
    errs = np.array(st["rel_errs"]) if st["rel_errs"] else np.zeros((0, 2))
    q = max(st["q_with_truth"], 1)
    return {
        "keyframes": int(n_keyframes), "queries_with_truth": st["q_with_truth"],
        "retrieval_recall_at_4": st["q_recall_hits"] / q,
        "retrieval_precision": st["cand_true"] / max(st["cand_total"], 1),
        "verified_loop_recall": st["q_ver_hits"] / q,
        "verified_loop_precision": st["ver_true"] / max(st["ver_fired"], 1),
        "loops_fired": st["ver_fired"],
        "loop_rel_t_err_median_m": float(np.median(errs[:, 0])) if len(errs) else None,
        "loop_rel_yaw_err_median_deg": float(np.median(errs[:, 1])) if len(errs) else None,
    }


def main(argv=None):
    from .config import PoseGraphConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keyframes", type=int, default=500)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="also write the JSON object to this path")
    args = ap.parse_args(argv)
    pg = PoseGraphConfig(skip_recent=50, min_loop_matches=15)
    t0 = time.perf_counter()
    db, gt_t, gt_yaw, _, _ = build_db(args.keyframes, device=args.device)
    t1 = time.perf_counter()
    st = evaluate(db, gt_t, gt_yaw, pg)
    t2 = time.perf_counter()
    out = {**summarize(st, db.n), "match_count_queries": len(db.match_count_queries),
           "build_s": t1 - t0, "evaluate_s": t2 - t1,
           "find_connection_median_ms": float(np.median(st["find_connection_ms"]))
           if st["find_connection_ms"] else None, "device": str(db.device)}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
