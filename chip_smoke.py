#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (isvins_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:
  1. device  — the card's name and power limit (nvidia-smi); no CUDA -> exit 2
  2. build   — compile csrc/*.cu (nvcc, sm_90a) into build/kernels/
  3. kernels — K1-K4 and K6 against their plain PyTorch versions at the
               product shapes, with the reference tests' tolerances (K6
               exact, at K = 23, the posegraph path's largest, and at 1,
               256 and 4096); CUDA-event times
  4. solve   — solve_window on make_batch_problem(1, (18, 8, 1000, 3072)),
               10 LM iterations, f32: vio_window_solve_frames_per_s and the
               launch counts of K1-K4 against the builds/iterations it ran
  5. slice   — the Estimator on a synthetic world at the EuRoC window
               (18/8/1000, N=3072): steady frames through K1-K4, ATE
               against ground truth
  6. posegraph — the estimator's steady frames feeding the PoseGraphBuilder
               at bench.py's e2e configuration with loops on (320x240
               rendered room, 130 frames, 1.34 laps): keyframes, BRIEF,
               retrieval through K6 until the vocabulary freezes, PnP loop
               verification, the async dense optimization with covariance;
               loop-closed keyframe ATE against ground truth; every K6
               query of the drive replayed against the plain version, and
               the last card (f32) pose-graph solve against the same solve
               on the CPU in f64
Each path's launch counts are set to 0 just before it and read just after.
Second-to-last line: one JSON object with the per-kernel records (launches
from the posegraph path, which runs all five kernels); last line:
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

KERNEL_META = {
    "proj_rows": ("isvins_tpu_torch/csrc/proj_rows.cu", "isvins_tpu/ops/proj_pallas.py:214"),
    "imu_rows": ("isvins_tpu_torch/csrc/imu_rows.cu", "isvins_tpu/ops/imu_pallas.py:352"),
    "schur_corr": ("isvins_tpu_torch/csrc/schur_corr.cu", "isvins_tpu/ops/schur_pallas.py:118"),
    "linstep": ("isvins_tpu_torch/csrc/linstep.cu", "isvins_tpu/ops/linstep_pallas.py:481"),
    "retrieval_scores": ("isvins_tpu_torch/csrc/hamming.cu",
                         "isvins_tpu/ops/hamming_pallas.py:122"),
}


def phase_device():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[device] torch.cuda.is_available() is False: nothing to run on")
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print("[device] nvidia-smi:", smi.stdout.strip())
    from isvins_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    print(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} numpy={np.__version__}")
    return dev, smi.stdout.strip()


def phase_build():
    from isvins_tpu_torch.ops import _lib

    t0 = time.perf_counter()
    _lib.lib()
    info = _lib.build_info
    print(f"[build] {info['path']} nvcc {info.get('seconds', 0.0):.2f} s "
          f"(load total {time.perf_counter() - t0:.2f} s)")
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("[build] ptxas:", line.strip())


def cuda_ms(fn, reps=100, warmup=10):
    """Mean device time of fn() over `reps` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_inputs(dev, seed=0):
    """Seeded inputs for K1-K4 at the product shapes (B=18, N=3072, n=17,
    F=1000, Dr=114, D=276), built as the reference's kernel tests build them
    (tests/test_pallas_ops.py)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    B, N, F = 18, 3072, 1000
    n_pose, D = 6 * B, 15 * B + 6
    Dr = n_pose + 6

    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    P = rng.normal(size=(B, 3)) * 2.0
    idx_i = rng.integers(0, B, N)
    idx_j = rng.integers(0, B, N)
    pts_i = np.concatenate([rng.normal(size=(N, 2)) * 0.3, np.ones((N, 1))], 1)
    pts_j = np.concatenate([rng.normal(size=(N, 2)) * 0.3, np.ones((N, 1))], 1)
    qic = np.array([0.99, 0.05, -0.08, 0.03])
    qic /= np.linalg.norm(qic)
    proj = (f32(pts_i), f32(pts_j), f32(P[idx_i]), f32(q[idx_i]), f32(P[idx_j]),
            f32(q[idx_j]), f32([0.02, -0.01, 0.015]), f32(qic),
            f32(np.abs(rng.normal(size=N)) * 4.0 + 0.5),
            torch.as_tensor(rng.random(N) > 0.15, device=dev))

    # IMU factors from a real preintegration of the port's batch problem
    from isvins_tpu_torch.parallel.sharded import make_batch_problem
    from isvins_tpu_torch.solver import WindowDims

    state, imu, *_ = make_batch_problem(1, WindowDims(B, 8, F, N), torch.float32,
                                        device=dev, seed=seed)
    st = [getattr(state, k)[0] for k in ("P", "Q", "V", "Ba", "Bg")]
    st[3] = st[3] + f32(rng.normal(size=(B, 3)) * 0.02)  # off-linearization biases
    st[4] = st[4] + f32(rng.normal(size=(B, 3)) * 0.002)
    pre = imu.pre
    imu_args = tuple(a.contiguous() for a in (
        *(a[:-1] for a in st), *(a[1:] for a in st),
        pre.delta_p[0], pre.delta_q[0], pre.delta_v[0], pre.sum_dt[0], pre.ba[0], pre.bg[0],
        pre.jac[0], f32([0.0, 0.0, 9.81])))

    W = rng.normal(size=(F, Dr))
    h = np.abs(rng.normal(size=F)) * 5 + 0.5
    bl = rng.normal(size=F)
    schur = (f32(W), f32(h), f32(bl))

    # SPD construction of tests/test_pallas_ops.py:130-150
    A = rng.normal(size=(D, D + 60))
    H = A @ A.T + 200 * np.eye(D)
    Wf, hf = W.astype(np.float32), h.astype(np.float32)
    C = (Wf / hf[:, None]).T @ Wf
    ex0 = D - 6
    H[:n_pose, :n_pose] += C[:n_pose, :n_pose]
    H[:n_pose, ex0:] += C[:n_pose, n_pose:]
    H[ex0:, :n_pose] += C[n_pose:, :n_pose]
    H[ex0:, ex0:] += C[n_pose:, n_pose:]
    lin = (f32(H), f32(rng.normal(size=D)), f32(W), f32(h), f32(bl),
           torch.tensor(1e-3, dtype=torch.float32, device=dev), n_pose)
    return {"proj_rows": proj, "imu_rows": imu_args, "schur_corr": schur, "linstep": lin,
            "retrieval_scores": retrieval_inputs(dev, 23, seed)}


def retrieval_inputs(dev, K, seed=0, thresh=40):
    """K6 inputs on the card: the first K keyframes of
    utils.synthetic.make_retrieval_db (planted duplicates of the query at
    keyframes 3 and 17 when K >= 18), R = 64 descriptors per keyframe,
    thresh = 40 as in the pose graph. K = 1..23 are the posegraph path's
    shapes (skip_recent = 25, the vocabulary freezes at keyframe 48)."""
    import numpy as np
    import torch

    from isvins_tpu_torch.utils.synthetic import make_retrieval_db

    qd, qv, dbd, dbv = make_retrieval_db(max(K, 18), seed=seed)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return t(qd.view(np.int32)), t(qv), t(dbd[:K].view(np.int32)), t(dbv[:K]), thresh


def _max_err(out, ref):
    return max(float((o - r).abs().max()) for o, r in zip(out, ref))


def _assert_close(name, out, ref, rtol, atol_fn):
    for k, (o, r) in enumerate(zip(out, ref)):
        atol = atol_fn(r)
        bad = ~((o - r).abs() <= atol + rtol * r.abs())
        if bool(bad.any()):
            raise AssertionError(
                f"{name} output {k}: {int(bad.sum())} entries outside rtol={rtol} "
                f"atol={atol:.3g}; max abs err {float((o - r).abs().max()):.3g}")


def phase_kernels(dev):
    """Each kernel against its plain version on the same card inputs."""
    import torch

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.solver.proj_fast import eval_proj_rows

    inp = kernel_inputs(dev)
    H, b, W, h, bl, lam, n_pose = inp["linstep"]
    D = H.shape[0]
    # (kernel, plain, args, rtol, atol(ref)) — the reference kernel tests'
    # tolerances (tests/test_pallas_ops.py)
    cases = {
        "proj_rows": (ops.proj_rows, eval_proj_rows, inp["proj_rows"],
                      3e-4, lambda r: 1e-4),
        "imu_rows": (ops.imu_rows, ops.imu_rows_ref, inp["imu_rows"],
                     1e-5, lambda r: 2e-6 * float(r.abs().max())),
        "schur_corr": (ops.schur_corr, ops.schur_corr_ref, inp["schur_corr"],
                       2e-5, lambda r: 2e-3),
        "linstep": (lambda *a: ops.linstep(*a),
                    lambda *a: ops.linstep_ref(*a, D),
                    inp["linstep"], 2e-3, lambda r: 2e-3 * float(r.abs().max())),
        # K6 is integer work up to one IEEE division: exact
        "retrieval_scores": (lambda *a: (ops.retrieval_scores(*a),),
                             lambda *a: (ops.retrieval_scores_ref(*a),),
                             inp["retrieval_scores"], 0.0, lambda r: 0.0),
    }
    records = {}
    for name, (kern, plain, args, rtol, atol_fn) in cases.items():
        out = kern(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        torch.cuda.synchronize()
        _assert_close(name, out, ref, rtol, atol_fn)
        err = _max_err(out, ref)
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        records[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(f"[kernels] {name}: max_abs_err={err:.3g} kernel {ms * 1e3:.2f} us "
              f"plain {plain_ms * 1e3:.2f} us (rtol {rtol})")
    # K6 (above at K = 23) also at one keyframe (the path's first query, a
    # one-block grid), the slice's capacity and the default one
    # (PoseGraphConfig.max_keyframes)
    for K in (1, 256, 4096):
        args = retrieval_inputs(dev, K)
        out, ref = ops.retrieval_scores(*args), ops.retrieval_scores_ref(*args)
        torch.cuda.synchronize()
        if not torch.equal(out, ref) or (K >= 18 and not float(ref[3]) > 0.9):
            raise AssertionError(f"retrieval_scores at K={K}: max abs err "
                                 f"{float((out - ref).abs().max()):.3g}")
        ms = cuda_ms(lambda: ops.retrieval_scores(*args))
        plain_ms = cuda_ms(lambda: ops.retrieval_scores_ref(*args), reps=20)
        print(f"[kernels] retrieval_scores K={K}: max_abs_err=0 kernel {ms * 1e3:.2f} us "
              f"plain {plain_ms * 1e3:.2f} us (exact)")
    return records


def _squeeze(tree):
    if isinstance(tree, tuple):
        return type(tree)(*(_squeeze(x) for x in tree))
    return tree[0].contiguous()


def phase_solve(dev):
    """solve_window at the product window, through K1, K2 and K4 (+K3)."""
    import numpy as np
    import torch

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.parallel.sharded import make_batch_problem
    from isvins_tpu_torch.solver import WindowDims, solve_window

    dims = WindowDims(18, 8, 1000, 3072)
    prob = make_batch_problem(1, dims, torch.float32, device=dev)
    args = [_squeeze(x) for x in prob[:4]] + list(prob[4:])
    solve_window(*args, dims, iters=10)  # warm-up
    ops.reset_launch_counts()
    info = {}
    st, cost = solve_window(*args, dims, iters=10, info=info)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    it = info["iterations"]
    expect = {"proj_rows": it + 1, "imu_rows": it + 1, "schur_corr": it, "linstep": it,
              "retrieval_scores": 0}
    print(f"[solve] iterations={it} cost={float(cost):.6g} launches={counts} expected={expect}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    if not all(bool(torch.isfinite(a).all()) for a in st) or not np.isfinite(float(cost)):
        raise AssertionError("non-finite solve output")
    # the same problem through the plain versions (CPU, f32). The random
    # bench problem is weakly constrained along some pose directions, and
    # after 10 un-converged f32 LM iterations the two paths (different
    # summation orders) sit at different points of the same valley: the
    # cost must agree to 1e-3 relative; the state gap is reported
    cost0 = float(solve_window(*args, dims, iters=0)[1])
    cpu = [x for x in make_batch_problem(1, dims, torch.float32, device="cpu")]
    cpu_args = [_squeeze(x) for x in cpu[:4]] + cpu[4:]
    st_c, cost_c = solve_window(*cpu_args, dims, iters=10)
    rel = abs(float(cost) - float(cost_c)) / float(cost_c)
    dP = float((st.P.cpu() - st_c.P).abs().max())
    print(f"[solve] initial cost={cost0:.6g}; plain-version solve (CPU f32): "
          f"cost={float(cost_c):.6g} rel diff={rel:.3g} max|dP|={dP:.3g} m")
    if not (rel < 1e-3 and float(cost) < cost0):
        raise AssertionError(f"kernel solve disagrees with the plain solve: {rel}")
    times = []
    for _ in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve_window(*args, dims, iters=10)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    print(f"[solve] median {med * 1e3:.3f} ms over 30 solves; "
          f"vio_window_solve_frames_per_s={1.0 / med:.2f}")
    return {"vio_window_solve_frames_per_s": 1.0 / med, "solve_median_ms": med * 1e3}


def phase_slice(dev, n_frames=60, n_landmarks=1800, seed=7):
    """The Estimator at the EuRoC window on a synthetic world: init through
    the ground-truth hook, then steady frames through K1-K4."""
    import numpy as np
    import torch

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.config import euroc_config
    from isvins_tpu_torch.estimator.estimator import NON_LINEAR, Estimator
    from isvins_tpu_torch.geom.hostmath import mat_to_quat_np
    from isvins_tpu_torch.utils.synthetic import make_world, project

    # EuRoC window defaults (18/8/1000, 64 IMU samples per frame); the
    # camera looks along body x, as the synthetic world's trajectory faces
    # its landmark ring
    ric = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
    cfg = euroc_config().replace(tic=(0.02, -0.01, 0.01), ric=ric)
    world = make_world(n_frames=n_frames, n_landmarks=n_landmarks, seed=seed)
    est = Estimator(cfg, device=dev)
    print(f"[slice] dims={tuple(est.dims)} frames={n_frames} landmarks={n_landmarks}")

    def gt_init(e):
        e.set_ground_truth_init(world.P, world.Q, world.V)
        e.f_manager.depth[:] = -1.0

    est._gt_init = gt_init
    tic, qic = np.asarray(cfg.tic_np), mat_to_quat_np(np.asarray(ric))
    feats, used, steady_ms, errs = [], [], [], []
    at_steady = None
    ops.reset_launch_counts()  # just before the main path
    try:
        for k in range(n_frames):
            if k > 0:
                for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                    est.process_imu(world.imu_dts[k - 1][s], world.imu_accs[k - 1][s],
                                    world.imu_gyrs[k - 1][s])
            pts, _, vis = project(world, k, tic, qic)
            feats.append(int(vis.sum()))
            steady = est.solver_flag == NON_LINEAR
            if steady and at_steady is None:
                at_steady = ops.launch_counts()
            if steady:
                used.append(int(est.f_manager.build_proj_factors(est.dims.N)["valid"].sum()))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info = est.process_image(np.where(vis)[0], pts[vis], world.frame_times[k])
            torch.cuda.synchronize()
            if steady:
                steady_ms.append((time.perf_counter() - t0) * 1e3)
                if not info.get("solved"):
                    raise AssertionError(f"steady frame {k} not solved: {info}")
            if est.solver_flag == NON_LINEAR:
                errs.append(np.linalg.norm(est.latest_pose()[1] - world.P[k]))
        counts = ops.launch_counts()  # just after the main path
    finally:
        est.close()
    ate = float(np.sqrt(np.mean(np.square(errs))))
    steady_counts = {k: counts[k] - (at_steady or counts)[k] for k in counts}
    print(f"[slice] features/frame mean={np.mean(feats):.1f} min={min(feats)} max={max(feats)}; "
          f"observations used per steady solve mean={np.mean(used):.0f} max={max(used)} "
          f"of N={est.dims.N}")
    print(f"[slice] steady frames={len(steady_ms)} failure_count={est.failure_count} "
          f"launches={counts} (steady frames: {steady_counts}) kld={est.last_kld}")
    print(f"[slice] est_steady_median_ms={float(np.median(steady_ms)):.3f} "
          f"est_ate_vio_m={ate:.6f} (max {max(errs):.6f})")
    if len(steady_ms) < 30:
        raise AssertionError(f"only {len(steady_ms)} steady frames")
    if est.failure_count != 0:
        raise AssertionError(f"failure_count={est.failure_count}")
    if not all(steady_counts[k] > 0 for k in ops.SOLVE_KERNELS):
        raise AssertionError(f"a kernel of the path never launched: {steady_counts}")
    if counts["retrieval_scores"] != 0:
        raise AssertionError(f"the estimator launched K6: {counts}")
    # noiseless world, ground-truth init: the bound of the reference's own
    # noiseless end-to-end test (tests/test_estimator_e2e.py, 5 cm)
    if not ate < 0.05:
        raise AssertionError(f"est_ate_vio_m={ate} >= 0.05")
    return counts, {"est_steady_median_ms": float(np.median(steady_ms)),
                    "est_ate_vio_m": ate, "steady_frames": len(steady_ms)}


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def posegraph_config():
    """bench.py:190-217, the repo's end-to-end configuration with loops on:
    EuRoC window 18/8/1000, N = 3072, a 320x240 f = 200 camera (cut from
    EuRoC's 752x480, as bench.py cuts it), the pose graph with a 0.3 m
    keyframe gate, skip_recent = 25, 256 keypoints per keyframe. Its
    tracker settings are left out: the tracker is not ported yet."""
    from isvins_tpu_torch.config import (CameraConfig, NoiseConfig, PoseGraphConfig,
                                         WindowConfig, euroc_config)
    from isvins_tpu_torch.solver import WindowDims

    H, W, f = 240, 320, 200.0
    cam = CameraConfig(width=W, height=H, fx=f, fy=f, cx=W / 2, cy=H / 2,
                       k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    cfg = euroc_config().replace(
        camera=cam,
        window=WindowConfig(vo_size=8, all_size=18, max_features=1000, max_imu_per_frame=64),
        noise=NoiseConfig(acc_n=0.05, gyr_n=0.005, acc_w=1e-4, gyr_w=1e-5, pixel_sqrt_info=f),
        solver=euroc_config().solver.__class__(excitation_threshold=0.08),
        posegraph=PoseGraphConfig(enabled=True, keyframe_min_dist=0.3, skip_recent=25,
                                  min_loop_matches=15, max_keyframes=256, max_kp_per_kf=256),
        tic=(0.0, 0.0, 0.0), ric=((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0)),
    )
    return cfg, WindowDims(B=18, Vo=8, F=1000, N=3072)


# what optimize_pose_graph reads and writes of the keyframe database
_OPT_FIELDS = ("seq", "vio_t", "vio_q", "opt_t", "opt_q", "cov", "edge_dt", "edge_dq",
               "edge_sqrt", "edge_valid", "rp_q", "rp_sqrt", "rp_valid", "loop_idx",
               "loop_dt", "loop_dq", "loop_weight")


def _record_dispatches(builder_mod, last):
    """Wrap the builder's optimize_pose_graph so that `last` holds a host
    copy of the database as the newest dispatched solve reads it (for the
    f64 replay); returns the original."""
    import types

    import torch

    real = builder_mod.optimize_pose_graph

    def recording(db, first_idx, cur_idx, **kw):
        last.update(first=first_idx, cur=cur_idx, kw=kw, db=types.SimpleNamespace(
            n=db.n, device=torch.device("cpu"),
            **{f: getattr(db, f).copy() for f in _OPT_FIELDS}))
        return real(db, first_idx, cur_idx, **kw)

    builder_mod.optimize_pose_graph = recording
    return real


def phase_posegraph(dev, n_frames=130):
    """The estimator's steady frames feeding the pose graph, as
    System._feed_pose_graph feeds it (isvins_tpu/system.py:320-336): every
    new PoseGraphPacket goes to PoseGraphBuilder.push with its keyframe
    points and the RoomRenderer image at the packet's timestamp. Features
    come from `project` (the tracker is not ported yet); init through the
    ground-truth hook."""
    import numpy as np
    import torch

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.estimator.estimator import NON_LINEAR, Estimator
    from isvins_tpu_torch.frontend.camera import make_camera
    from isvins_tpu_torch.geom.hostmath import mat_to_quat_np
    from isvins_tpu_torch.posegraph import PoseGraphBuilder
    from isvins_tpu_torch.posegraph import builder as builder_mod
    from isvins_tpu_torch.utils import perf
    from isvins_tpu_torch.utils.evaluation import ate_rmse
    from isvins_tpu_torch.utils.synthetic import RoomRenderer, make_world, project

    cfg, dims = posegraph_config()
    # 1.34 laps of the room: the revisit closes real loops
    world = make_world(n_frames=n_frames, frame_hz=10.0, imu_hz=200.0, n_landmarks=300,
                       seed=1, traj_r=3.0, traj_w=0.65)
    tic, qic = np.asarray(cfg.tic_np), mat_to_quat_np(np.asarray(cfg.ric_np))
    renderer = RoomRenderer(world, cfg.camera, tic, qic)
    t0 = time.perf_counter()
    images = [renderer.render(k)[0].astype(np.float32) for k in range(n_frames)]
    print(f"[posegraph] rendered {n_frames} frames in {time.perf_counter() - t0:.1f} s")

    def image_at(ts):  # the frame at the packet's timestamp
        return images[int(np.argmin(np.abs(world.frame_times - ts)))]

    est = Estimator(cfg, dims, device=dev)
    builder = PoseGraphBuilder(cfg, camera=make_camera(cfg.camera), device=dev)
    builder.prewarm()

    def gt_init(e):
        e.set_ground_truth_init(world.P, world.Q, world.V)
        e.f_manager.depth[:] = -1.0

    est._gt_init = gt_init
    cursor, frame_ms, est_ms, pg_ms, traj, feats = 0, [], [], [], [], []

    def feed():
        nonlocal cursor
        while cursor < len(est.pose_graph_packets):
            pkt = est.pose_graph_packets[cursor]
            builder.push(pkt, est.keyframe_points[cursor], image=image_at(float(pkt.ts)))
            cursor += 1

    print(f"[posegraph] dims={tuple(dims)} frames={n_frames} camera="
          f"{cfg.camera.width}x{cfg.camera.height} pose graph: {cfg.posegraph}")
    last = {}  # the newest dispatched solve: its segment and a host copy of its inputs
    real_opt = _record_dispatches(builder_mod, last)
    perf.reset()
    perf.enable(True)
    ops.reset_launch_counts()  # just before the main path
    try:
        for k in range(n_frames):
            if k > 0:
                for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                    est.process_imu(world.imu_dts[k - 1][s], world.imu_accs[k - 1][s],
                                    world.imu_gyrs[k - 1][s])
            pts, _, vis = project(world, k, tic, qic)
            feats.append(int(vis.sum()))
            steady = est.solver_flag == NON_LINEAR
            _sync(dev)
            t0 = time.perf_counter()
            est.process_image(np.where(vis)[0], pts[vis], world.frame_times[k])
            _sync(dev)
            t1 = time.perf_counter()
            if est.solver_flag == NON_LINEAR:
                feed()
            _sync(dev)
            if steady:
                t2 = time.perf_counter()
                frame_ms.append((t2 - t0) * 1e3)
                est_ms.append((t1 - t0) * 1e3)
                pg_ms.append((t2 - t1) * 1e3)
            traj.extend(est.ready_poses)
            est.ready_poses.clear()
        est.close()  # lands the last marginalization's packet
        feed()
        builder.flush_optimize()
        _sync(dev)
        counts = ops.launch_counts()  # just after the main path
    finally:
        est.close()
        perf.enable(False)
        builder_mod.optimize_pose_graph = real_opt
    stats = perf.stats()
    db = builder.db
    ts_k, t_opt, _ = builder.trajectory()
    _, _, cov = builder.covariances()
    t_v = np.array([t for t, _, _ in traj])
    p_v = np.array([p for _, p, _ in traj])
    ate_vio = float(ate_rmse(t_v, p_v, world.frame_times, world.P, align="se3"))
    ate_loop = float(ate_rmse(ts_k, t_opt, world.frame_times, world.P, align="se3"))
    med = float(np.median(frame_ms))
    pg_mean = float(np.sum(pg_ms)) / len(pg_ms)
    queries = db.match_count_queries
    print(f"[posegraph] features/frame mean={np.mean(feats):.1f} min={min(feats)}; steady "
          f"frames={len(frame_ms)} failure_count={est.failure_count} launches={counts}")
    print(f"[posegraph] pg_keyframes={db.n} pg_loops_closed={builder.n_loops} "
          f"loop pairs={[(int(i), int(db.loop_idx[i])) for i in np.where(db.loop_idx[:db.n] >= 0)[0]]} "
          f"match-count queries={len(queries)} (keyframes {queries[:1]}..{queries[-1:]}) "
          f"vocab_frozen={db.vocab_frozen} async solves dispatched="
          f"{builder.n_async_dispatches} collected={builder.n_async_collects} "
          f"landed={builder.n_async_landed}")
    print(f"[posegraph] pg_ate_vio_m={ate_vio:.6f} pg_ate_loop_m={ate_loop:.6f} "
          f"pg_frame_median_ms={med:.3f} (estimator + builder, steady frames); "
          f"estimator median {float(np.median(est_ms)):.3f} ms; builder median "
          f"{float(np.median(pg_ms)):.3f} ms, mean {pg_mean:.3f} ms, max "
          f"{float(np.max(pg_ms)):.3f} ms per steady frame")
    for name in ("pg.kf_device_step", "pg.query", "pg.find_connection", "pg.opt_dispatch",
                 "pg.opt_finalize"):
        st = stats.get(name, {})
        print(f"[posegraph] {name}: n={st.get('count', 0)} median_ms={st.get('median_ms')} "
              f"max_ms={st.get('max_ms')} total_ms={st.get('total_ms')}")
    if est.failure_count != 0:
        raise AssertionError(f"failure_count={est.failure_count}")
    if db.n < 30:
        raise AssertionError(f"only {db.n} keyframes")
    if builder.n_loops < 1:
        raise AssertionError("no loop closed on the revisit")
    if not counts["retrieval_scores"] == len(queries) >= 1:
        raise AssertionError(f"K6 launches {counts['retrieval_scores']} != match-count "
                             f"queries {len(queries)} (or none)")
    if not all(counts[k] > 0 for k in ops.SOLVE_KERNELS):
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    # every K6 query of the drive again, at its own size K = idx -
    # skip_recent, from the database's device mirror (which must equal the
    # host rows), against the plain version: exact
    n = db.n
    if not torch.equal(db.ret_desc_dev[:n].cpu(), torch.from_numpy(db.ret_desc[:n].view(np.int32))) \
            or not torch.equal(db.ret_valid_dev[:n].cpu(), torch.from_numpy(db.ret_valid[:n])):
        raise AssertionError("the retrieval device mirror differs from the host rows")
    sizes = []
    for idx in queries:
        hi = idx - cfg.posegraph.skip_recent
        args = (db.ret_desc_dev[idx], db.ret_valid_dev[idx], db.ret_desc_dev[:hi],
                db.ret_valid_dev[:hi], cfg.posegraph.retrieval_match_thresh)
        out, ref = ops.retrieval_scores(*args), ops.retrieval_scores_ref(*args)
        if not torch.equal(out, ref):
            raise AssertionError(f"K6 at query {idx} (K={hi}): max abs err "
                                 f"{float((out - ref).abs().max()):.3g}")
        sizes.append(hi)
    print(f"[posegraph] K6 replay: {len(sizes)} queries at K={min(sizes)}..{max(sizes)} equal "
          f"the plain version exactly")
    # every dispatched solve was collected and landed finite poses
    if not builder.n_async_dispatches == builder.n_async_collects == builder.n_async_landed >= 1:
        raise AssertionError(f"async solves: dispatched {builder.n_async_dispatches}, collected "
                             f"{builder.n_async_collects}, landed {builder.n_async_landed}")
    opt_err = _replay_last_solve(db, last)
    # the blocks of every keyframe a solve covered: finite, symmetric and
    # PSD up to the solve's rounding (f32 on the card: asymmetry and
    # negative eigenvalues within 1e-4 of the block's largest eigenvalue)
    blocks = cov[np.abs(cov).sum(axis=(1, 2)) > 0]
    if not len(blocks) or not np.isfinite(blocks).all():
        raise AssertionError(f"covariance blocks: {len(blocks)} solved, finite="
                             f"{bool(np.isfinite(blocks).all())}")
    sym = 0.5 * (blocks + np.swapaxes(blocks, 1, 2))
    eig = np.linalg.eigvalsh(sym)
    scale = eig.max(axis=1)
    asym = float((np.abs(blocks - np.swapaxes(blocks, 1, 2)).max(axis=(1, 2)) / scale).max())
    neg = float((-eig.min(axis=1) / scale).max())
    print(f"[posegraph] covariance blocks: {len(blocks)} solved keyframes; max asymmetry "
          f"{asym:.3g}, max -min_eig {neg:.3g} (relative to each block's largest "
          f"eigenvalue); trace {np.trace(blocks, axis1=1, axis2=2).min():.3g}.."
          f"{np.trace(blocks, axis1=1, axis2=2).max():.3g}")
    if not (scale > 0).all() or asym > 1e-4 or neg > 1e-4:
        raise AssertionError("covariance blocks not symmetric PSD")
    # noiseless world, ground-truth init: the bound of PERF.md section 2
    if not ate_loop < 0.05:
        raise AssertionError(f"pg_ate_loop_m={ate_loop} >= 0.05")
    return counts, {"pg_keyframes": int(db.n), "pg_loops_closed": int(builder.n_loops),
                    "pg_ate_vio_m": ate_vio, "pg_ate_loop_m": ate_loop,
                    "pg_frame_median_ms": med, "pg_builder_mean_ms": pg_mean,
                    "pg_est_median_ms": float(np.median(est_ms)), **opt_err}


def _replay_last_solve(db, last):
    """The newest card solve (f32, written into db) against
    optimize_pose_graph on a host copy of the same inputs (CPU, f64)."""
    import types

    import numpy as np

    from isvins_tpu_torch.posegraph.optimize import optimize_pose_graph

    first, cur, snap = last["first"], last["cur"], last["db"]
    kw = {k: v for k, v in last["kw"].items() if k != "async_dispatch"}

    def solved(cast):
        d = types.SimpleNamespace(n=snap.n, device=snap.device,
                                  **{f: cast(getattr(snap, f)) for f in _OPT_FIELDS})
        optimize_pose_graph(d, first, cur, **kw)
        return d

    ref = solved(np.copy)
    sl = slice(first, cur + 1)
    dt = float(np.abs(db.opt_t[sl] - ref.opt_t[sl]).max())
    dq = float(np.abs(db.opt_q[sl] - ref.opt_q[sl]).max())
    c, c_ref = db.cov[sl], ref.cov[sl]
    dcov = float((np.linalg.norm(c - c_ref, axis=(1, 2))
                  / np.linalg.norm(c_ref, axis=(1, 2))).max())
    # the same f64 solve from inputs rounded to f32: how far f32 rounding of
    # the inputs alone moves the answer
    rnd = solved(lambda a: a.astype(np.float32).astype(np.float64) if a.dtype == np.float64
                 else a.copy())
    dt_in = float(np.abs(rnd.opt_t[sl] - ref.opt_t[sl]).max())
    # bounds: poses within 256 f32 ulps of the segment's largest coordinate
    # (quaternions: of 1.0); covariance blocks, read off the f32 inverse of
    # H, within 5 % (f32 rounding times cond(H), which the loop weights of
    # up to 1e9 against the sequential edges' information make large)
    tol_t = 256 * float(np.spacing(np.float32(np.abs(ref.opt_t[sl]).max())))
    tol_q = 256 * float(np.spacing(np.float32(1.0)))
    print(f"[posegraph] last solve, segment {first}..{cur} ({cur - first + 1} poses): card f32 "
          f"vs CPU f64: max|dt| {dt:.3g} m (bound {tol_t:.3g}), max|dq| {dq:.3g} (bound "
          f"{tol_q:.3g}), max relative covariance-block error {dcov:.3g} (bound 0.05); f64 "
          f"from f32-rounded inputs: max|dt| {dt_in:.3g} m")
    if not (dt <= tol_t and dq <= tol_q and dcov <= 0.05):
        raise AssertionError("the card's pose-graph solve disagrees with the f64 solve")
    return {"pg_opt_max_dt_m": dt, "pg_opt_max_dq": dq, "pg_opt_cov_rel_err": dcov}


def main():
    import torch

    dev, smi = phase_device()
    phase_build()
    records = phase_kernels(dev)
    solve = phase_solve(dev)
    _, sl = phase_slice(dev)
    counts, pg = phase_posegraph(dev)
    print(json.dumps({"solve": solve, "slice": sl, "posegraph": pg}))
    print(smi)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_META[k][0],
         "replaces": KERNEL_META[k][1], "launches": counts[k], **records[k]}
        for k in KERNEL_META]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
