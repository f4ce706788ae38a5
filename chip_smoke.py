#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (isvins_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:
  1. device  — the card's name and power limit (nvidia-smi); no CUDA -> exit 2
  2. build   — compile csrc/*.cu (nvcc, sm_90a) into build/kernels/
  3. kernels — K1-K4 against their plain PyTorch versions at the product
               shapes, with the reference tests' tolerances; CUDA-event times
  4. solve   — solve_window on make_batch_problem(1, (18, 8, 1000, 3072)),
               10 LM iterations, f32: vio_window_solve_frames_per_s and the
               launch counts of K1-K4 against the builds/iterations it ran
  5. slice   — the Estimator on a synthetic world at the EuRoC window
               (18/8/1000, N=3072): steady frames through all four kernels,
               ATE against ground truth
Second-to-last line: one JSON object with the per-kernel records; last line:
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
}


def phase_device():
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
          f"torch={torch.__version__} cuda={torch.version.cuda}")
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
    return {"proj_rows": proj, "imu_rows": imu_args, "schur_corr": schur, "linstep": lin}


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
    expect = {"proj_rows": it + 1, "imu_rows": it + 1, "schur_corr": it, "linstep": it}
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
    if not all(v > 0 for v in steady_counts.values()):
        raise AssertionError(f"a kernel of the path never launched: {steady_counts}")
    # noiseless world, ground-truth init: the bound of the reference's own
    # noiseless end-to-end test (tests/test_estimator_e2e.py, 5 cm)
    if not ate < 0.05:
        raise AssertionError(f"est_ate_vio_m={ate} >= 0.05")
    return counts, {"est_steady_median_ms": float(np.median(steady_ms)),
                    "est_ate_vio_m": ate, "steady_frames": len(steady_ms)}


def main():
    import torch

    dev, smi = phase_device()
    phase_build()
    records = phase_kernels(dev)
    solve = phase_solve(dev)
    counts, sl = phase_slice(dev)
    print(json.dumps({"solve": solve, "slice": sl}))
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
