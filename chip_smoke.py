#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (isvins_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:
  1. device  — the card's name and power limit (nvidia-smi); no CUDA -> exit 2
  2. build   — compile csrc/*.cu (nvcc, sm_90a) into build/kernels/
  3. kernels — K1-K7 against their plain PyTorch versions at the product
               shapes, with the reference tests' tolerances (K5 at NB = 1,
               4, 8, 16, 32, and K1 and K2 on the flattened rows of 4 and
               of 16 sequences: the multiseq path's two batches; K6 exact,
               at K = 23, the posegraph path's largest, and at 1, 256 and
               4096; K7 with an empty landmark; K1 and K2 also at the
               ragged sizes of ROWS_SIZES and FACTOR_SIZES, with masked
               rows and factors and points at the z clamp, twice with
               equal bits; K3 and K7 also at the
               small and ragged shapes of SCHUR_SHAPES, K3 with and
               without lam, both twice with equal bits and an exactly
               symmetric C; K4 and K5 also at D = 66 and 141, twice with
               equal bits, with a bad pivot at columns 0, 100 and D - 1,
               and ops.chol_plan held against the C++ geometry; K4's
               chain alone timed as cholesky_solve(cholesky_ex) on its
               own H_dd, `chain_library_ms`);
               device times of kernel, plain version and, where one
               PyTorch call computes the same function, that call: 100
               calls captured in a CUDA graph, replayed between two events
               (`ms`; `plain_ms` and `library_ms` too wherever they can be
               captured, else eager and labelled), beside the host-paced time
               of 100 eager calls (`eager_ms`), the time of an empty
               kernel both ways (`launch_floor_ms`), and each kernel's
               bound from its bytes and operations
  4. solve   — solve_window on make_batch_problem(1, (18, 8, 1000, 3072)),
               10 LM iterations, f32: vio_window_solve_frames_per_s, the
               launch counts of K1-K4 against the builds/iterations it ran,
               and a second run with the same bits
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
  7. multiseq — (a) make_batch_problem(16, (18, 8, 1000, 3072)) through
               sharded_batch_solve on the card, 10 iterations, against the
               16 problems solved one by one: every sequence's state after
               1, 2 and 3 iterations, and the 10-iteration results through
               the f64 solves; every path run twice with the same bits; K5
               launches = LM iterations, K1 = K2 = evaluations, K3 = K4 = 0;
               batched_x8/x16/x32 throughput. (b) four Estimators at the
               EuRoC window on four
               seeded worlds, coordinated by MultiSequenceSolver, against
               the same four run alone
Each path's launch counts are set to 0 just before it and read just after.
  8. reduce  — K7's own path (the package has no caller for it, as the
               JAX package has none for its TPU kernel): one LM linear step
               of a product window taken unfused in the full layout, K7
               then K5 at NB = 1, against the fused K4 step
  9. profiler — torch.profiler's device time of each kernel's own launches
               (`profiler_ms`), the cross-check of the graph-replay times
An earlier line: {"launch_floor_ms": {"graph": t, "eager": t}}.
Second-to-last line: one JSON object with the per-kernel records of all
seven kernels (launches: K1-K4 and K6 from the posegraph path, K5 from the
multiseq path, K7 from the reduce path); last line:
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
    "chol_solve_batched": ("isvins_tpu_torch/csrc/chol_batched.cu",
                           "isvins_tpu/ops/linstep_pallas.py:424"),
    "retrieval_scores": ("isvins_tpu_torch/csrc/hamming.cu",
                         "isvins_tpu/ops/hamming_pallas.py:122"),
    "schur_reduce": ("isvins_tpu_torch/csrc/schur_reduce.cu",
                     "isvins_tpu/ops/schur_pallas.py:61"),
}

# Published peaks of one H100 SXM (NVIDIA's data sheet): f32 outside the
# tensor cores, and HBM3. K6's integer xor/popcount/add work is counted at
# the same rate: it runs on the same cores.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# The multiseq path's batches: (a) this many bare product windows, (b) one
# estimator per seeded world. The kernels phase checks K1, K2 and K5 at both
# sequence counts.
MULTISEQ_NB = 16
MULTISEQ_SEEDS = (11, 12, 13, 14)


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
    """Mean time of fn() over `reps` eager calls between two CUDA events:
    paced by the host's enqueue rate wherever the device work is shorter,
    which is what a caller without CUDA graphs pays."""
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


def graph_ms(fn, reps=100, replays=5):
    """Device time of fn(): `reps` calls captured into one CUDA graph,
    replayed between two events; the median replay over `reps`. The host
    enqueues nothing during a replay, so this is the device's time per call,
    launch gaps inside the graph included. Raises if fn() cannot be captured
    (a host read of device memory, a synchronize)."""
    import numpy as np
    import torch

    for _ in range(3):  # warm up: lazy initialization cannot be captured
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def graph_or_eager_ms(fn, reps, what):
    """(ms, how) for a yardstick that is not the port's code: graph replay
    where `what` can be captured, else eager calls, labelled (MAGMA's
    batched Cholesky allocates inside the call: K5's plain version and
    library call). The kernels get no such way out: see graph_ms."""
    import torch

    try:
        return graph_ms(fn, reps, replays=3), "graph"
    except RuntimeError as e:
        torch.cuda.synchronize()
        print(f"[kernels]   {what} not capturable ({str(e).splitlines()[0][:100]}): "
              "timed eagerly")
        return cuda_ms(fn, reps), "eager"


# the CUDA kernels that each wrapper launches, as torch.profiler names them
PROFILER_NAMES = {
    "proj_rows": ("proj_rows_kernel",), "imu_rows": ("imu_rows_kernel",),
    "schur_corr": ("schur_corr_kernel",),
    "linstep": ("schur_corr_kernel", "linstep_chol_kernel", "linstep_dl_kernel"),
    "chol_solve_batched": ("chol_solve_batched_kernel",),
    "retrieval_scores": ("retrieval_scores_kernel",), "schur_reduce": ("schur_reduce_kernel",),
}


def profiler_ms(name, fn, reps=20):
    """torch.profiler's device time of the wrapper's own kernels per call:
    the cross-check of graph_ms (it leaves out the gaps between launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(
        e, "self_cuda_time_total", 0)
    total = 0.0
    for kernel in PROFILER_NAMES[name]:  # mean per recorded launch, summed over the kernels
        hits = [e for e in prof.key_averages() if kernel in e.key]
        if not hits:
            raise AssertionError(f"{name}: torch.profiler recorded no launch of {kernel}")
        total += sum(dev_us(e) for e in hits) / sum(e.count for e in hits)
    return total / 1e3


def launch_floor(dev):
    """The time of an empty kernel (csrc/noop.cu), replayed from a graph and
    launched eagerly: what no single launch can go under."""
    from isvins_tpu_torch.ops import _lib

    noop = lambda: _lib.launch("isv_noop", device=dev)
    floor = {"graph": graph_ms(noop), "eager": cuda_ms(noop)}
    print(f"[kernels] launch floor (an empty kernel): graph replay {floor['graph'] * 1e3:.2f} us, "
          f"eager {floor['eager'] * 1e3:.2f} us per launch")
    print(json.dumps({"launch_floor_ms": floor}))


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

    imu_args = imu_inputs(dev, seed, rng)
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
    # K7 as tests/test_pallas_ops.py:68-81: symmetric H, W at the full width,
    # one empty landmark
    A7 = rng.normal(size=(D, D))
    h7 = np.abs(rng.normal(size=F)) + 0.1
    h7[7] = 0.0
    reduce = (f32(A7 + A7.T), f32(rng.normal(size=D)), f32(rng.normal(size=(F, D))), f32(h7),
              f32(rng.normal(size=F)))
    return {"proj_rows": proj, "imu_rows": imu_args, "schur_corr": schur, "linstep": lin,
            "chol_solve_batched": chol_inputs(dev, MULTISEQ_NB, seed),
            "retrieval_scores": retrieval_inputs(dev, 23, seed), "schur_reduce": reduce}


def imu_inputs(dev, seed=0, rng=None):
    """K2 inputs: the 17 IMU factors of a real preintegration of the port's
    batch problem at the product window, with biases off their
    linearization points."""
    import numpy as np
    import torch

    from isvins_tpu_torch.parallel.sharded import make_batch_problem
    from isvins_tpu_torch.solver import WindowDims

    B = 18
    rng = np.random.default_rng(seed) if rng is None else rng
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    state, imu, *_ = make_batch_problem(1, WindowDims(B, 8, 1000, 3072), torch.float32,
                                        device=dev, seed=seed)
    st = [getattr(state, k)[0] for k in ("P", "Q", "V", "Ba", "Bg")]
    st[3] = st[3] + f32(rng.normal(size=(B, 3)) * 0.02)  # off-linearization biases
    st[4] = st[4] + f32(rng.normal(size=(B, 3)) * 0.002)
    pre = imu.pre
    return tuple(a.contiguous() for a in (
        *(a[:-1] for a in st), *(a[1:] for a in st),
        pre.delta_p[0], pre.delta_q[0], pre.delta_v[0], pre.sum_dt[0], pre.ba[0], pre.bg[0],
        pre.jac[0], f32([0.0, 0.0, 9.81])))


# K1 and K2 beyond the main path's shapes, at the ragged edges of their
# blocks (32 rows; two factors): rows N in S sequences, and factors n (S =
# n / 17 sequences of the product window's 17 from 68 on)
ROWS_SIZES = ((1, 1), (31, 1), (33, 3), (3072, 1), (3072 * MULTISEQ_NB, MULTISEQ_NB))
FACTOR_SIZES = (1, 2, 17, 68, 272)


def proj_case(dev, N, S, seed=0):
    """K1 inputs at N rows in S sequences, each with its own tic and qic
    ((3,) and (4,) when S = 1): random poses and bearings as kernel_inputs
    draws them; ~15 % of the rows masked, half of those with depth 0; and
    every 7th row observed from its own host pose (Qj = Qi, Pj = Pi), with
    the bearing's z set so that camera j sees the point at |z| from 0 to
    2e-6, around the +-1e-6 clamp, where 1/z amplifies every last bit."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 7 * N + S)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    q = rng.normal(size=(2, N, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    Qi, Qj = q
    Pi, Pj = rng.normal(size=(2, N, 3)) * 2.0
    bearing = lambda: np.concatenate([rng.normal(size=(N, 2)) * 0.3, np.ones((N, 1))], 1)
    pts_i, pts_j = bearing(), bearing()
    dep = np.abs(rng.normal(size=N)) * 4.0 + 0.5
    valid = rng.random(N) > 0.15
    dep[~valid & (rng.random(N) < 0.5)] = 0.0
    near = np.arange(3, N, 7)
    Qj[near], Pj[near] = Qi[near], Pi[near]
    d = np.where(valid & (np.abs(dep) > 1e-8), dep, 1.0)
    pts_i[near, 2] = rng.choice([0.0, 5e-7, -5e-7, 1e-6, -1e-6, 2e-6, -2e-6], len(near)) * d[near]
    qic = np.concatenate([np.ones((S, 1)), rng.normal(size=(S, 3)) * 0.05], 1)
    qic /= np.linalg.norm(qic, axis=1, keepdims=True)
    tic = rng.normal(size=(S, 3)) * 0.02
    if S == 1:
        tic, qic = tic[0], qic[0]
    return (f32(pts_i), f32(pts_j), f32(Pi), f32(Qi), f32(Pj), f32(Qj), f32(tic), f32(qic),
            f32(dep), torch.as_tensor(valid, device=dev))


def imu_case(dev, n, seed=0):
    """K2 inputs at n factors: the first n of imu_inputs' 17, or n / 17
    sequences of them, each with its own gravity; from n = 2 on the middle
    factor is masked as a window pads one (zero deltas, Jacobian and time,
    a zero quaternion)."""
    import torch

    args = list(imu_inputs(dev, seed))
    if n <= 17:
        args = [a[:n].contiguous() for a in args[:-1]] + [args[-1]]
    else:
        S = n // 17
        args = [a.repeat((S,) + (1,) * (a.dim() - 1)) for a in args[:-1]] + [
            args[-1] + 0.01 * torch.arange(S, device=dev, dtype=torch.float32)[:, None]]
    if n >= 2:
        k = n // 2
        for a in args[10:17]:  # dP, dQ, dV, sum_dt, ba0, bg0, jac
            a[k] = 0.0
    return tuple(args)


def rows_checks(dev, cases):
    """K1 at ROWS_SIZES and K2 at FACTOR_SIZES against their plain versions
    with the reference's tolerances, twice with equal bits, every output
    finite (masked rows and factors included)."""
    import torch

    from isvins_tpu_torch import ops

    runs = [(f"proj_rows N={N} S={S}", ops.proj_rows, ops.proj_rows_ref,
             proj_case(dev, N, S), cases["proj_rows"][2:]) for N, S in ROWS_SIZES]
    runs += [(f"imu_rows n={n}", ops.imu_rows, ops.imu_rows_ref, imu_case(dev, n),
              cases["imu_rows"][2:]) for n in FACTOR_SIZES]
    errs = []
    for what, kern, plain, args, (rtol, atol) in runs:
        out, again = kern(*args), kern(*args)
        torch.cuda.synchronize()
        _assert_close(what, out, plain(*args), rtol, atol)
        if not all(torch.equal(x, y) for x, y in zip(out, again)):
            raise AssertionError(f"{what}: two launches differ")
        if not all(bool(torch.isfinite(x).all()) for x in out):
            raise AssertionError(f"{what}: a non-finite output")
        errs.append(f"{what.split(' ', 1)[1]} {_max_err(out, plain(*args)):.3g}")
    print(f"[kernels] K1 and K2 at the ragged sizes, max abs err: {'; '.join(errs)}; each "
          "repeats bit for bit, all finite")


def chol_inputs(dev, NB, seed=0, D=276):
    """K5 inputs: NB SPD systems built as tests/test_pallas_ops.py:135-148
    builds H (A A^T + 200 I), each from its own draw."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 1000 * NB)
    A = rng.normal(size=(NB, D, D + 60))
    H = A @ A.transpose(0, 2, 1) + 200 * np.eye(D)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return f32(H), f32(rng.normal(size=(NB, D)))


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


def kernel_work(name, args):
    """(bytes, operations) of one call: every input read once and every
    output written once, and the arithmetic the function needs on these
    inputs. K1's and K2's per-row operation counts are estimates read off
    their sources (~600 and ~1,500); either way bytes bound them."""
    if name == "proj_rows":
        N = args[0].shape[0]
        return N * ((21 + 28) * 4 + 1) + 7 * 4, 600 * N
    if name == "imu_rows":
        n = args[0].shape[0]
        return n * (274 + 465) * 4 + 3 * 4, 1500 * n
    if name == "schur_corr":
        F, Dr = args[0].shape
        return (F * Dr + 2 * F + Dr * Dr + Dr) * 4, 2 * F * Dr * (Dr + 1)
    if name == "linstep":
        H, _, W = args[:3]
        D, (F, Dr) = H.shape[0], W.shape
        return ((D * D + D + F * Dr + 2 * F + 1 + D + F) * 4,
                2 * F * Dr * (Dr + 1) + D ** 3 // 3 + 2 * D * D + 2 * F * Dr)
    if name == "chol_solve_batched":
        NB, D = args[1].shape
        return NB * (D * D + 2 * D) * 4, NB * (D ** 3 // 3 + 2 * D * D)
    if name == "retrieval_scores":
        R, words = args[0].shape
        K = args[2].shape[0]
        # per pair of descriptors: xor, popcount and add per word
        return (K + 1) * (R * words * 4 + R) + K * 4, K * R * R * words * 3
    if name == "schur_reduce":
        F, D = args[2].shape
        return (2 * D * D + F * D + 2 * F + 2 * D) * 4, 2 * F * D * D + 2 * F * D
    raise KeyError(name)


def kernel_bound(name, args):
    """bound_ms and which side bounds it, from this call's inputs."""
    nbytes, nops = kernel_work(name, args)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, nops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def library_call(name, args):
    """The one PyTorch call that computes the same function, where there is
    one (timed here, used nowhere in the port); else None."""
    import torch

    if name == "schur_corr":  # C and c_b, as the kernel: one product against [W | b_l]
        W, h, b_l = args
        X = torch.cat([W, b_l[:, None]], dim=1).contiguous()
        return lambda: W.T @ (X / h[:, None])
    if name == "chol_solve_batched":  # cholesky_ex: linalg.cholesky reads its info on the host
        H, b = args
        return lambda: torch.cholesky_solve(b[..., None], torch.linalg.cholesky_ex(H)[0])
    if name == "schur_reduce":  # H_s and b_s, as the kernel: [H | b] - W^T [W | b_l] / h
        H, b, W, h, b_l = args
        h_safe = torch.where(h > 1e-12, h, torch.ones_like(h))
        X = torch.cat([W, b_l[:, None]], dim=1).contiguous()
        Hb = torch.cat([H, b[:, None]], dim=1).contiguous()
        return lambda: torch.addmm(Hb, W.T, X / h_safe[:, None], alpha=-1)
    return None


def _measure(name, kern, plain, args, rtol, atol_fn, reps=100, plain_reps=100):
    """One kernel at one shape: agreement with its plain version, then the
    device times (graph replay), the eager time and the bound."""
    import torch

    out = kern(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    torch.cuda.synchronize()
    _assert_close(name, out, ref, rtol, atol_fn)
    lib = library_call(name, args)
    call = lambda: kern(*args)
    p_ms, p_how = graph_or_eager_ms(lambda: plain(*args), plain_reps, "plain version")
    l_ms, l_how = graph_or_eager_ms(lib, reps, "library call") if lib is not None else (None, None)
    rec = {"max_abs_err": _max_err(out, ref), "ms": graph_ms(call, reps),
           "eager_ms": cuda_ms(call, reps),
           "plain_ms": p_ms, "plain_timing": p_how, **kernel_bound(name, args),
           "library_ms": l_ms, "library_timing": l_how}
    lib_txt = f" library {l_ms * 1e3:.2f} us ({l_how})" if lib is not None else ""
    print(f"[kernels] {name}: max_abs_err={rec['max_abs_err']:.3g} kernel {rec['ms'] * 1e3:.2f} us "
          f"(graph replay; eager {rec['eager_ms'] * 1e3:.2f} us) plain "
          f"{rec['plain_ms'] * 1e3:.2f} us ({p_how}){lib_txt} bound {rec['bound_ms'] * 1e3:.3f} us "
          f"({rec['bound_by']}) (rtol {rtol})")
    return rec


# K3 and K7 beyond the product shapes: (F, n). The pose-graph slice's and the
# tests' windows (n = 66, 30), shapes smaller than a tile, a chunk or the
# split count, an odd n (4-byte copies), and F short at the full width.
SCHUR_SHAPES = ((1000, 114), (1000, 276), (256, 66), (50, 30), (3, 7), (1, 1), (37, 276))


def schur_shape_checks(dev):
    """K3 (with and without lam) and K7 at SCHUR_SHAPES against their plain
    versions (rtol 2e-5, atol 2e-3), one landmark empty where the guard
    applies; each twice with equal bits; C and, for a symmetric H, H_s equal
    to their transposes exactly."""
    import numpy as np
    import torch

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.ops import schur

    tol = (2e-5, lambda r: 2e-3)
    for F, n in SCHUR_SHAPES:
        rng = np.random.default_rng(1000 * F + n)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        W, b_l = f32(rng.normal(size=(F, n))), f32(rng.normal(size=F))
        h = f32(np.abs(rng.normal(size=F)) + 0.1)
        h0 = h.clone()
        h0[F // 2] = 0.0  # an empty landmark
        A = rng.normal(size=(n, n))
        H, b = f32(A + A.T), f32(rng.normal(size=n))
        lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
        h_d = h0 * (1.0 + lam)
        runs = {
            "schur_corr": (lambda: ops.schur_corr(W, h, b_l), ops.schur_corr_ref(W, h, b_l)),
            "schur_corr with lam": (
                lambda: schur._launch(W, h0, b_l, lam),
                ops.schur_corr_ref(W, torch.where(h_d > 1e-12, h_d, torch.ones_like(h_d)), b_l)),
            "schur_reduce": (lambda: ops.schur_reduce(H, b, W, h0, b_l),
                             ops.schur_reduce_ref(H, b, W, h0, b_l)),
        }
        errs = []
        for name, (run, ref) in runs.items():
            out, again = run(), run()
            torch.cuda.synchronize()
            _assert_close(f"{name} F={F} n={n}", out, ref, *tol)
            if not all(torch.equal(x, y) for x, y in zip(out, again)):
                raise AssertionError(f"{name} F={F} n={n}: two runs differ")
            if not torch.equal(out[0], out[0].T):
                raise AssertionError(f"{name} F={F} n={n}: the matrix is not exactly symmetric")
            errs.append(f"{name} {_max_err(out, ref):.3g}")
        print(f"[kernels] F={F} n={n} {schur.schur_plan(F, n, True, schur._alignment(W))}: "
              f"max_abs_err {', '.join(errs)}; repeats bit for bit; symmetric")


def kernel_cases(dev):
    """(inputs, {name: (kernel, plain, rtol, atol(ref))}) of the seven
    kernels at the main paths' shapes, with the reference kernel tests'
    tolerances (tests/test_pallas_ops.py)."""
    from isvins_tpu_torch import ops

    inp = kernel_inputs(dev)
    D = inp["linstep"][0].shape[0]
    tup = lambda f: (lambda *a: (f(*a),))
    cases = {
        "proj_rows": (ops.proj_rows, ops.proj_rows_ref, 3e-4, lambda r: 1e-4),
        "imu_rows": (ops.imu_rows, ops.imu_rows_ref,
                     1e-5, lambda r: 2e-6 * float(r.abs().max())),
        "schur_corr": (ops.schur_corr, ops.schur_corr_ref, 2e-5, lambda r: 2e-3),
        "linstep": (ops.linstep, lambda *a: ops.linstep_ref(*a, D),
                    2e-3, lambda r: 2e-3 * float(r.abs().max())),
        # the batched step's bound (tests/test_pallas_ops.py:176-184)
        "chol_solve_batched": (tup(ops.chol_solve_batched), tup(ops.chol_solve_batched_ref),
                               2e-3, lambda r: 2e-3 * float(r.abs().max())),
        # K6 is integer work up to one IEEE division: exact
        "retrieval_scores": (tup(ops.retrieval_scores), tup(ops.retrieval_scores_ref),
                             0.0, lambda r: 0.0),
        "schur_reduce": (ops.schur_reduce, ops.schur_reduce_ref, 2e-5, lambda r: 2e-3),
    }
    return inp, cases


def chol_plan_check(dev, widths=(66, 141, 276)):
    """ops.chol_plan (Python) and chol_plan of csrc/chol.cuh (C++, through
    isv_chol_plan) must give the same layout for every D this script runs."""
    import torch

    from isvins_tpu_torch.ops import _lib
    from isvins_tpu_torch.ops.chol_batched import chol_plan

    for D in widths:
        out = torch.zeros(4, dtype=torch.int32)
        _lib.launch("isv_chol_plan", D, out, device=dev)
        if tuple(out.tolist()) != tuple(chol_plan(D)):
            raise AssertionError(f"chol_plan({D}): C++ {out.tolist()} != Python {chol_plan(D)}")
    print(f"[kernels] chol_plan: Python and C++ agree at D = {widths}: "
          f"{[tuple(chol_plan(D)) for D in widths]} (nb, Dp, tiles, smem_bytes)")


def small_linstep_inputs(dev, B, F, seed=0):
    """K4 inputs at a small window (D = 15 B + 6), SPD as kernel_inputs."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + B)
    n_pose, D = 6 * B, 15 * B + 6
    Dr, ex0 = n_pose + 6, 15 * B
    A = rng.normal(size=(D, D + 60))
    H = A @ A.T + 200 * np.eye(D)
    W = rng.normal(size=(F, Dr)).astype(np.float32)
    h = (np.abs(rng.normal(size=F)) * 5 + 0.5).astype(np.float32)
    C = (W / h[:, None]).T @ W
    H[:n_pose, :n_pose] += C[:n_pose, :n_pose]
    H[:n_pose, ex0:] += C[:n_pose, n_pose:]
    H[ex0:, :n_pose] += C[n_pose:, :n_pose]
    H[ex0:, ex0:] += C[n_pose:, n_pose:]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return (f32(H), f32(rng.normal(size=D)), f32(W), f32(h), f32(rng.normal(size=F)),
            torch.tensor(1e-3, dtype=torch.float32, device=dev), n_pose)


def chol_checks(dev, cases):
    """The blocked Cholesky routine of K4 and K5 beyond the product shapes:
    the plan against the C++ geometry; K5 (four systems) and K4 at D = 66
    and 141 (B = 4 and 9; 141 is not a multiple of the tile) against their
    plain versions, twice with equal bits; a pivot that is not > 0 at column
    0, 100 and D - 1: K5 gives that system a NaN row and the others their
    bits, K4 gives NaN dx and dl."""
    import torch

    from isvins_tpu_torch import ops

    chol_plan_check(dev)
    _, _, k5_rtol, k5_atol = cases["chol_solve_batched"]
    _, _, k4_rtol, k4_atol = cases["linstep"]
    errs = []
    for B, F in ((4, 50), (9, 200)):
        D = 15 * B + 6
        H, b = chol_inputs(dev, 4, D=D)
        x, ref = ops.chol_solve_batched(H, b), ops.chol_solve_batched_ref(H, b)
        _assert_close(f"chol_solve_batched D={D}", (x,), (ref,), k5_rtol, k5_atol)
        a = small_linstep_inputs(dev, B, F)
        out, ref4 = ops.linstep(*a), ops.linstep_ref(*a, D)
        _assert_close(f"linstep D={D}", out, ref4, k4_rtol, k4_atol)
        if not (torch.equal(ops.chol_solve_batched(H, b), x)
                and all(torch.equal(o, o2) for o, o2 in zip(ops.linstep(*a), out))):
            raise AssertionError(f"K4 or K5 at D={D}: two runs differ")
        errs.append(f"D={D}: K5 {_max_err((x,), (ref,)):.3g}, K4 {_max_err(out, ref4):.3g}")
    print(f"[kernels] K5 (NB = 4) and K4 at small windows, max abs err {'; '.join(errs)}; "
          "repeat bit for bit")
    H, b = chol_inputs(dev, 8)
    good = ops.chol_solve_batched(H, b)
    lin = small_linstep_inputs(dev, 18, 1000)
    D, keep = H.shape[-1], [n for n in range(8) if n != 3]
    for col in (0, 100, D - 1):
        Hb = H.clone()
        Hb[3, col, col] = -1.0
        x = ops.chol_solve_batched(Hb, b)
        Hl = lin[0].clone()
        Hl[col, col] = -1e6
        dx, dl = ops.linstep(Hl, *lin[1:])
        torch.cuda.synchronize()
        if not bool(torch.isnan(x[3]).all()) or not torch.equal(x[keep], good[keep]):
            raise AssertionError(f"chol_solve_batched: a bad pivot at column {col} must give "
                                 "one NaN row and leave the others' bits")
        if not (bool(torch.isnan(dx).all()) and bool(torch.isnan(dl).all())):
            raise AssertionError(f"linstep: a bad pivot at column {col} must give NaN dx, dl")
    print("[kernels] a bad pivot at column 0, 100 and D - 1: K5 gives that system a NaN row "
          "and the other seven their bits; K4 gives NaN dx and dl")


def linstep_chain_library(args):
    """The library time of K4's chain alone: cholesky_solve(b_s,
    cholesky_ex(H_dd)[0]) on K4's own damped system (H_dd, b_s formed here
    as linstep_ref forms them; K4 also runs K3 and dl, which this leaves
    out)."""
    import torch

    from isvins_tpu_torch import ops

    H, b, W, h, b_l, lam, n_pose = args
    D, Dr = H.shape[0], W.shape[1]
    ex0 = D - (Dr - n_pose)
    h_d = h * (1.0 + lam)
    C, c_b = ops.schur_corr_ref(W, torch.where(h_d > 1e-12, h_d, torch.ones_like(h_d)), b_l)
    red = torch.cat([torch.arange(n_pose), torch.arange(ex0, D)]).to(H.device)
    H_dd, b_s = H.clone(), b.clone()
    H_dd[red[:, None], red[None, :]] -= C
    b_s[red] -= c_b
    d = torch.diagonal(H_dd)
    d += lam * torch.clamp(torch.diagonal(H), min=1e-8)
    d += 1e-12 * d.sum() / D
    ms, how = graph_or_eager_ms(
        lambda: torch.cholesky_solve(b_s[:, None], torch.linalg.cholesky_ex(H_dd)[0]), 100,
        "K4's chain library call")
    print(f"[kernels] linstep: library call for its chain alone (cholesky_solve(b_s, "
          f"cholesky_ex(H_dd)[0]) on K4's own H_dd): {ms * 1e3:.2f} us ({how})")
    return {"chain_library_ms": ms, "chain_library_timing": how}


def phase_kernels(dev):
    """Each kernel against its plain version on the same card inputs."""
    import torch

    from isvins_tpu_torch import ops

    inp, cases = kernel_cases(dev)
    launch_floor(dev)
    records = {name: _measure(name, *case[:2], inp[name], *case[2:])
               for name, case in cases.items()}
    schur_shape_checks(dev)
    # K5 (above at the multiseq path's batch of bare windows) also at the
    # coordinated estimators' batch and at 1, 8 and 32; a system that is not
    # SPD gives a NaN row and leaves the others alone
    for NB in sorted({1, len(MULTISEQ_SEEDS), 8, 32} - {MULTISEQ_NB}):
        print(f"[kernels] chol_solve_batched NB={NB}:")
        _measure("chol_solve_batched", *cases["chol_solve_batched"][:2], chol_inputs(dev, NB),
                 *cases["chol_solve_batched"][2:])
    chol_checks(dev, cases)
    records["linstep"].update(linstep_chain_library(inp["linstep"]))
    # K1 and K2 at the batched paths' flattened rows: the coordinated
    # estimators' sequences and the bare windows', each sequence with its own
    # extrinsic and gravity
    n1 = inp["proj_rows"][0].shape[0]
    for S in (len(MULTISEQ_SEEDS), MULTISEQ_NB):
        per_seq = lambda t, step: (t.reshape(S, -1)
                                   + step * torch.arange(S, device=dev)[:, None])
        a1 = [t.repeat((S,) + (1,) * (t.dim() - 1)) for t in inp["proj_rows"]]
        a1[6], a1[7] = per_seq(a1[6], 0.001), per_seq(a1[7], 0.001)
        print(f"[kernels] proj_rows, {S} sequences x {n1} rows:")
        _measure("proj_rows", ops.proj_rows, ops.proj_rows_ref, a1, *cases["proj_rows"][2:],
                 plain_reps=20)
        a2 = [t.repeat((S,) + (1,) * (t.dim() - 1)) for t in inp["imu_rows"]]
        a2[-1] = per_seq(a2[-1], 0.01)
        print(f"[kernels] imu_rows, {S} sequences x {inp['imu_rows'][0].shape[0]} factors:")
        _measure("imu_rows", ops.imu_rows, ops.imu_rows_ref, a2, *cases["imu_rows"][2:])
    rows_checks(dev, cases)
    # K6 (above at K = 23) also at one keyframe (the path's first query, a
    # one-block grid), the slice's capacity and the default one
    # (PoseGraphConfig.max_keyframes)
    for K in (1, 256, 4096):
        args = retrieval_inputs(dev, K)
        print(f"[kernels] retrieval_scores K={K}:")
        _measure("retrieval_scores", *cases["retrieval_scores"][:2], args, 0.0, lambda r: 0.0,
                 plain_reps=20)
        if K >= 18 and not float(ops.retrieval_scores_ref(*args)[3]) > 0.9:
            raise AssertionError(f"retrieval_scores at K={K}: planted duplicate not found")
    return records


def phase_profiler(dev, records):
    """torch.profiler's device time of each kernel's own launches beside its
    graph-replay time, into records[name]["profiler_ms"]. Last of all
    phases: once the profiler has attached its tracing to the process, the
    host may pay for it on every later launch."""
    inp, cases = kernel_cases(dev)
    for name, case in cases.items():
        rec = records[name]
        rec["profiler_ms"] = profiler_ms(name, lambda: case[0](*inp[name]))
        print(f"[profiler] {name}: {rec['profiler_ms'] * 1e3:.2f} us of device time per call in "
              f"{PROFILER_NAMES[name]} beside {rec['ms'] * 1e3:.2f} us by graph replay")


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
    expect = dict.fromkeys(counts, 0)
    expect.update(proj_rows=it + 1, imu_rows=it + 1, schur_corr=it, linstep=it)
    print(f"[solve] iterations={it} cost={float(cost):.6g} launches={counts} expected={expect}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    if not all(bool(torch.isfinite(a).all()) for a in st) or not np.isfinite(float(cost)):
        raise AssertionError("non-finite solve output")
    # the same solve again: the same bits (the segment sums' order is fixed)
    st2, cost2 = solve_window(*args, dims, iters=10)
    rerun = max(float((a - b).abs().max()) for a, b in zip((*st, cost), (*st2, cost2)))
    print(f"[solve] solve_rerun_max_abs_diff={rerun:.3g} (state and cost of a second run)")
    if rerun != 0.0:
        raise AssertionError(f"two runs of the same solve differ by {rerun}")
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
    return {"vio_window_solve_frames_per_s": 1.0 / med, "solve_median_ms": med * 1e3,
            "solve_rerun_max_abs_diff": rerun}


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


def phase_reduce(dev):
    """K7's own path (it has no caller in the package, as its TPU kernel has
    none): one LM linear step of a product window taken unfused in the full
    layout. schur_reduce (K7) eliminates the landmarks from the window's
    normal equations, with W widened from the reduced layout [pose | ex] to
    the D columns; the damped system is solved by chol_solve_batched (K5,
    NB = 1); the step must equal the fused K4 step on the same inputs within
    K4's tolerance (2e-3 of the largest entry, rtol 2e-3)."""
    import torch

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.parallel import make_batch_problem
    from isvins_tpu_torch.solver import WindowDims, build_normal_equations

    dims = WindowDims(18, 8, 1000, 3072)
    prob = make_batch_problem(1, dims, torch.float32, device=dev)
    args = [_squeeze(x) for x in prob[:4]] + list(prob[4:])
    H, b, h, W, b_l, _ = build_normal_equations(*args, dims)
    n_pose, D = 6 * dims.B, dims.D
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    W_full = torch.zeros((dims.F, D), dtype=torch.float32, device=dev)
    W_full[:, :n_pose] = W[:, :n_pose]
    W_full[:, 15 * dims.B:] = W[:, n_pose:]
    ops.reset_launch_counts()  # just before the path
    H_s, b_s = ops.schur_reduce(H, b, W_full, h * (1.0 + lam), b_l)
    d = torch.diagonal(H_s)  # a view: damping and jitter in place, as linstep_ref
    d += lam * torch.clamp(torch.diagonal(H), min=1e-8)
    d += 1e-12 * d.sum() / D
    dx = ops.chol_solve_batched(H_s[None], b_s[None])[0]
    torch.cuda.synchronize()
    counts = ops.launch_counts()  # just after the path
    dx_ref, _ = ops.linstep(H, b, W, h, b_l, lam, n_pose)
    _assert_close("reduce step", (dx,), (dx_ref,), 2e-3, lambda r: 2e-3 * float(r.abs().max()))
    print(f"[reduce] K7 + K5 step against the fused K4 step: max_abs_err="
          f"{_max_err((dx,), (dx_ref,)):.3g} (max |dx| {float(dx_ref.abs().max()):.3g}; equal "
          f"bit for bit: {torch.equal(dx, dx_ref)}) launches={counts}")
    if counts["schur_reduce"] != 1 or counts["chol_solve_batched"] != 1:
        raise AssertionError(f"the reduce path did not launch K7 and K5 once: {counts}")
    return counts


def _sync(dev):
    import torch

    torch.cuda.synchronize(dev)


def _median_s(fn, reps, dev):
    """Median host-clock seconds of fn() ending in a synchronize."""
    import numpy as np

    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


EARLY_TOL, EARLY_COST_RTOL = 2e-4, 1e-3


def _early_agreement(dev, dims, trees, G, psi, row):
    """Batched against single, sequence by sequence, in f32 on the card,
    BEFORE the two paths part ways: after 1, 2 and 3 LM iterations. Held for
    every sequence: the frame states (P in m, Q, V in m/s, Ba, Bg, and the
    extrinsic) within EARLY_TOL at each of the three, the inverse depths
    within EARLY_TOL after the first, the cost within EARLY_COST_RTOL
    relative. From the second iteration on the inverse depths of weakly
    observed landmarks part between the two paths (K5 and the plain Schur
    step against K4 round differently, and those landmarks amplify it), so
    that gap is printed only.

    Each path runs twice and must give the same bits both times (the
    segment sums of the normal equations add in a fixed order): the
    reruns' largest gaps, `_batched_rerun_gap` and `_dep_single_rerun_gap`,
    must read 0."""
    import torch

    from isvins_tpu_torch.parallel import sharded_batch_solve
    from isvins_tpu_torch.solver import solve_window

    NB = trees[0].P.shape[0]
    rec, bad = {}, []
    per_seq = lambda x, y: (x - y).abs().reshape(NB, -1).amax(dim=1)
    largest = lambda a, b: max(float((x - y).abs().max()) for x, y in zip((*a[0], a[1]),
                                                                          (*b[0], b[1])))
    for k in (1, 2, 3):
        step = sharded_batch_solve([dev], dims, iters=k)[0]
        batched = [step(*trees, G, psi) for _ in range(2)]
        runs = [[solve_window(*row(trees, n), G, psi, dims, iters=k) for n in range(NB)]
                for _ in range(2)]
        singles = [([torch.stack(leaf) for leaf in zip(*(s for s, _ in r))],
                    torch.stack([c for _, c in r])) for r in runs]
        b_rerun, s_rerun = largest(*batched), largest(*singles)
        (st, cost), (solo, c) = batched[0], singles[0]
        fields = st._fields
        gaps = {f: per_seq(x, y) for f, x, y in zip(fields, st, solo)}
        c_rel = float(((cost - c).abs() / c).max())
        frames = torch.stack([g for f, g in gaps.items() if f != "dep"]).amax(dim=0)
        print(f"[multiseq] after {k} LM iteration(s), batched f32 vs single f32, largest gap "
              f"of any sequence: frame states {float(frames.max()):.3g} (sequence "
              f"{int(frames.argmax())}; median over sequences {float(frames.median()):.3g}), "
              f"inverse depths {float(gaps['dep'].max()):.3g}, rel cost {c_rel:.3g}; per leaf: "
              + ", ".join(f"{f} {float(gaps[f].max()):.2g}" for f in gaps)
              + f"; a second run of each path: largest gap {b_rerun:.3g} batched, "
              f"{s_rerun:.3g} single")
        rec.update({f"multiseq_early{k}_frame_state_gap": float(frames.max()),
                    f"multiseq_early{k}_dep_gap": float(gaps["dep"].max()),
                    f"multiseq_early{k}_dep_single_rerun_gap": s_rerun,
                    f"multiseq_early{k}_batched_rerun_gap": b_rerun,
                    f"multiseq_early{k}_rel_cost_gap": c_rel})
        if not (float(frames.max()) <= EARLY_TOL and c_rel <= EARLY_COST_RTOL
                and (k > 1 or float(gaps["dep"].max()) <= EARLY_TOL)
                and b_rerun == 0.0 and s_rerun == 0.0):
            bad.append(k)
    if bad:
        raise AssertionError(f"after {bad} LM iteration(s) a sequence of the batched solve is "
                             f"further than {EARLY_TOL} from its single solve, or a rerun "
                             "differs")
    return rec


def phase_multiseq_solve(dev, solve_fps, chol_ms):
    """(a) MULTISEQ_NB product windows as one batched program (K1, K2, K5)
    against the same windows solved one by one (K1-K4)."""
    import torch

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.parallel import make_batch_problem, sharded_batch_solve
    from isvins_tpu_torch.solver import WindowDims, solve_window
    from isvins_tpu_torch.utils.convert import tree_map

    dims, NB = WindowDims(18, 8, 1000, 3072), MULTISEQ_NB
    step, shard = sharded_batch_solve([dev], dims, iters=10)
    prob = make_batch_problem(NB, dims, torch.float32, device=dev)
    trees, G, psi = shard(prob[:4]), prob[4], prob[5]
    first = step(*trees, G, psi)  # warm-up
    ops.reset_launch_counts()  # just before the main path
    info = {}
    st, cost = step(*trees, G, psi, info=info)
    _sync(dev)
    counts = ops.launch_counts()  # just after the main path
    rerun = max(float((a - b).abs().max()) for a, b in zip((*first[0], first[1]), (*st, cost)))
    print(f"[multiseq] NB={NB}: a second run of the batched solve differs by {rerun:.3g}")
    if rerun != 0.0:
        raise AssertionError(f"two runs of the same batched solve differ by {rerun}")
    it = info["iterations"]
    expect = dict.fromkeys(counts, 0)
    expect.update(proj_rows=it + 1, imu_rows=it + 1, chol_solve_batched=it)
    print(f"[multiseq] NB={NB} dims={tuple(dims)} iterations={it} launches={counts} "
          f"expected={expect}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    if not all(bool(torch.isfinite(a).all()) for a in st) or not bool(torch.isfinite(cost).all()):
        raise AssertionError("non-finite batched solve output")
    row = lambda ts_, k: [tree_map(lambda a: a[k].contiguous(), t) for t in ts_]
    out = {"multiseq_iterations": it, "multiseq_batched_rerun_max_abs_diff": rerun,
           **_early_agreement(dev, dims, trees, G, psi, row)}
    # the same problems one by one through solve_window (K4 inside), and
    # both ways again in f64 (plain versions, on the same device). The bench
    # problem is weakly constrained along some pose directions, so after 10
    # unconverged iterations two f32 paths with different summation orders
    # sit at different points of one valley (their agreement sequence by
    # sequence is held above, before they part); what can be held tightly
    # here is (1) in f64 the batched rows ARE the single solves (cost 1e-9,
    # P 1e-6), and (2) the batched f32 solve is as close to the f64 answer as the
    # single f32 solves are: within 3x their gap, in cost (the largest of
    # the sequences) and in position (the median over the sequences of each
    # one's largest |dP|: the largest of 16 is heavy-tailed).
    f64 = lambda t: tree_map(lambda a: a.double() if a.is_floating_point() else a, t)
    trees64, G64, psi64 = f64(trees), G.double(), psi.double()
    solo = [solve_window(*row(trees, k), G, psi, dims, iters=10) for k in range(NB)]
    solo64 = [solve_window(*row(trees64, k), G64, psi64, dims, iters=10) for k in range(NB)]
    st64, cost64 = step(*trees64, G64, psi64)
    init_cost = torch.stack([solve_window(*row(trees, k), G, psi, dims, iters=0)[1]
                             for k in range(NB)])
    ref_cost = torch.stack([c for _, c in solo64])
    ref_P = torch.stack([s.P for s, _ in solo64])
    rel = lambda c: float(((c.double() - ref_cost).abs() / ref_cost).max())
    gaps = lambda P: (P.double() - ref_P).abs().amax(dim=(1, 2))  # per sequence
    gap, mid = (lambda P: float(gaps(P).max())), (lambda P: float(gaps(P).median()))
    solo_P = torch.stack([s.P for s, _ in solo])
    rel64, dP64 = rel(cost64), gap(st64.P)
    own_rel, own_dP, own_mid = rel(torch.stack([c for _, c in solo])), gap(solo_P), mid(solo_P)
    b_rel, b_dP, b_mid = rel(cost), gap(st.P), mid(st.P)
    print(f"[multiseq] f64 batched vs f64 one by one: max rel cost diff={rel64:.3g} "
          f"max|dP|={dP64:.3g} m")
    print(f"[multiseq] against the f64 single solves: batched f32 rel cost diff={b_rel:.3g} "
          f"max|dP|={b_dP:.3g} m (median over sequences {b_mid:.3g}); single f32 solves rel "
          f"cost diff={own_rel:.3g} max|dP|={own_dP:.3g} m (median {own_mid:.3g}); cost "
          f"{float(init_cost.mean()):.6g} -> {float(cost.mean()):.6g} (mean of {NB})")
    if not (rel64 < 1e-9 and dP64 < 1e-6):
        raise AssertionError(f"f64: batched rows are not the single solves: {rel64}, {dP64}")
    if not (b_rel <= 3 * own_rel + 1e-6 and b_mid <= 3 * own_mid + 1e-6
            and bool((cost < init_cost).all())):
        raise AssertionError(f"f32 batched solve is further from the f64 answer than the "
                             f"single f32 solves: {b_rel} vs {own_rel}, {b_mid} vs {own_mid}")
    out.update({"multiseq_f64_rel_cost_diff": rel64,
           "multiseq_f32_rel_cost_diff": b_rel, "multiseq_f32_max_dP_m": b_dP,
           "multiseq_f32_median_dP_m": b_mid,
           "multiseq_single_f32_rel_cost_diff": own_rel, "multiseq_single_f32_max_dP_m": own_dP,
           "multiseq_single_f32_median_dP_m": own_mid})
    for nb in (8, 16, 32):
        p = make_batch_problem(nb, dims, torch.float32, device=dev)
        t, g, ps = shard(p[:4]), p[4], p[5]
        step(*t, g, ps)
        med = _median_s(lambda: step(*t, g, ps), 10, dev)
        out[f"batched_x{nb}_throughput"] = nb / med
        print(f"[multiseq] batched_x{nb}_throughput={nb / med:.2f} frames/s (median "
              f"{med * 1e3:.3f} ms over 10 batched solves) beside "
              f"vio_window_solve_frames_per_s={solve_fps:.2f}")
    med_nb = NB / out[f"batched_x{NB}_throughput"]
    out["chol_share_of_batched_iteration"] = chol_ms * 1e-3 * it / med_nb
    print(f"[multiseq] K5 at NB={NB}: {chol_ms * 1e3:.2f} us x {it} iterations = "
          f"{out['chol_share_of_batched_iteration'] * 100:.2f} % of the batched solve")
    return counts, out


def phase_multiseq_estimators(dev, n_frames=40, n_landmarks=1800, seeds=MULTISEQ_SEEDS):
    """(b) four Estimators at the EuRoC window on four seeded worlds, their
    steady solves deferred to MultiSequenceSolver (one batched solve per
    frame through K1, K2, K5), against the same four run alone (the
    synchronous estimator, K1-K4)."""
    import numpy as np

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.config import euroc_config
    from isvins_tpu_torch.estimator.estimator import NON_LINEAR, Estimator
    from isvins_tpu_torch.geom.hostmath import mat_to_quat_np
    from isvins_tpu_torch.parallel import MultiSequenceSolver
    from isvins_tpu_torch.utils import perf
    from isvins_tpu_torch.utils.synthetic import make_world, project

    ric = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
    cfg = euroc_config().replace(tic=(0.02, -0.01, 0.01), ric=ric)
    tic, qic = np.asarray(cfg.tic_np), mat_to_quat_np(np.asarray(ric))
    worlds = [make_world(n_frames=n_frames, n_landmarks=n_landmarks, seed=s) for s in seeds]

    def make(world, **kw):
        est = Estimator(cfg, device=dev, **kw)

        def gt_init(e):
            e.set_ground_truth_init(world.P, world.Q, world.V)
            e.f_manager.depth[:] = -1.0

        est._gt_init = gt_init
        return est

    def feed(est, world, k):
        if k > 0:
            for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                est.process_imu(world.imu_dts[k - 1][s], world.imu_accs[k - 1][s],
                                world.imu_gyrs[k - 1][s])
        pts, _, vis = project(world, k, tic, qic)
        return est.process_image(np.where(vis)[0], pts[vis], world.frame_times[k])

    def drive(ests, coord):
        """Positions of the newest frame after every steady frame, per
        estimator; the batch sizes step() returned; seconds per steady frame."""
        pos, sizes, secs = [[] for _ in ests], [], []
        for k in range(n_frames):
            steady = all(e.solver_flag == NON_LINEAR for e in ests)
            _sync(dev)
            t0 = time.perf_counter()
            for e, w in zip(ests, worlds):
                feed(e, w, k)
            if coord is not None:
                n = coord.step(ests)
                if steady:
                    sizes.append(n)
            _sync(dev)
            if steady:
                secs.append(time.perf_counter() - t0)
            for e, p in zip(ests, pos):
                if e.solver_flag == NON_LINEAR:
                    p.append((k, e.latest_pose()[1].copy()))
        for e in ests:
            e.close()
        return pos, sizes, secs

    alone = [make(w) for w in worlds]
    pos_a, _, secs_a = drive(alone, None)
    ests = [make(w, solve_async=True) for w in worlds]
    for e in ests:
        e._defer_dispatch = True
    coord = MultiSequenceSolver([dev])
    # the launch counts of the coordinated drive's steady frames: set to 0
    # when the last estimator has initialized (the init frame solves alone)
    real_step, at_steady = coord.step, {}

    def counted_step(es):
        if not at_steady and all(e._solve_pending is not None for e in es):
            ops.reset_launch_counts()  # just before the main path
            at_steady["k"] = True
        return real_step(es)

    coord.step = counted_step
    perf.reset()
    perf.enable(True)
    try:
        pos_b, sizes, secs_b = drive(ests, coord)
    finally:
        perf.enable(False)
    counts = ops.launch_counts()  # just after the main path
    stats = perf.stats()
    for name in ("mseq.batched_solve", "est.solve_collect", "est.marg_collect", "est.build_proj",
                 "est.mark_outliers", "est.marginalize"):
        st = stats.get(name, {})
        print(f"[multiseq] {name}: n={st.get('count', 0)} median_ms={st.get('median_ms')} "
              f"max_ms={st.get('max_ms')} total_ms={st.get('total_ms')}")
    ates, gaps = [], []
    for w, pa, pb in zip(worlds, pos_a, pos_b):
        if [k for k, _ in pa] != [k for k, _ in pb]:
            raise AssertionError("the coordinated and the solo estimators solved other frames")
        ates.append(float(np.sqrt(np.mean([np.sum((p - w.P[k]) ** 2) for k, p in pb]))))
        gaps.append(max(float(np.linalg.norm(p - q)) for (_, p), (_, q) in zip(pa, pb)))
    print(f"[multiseq] estimators: {len(ests)} worlds seeds={seeds} frames={n_frames} steady "
          f"frames={len(sizes)} step() sizes={sorted(set(sizes))} launches on the steady "
          f"frames={counts}")
    print(f"[multiseq] estimators: est_ate_vio_m per sequence={[round(a, 6) for a in ates]} "
          f"max gap to the solo runs={max(gaps):.3g} m; per steady frame of all sequences: "
          f"coordinated median {float(np.median(secs_b)) * 1e3:.3f} ms, solo median "
          f"{float(np.median(secs_a)) * 1e3:.3f} ms")
    if len(sizes) < 15 or set(sizes) != {len(ests)}:
        raise AssertionError(f"step() did not batch all four on every steady frame: {sizes}")
    if any(e.failure_count for e in ests + alone):
        raise AssertionError("an estimator failed")
    if not all(counts[k] > 0 for k in ops.BATCHED_SOLVE_KERNELS):
        raise AssertionError(f"a kernel of the batched path never launched: {counts}")
    if counts["linstep"] or counts["schur_corr"]:
        raise AssertionError(f"the coordinated steady frames launched K3/K4: {counts}")
    # noiseless worlds, ground-truth init: 5 cm each (PERF.md section 2);
    # coordinated against solo within 5 mm, the bound test_torch_estimator
    # holds two f32 runs of one drive to (summation order, fed back over the
    # drive's frames)
    if not all(a < 0.05 for a in ates) or not max(gaps) < 5e-3:
        raise AssertionError(f"ates {ates}, gap {max(gaps)}")
    return counts, {"multiseq_est_ate_vio_m_max": max(ates), "multiseq_est_gap_m": max(gaps),
                    "multiseq_est_frame_median_ms": float(np.median(secs_b)) * 1e3,
                    "multiseq_solo_frame_median_ms": float(np.median(secs_a)) * 1e3}


def main():
    import torch

    dev, smi = phase_device()
    phase_build()
    records = phase_kernels(dev)
    solve = phase_solve(dev)
    _, sl = phase_slice(dev)
    counts, pg = phase_posegraph(dev)
    ms_counts, ms = phase_multiseq_solve(dev, solve["vio_window_solve_frames_per_s"],
                                         records["chol_solve_batched"]["ms"])
    est_counts, ms_est = phase_multiseq_estimators(dev)
    red_counts = phase_reduce(dev)
    phase_profiler(dev, records)
    # K5's launches are the multiseq path's (both halves), K7's its own
    # path's, the others' the posegraph path's
    counts["chol_solve_batched"] = (ms_counts["chol_solve_batched"]
                                    + est_counts["chol_solve_batched"])
    counts["schur_reduce"] = red_counts["schur_reduce"]
    print(json.dumps({"solve": solve, "slice": sl, "posegraph": pg,
                      "multiseq": {**ms, **ms_est}}))
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
