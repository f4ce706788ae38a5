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
               4096, and on every case of make_retrieval_cases at the K of
               RETRIEVAL_SIZES; its library call is torch._int_mm of the
               unpacked bits, the product alone, and its text line gives
               the CUDA cores' popcount floor; K7 with an empty landmark;
               K1 and K2 also at the
               ragged sizes of ROWS_SIZES and FACTOR_SIZES, with masked
               rows and factors and points at the z clamp, twice with
               equal bits; K3 and K7 also at the
               small and ragged shapes of SCHUR_SHAPES, K3 with and
               without lam, both twice with equal bits and an exactly
               symmetric C; K4 and K5 also at D = 66 and 141 and, on the
               global route (tiles in device memory), at D = 321, 366 and
               486, twice with equal bits, with a bad pivot at columns 0,
               100 and D - 1 on both routes, ops.chol_plan held against
               the C++ geometry, and a full f32 solve_window at all_size
               21; K4's chain alone timed as cholesky_solve(cholesky_ex)
               on its own H_dd, `chain_library_ms`);
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
               launch counts of K1-K4 against the builds/iterations it ran
               (every iteration runs: the loop reads nothing on the host),
               and a second run with the same bits
  5. slice   — the Estimator on a synthetic world at the EuRoC window
               (18/8/1000, N=3072): steady frames through K1-K4 (launches
               = 11, 11, 10, 10 per solve), ATE against ground truth, LM
               iterations taken against run; then one steady solve
               dispatched under torch.cuda.set_sync_debug_mode("error")
               (host time to return beside the solve's stream time), and
               the drive's marginalizations again on the card and on the
               CPU (ROADMAP C10)
  6. posegraph — the estimator's steady frames feeding the PoseGraphBuilder
               at bench.py's e2e configuration with loops on (320x240
               rendered room, 130 frames, 1.34 laps; features from
               `project` and a ground-truth init, a cut that isolates the
               pose graph; the e2e phase runs the tracker on the same
               frames): keyframes, BRIEF,
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
  9. pixels  — the pixels-to-poses path at EuRoC's 752x480
               (realism_bench.py's configuration, the first 60 of the
               system phase's rendered frames): the port's
               System(enable_loop=False, pipeline=True) on the card, its
               FeatureTracker (every steady dispatch under
               set_sync_debug_mode("error")), its measurement alignment and
               an Estimator with no ground-truth hook that self-initializes
               and then solves through K1-K4; held to the JAX package's
               System run of the same drive (pixels_reference.py: init
               frame within 2, ATE within 1.5x + 2 cm) and the first 10
               frames tracked again on the CPU against the card
 10. profiler — torch.profiler's device time of each kernel's own launches
               (`profiler_ms`), the cross-check of the graph-replay times;
               then the kernels of one steady tracker step, counted by the
               profiler, and the card's busy time in it
 11. system  — the whole pipeline with loops on at 752x480 (realism_bench.py's
               configuration and 200-frame world, 1.4 laps): the frames
               written as a EuRoC tree (utils.euroc_fixture) and replayed by
               isvins_tpu_torch.run_euroc.main on the card (native CSV
               parser, PNG decode, System(pipeline=True, pg_thread=True),
               TUM and covariance writers, ATE); frame times, the tracker's
               share, the worker's keyframes, peak memory, and the card's
               busy share over the last 10 frames from one torch.profiler
               trace; held to the JAX package's run_euroc.main on the same
               drive (system_reference.py: init frame within 2, keyframes
               within 10 %, loops >= 1 at a precision no lower, loop ATE
               within 1.5x + 5 cm and under half the keyframe VIO ATE, no
               stalling frame); the first PnP of a fresh process with and
               without the builder's prewarm
 12. realism — realism_bench.py's drive (ROADMAP A8) through
               isvins_tpu_torch.realism_bench on the system phase's world and
               frames, in memory, with System(solve_async=True): its fields
               beside the system phase's synchronous drive, the largest pose
               gap between the two (printed only), the marginalization wait
               and the worker's keyframes; held to the JAX package's run
               (realism_reference.py: init frame within 2, keyframes within
               10 %, loops >= 1 at a precision no lower, loop ATE within
               1.5x + 5 cm and under half the keyframe VIO ATE, no stalling
               frame), launches by the steady solves and K6's queries
 13. pgdist  — the pose graph across devices (ROADMAP A5), the card listed nd
               times in one process: scaling_bench.py's product
               configuration (K = 1024, 64 loops, 3 iterations, with
               covariance) through the edge-sharded dense solve and the
               nested-dissection solve at nd = 2, 4, 8, in f64 against the
               f64 solve on ["cpu"] * 8 at the reference tests' tolerances
               and in f32 (timed) within the f32 bounds; the 4096-pose
               clamp, dd against dense on the card; the router's async dd
               dispatch of a 600-keyframe graph under
               set_sync_debug_mode("error"), held to the dense route and to
               the f64 router, the loop closed; wall, enqueue, busy time,
               kernels per solve, peak memory; no K1-K7 launch
 14. scaling — scaling_bench.py and __graft_entry__.py's dry run (ROADMAP A9)
               through isvins_tpu_torch.scaling_bench and .multichip over
               every card torch sees (one card: listed nd times): dense
               against dd at K = 256 and 1024 in f64 (held within the
               reference tests' tolerances), 16 product windows over nd = 1,
               2, 4, 8 (the rows held to the nd = 1 batch within 3x the single
               f32 solves' gap to f64; each dispatched again under
               set_sync_debug_mode("error")), the dd solve's per-device
               programs by graph replay, dryrun_multichip(4)
 15. e2e     — bench.py's end-to-end stage through isvins_tpu_torch.bench on
               the posegraph phase's 130 rendered frames: System(
               enable_loop=True, pipeline=True, pg_thread=True,
               solve_async=True), every steady solve dispatch under
               set_sync_debug_mode("error"), every K6 query replayed
               exactly; then the same frames with solve_async=False; prints
               bench.py's two JSON lines (the headline from the solve and
               multiseq phases' numbers) and the sync drive's frame times;
               held to the JAX package's run (bench_reference.py: init frame
               within 2, keyframes within 10 %, loops >= 1 at a precision no
               lower, both ATEs within 1.5x + 5 cm), to the sync drive
               (poses within 1e-9, the same keyframes and loops) and to no
               stalling frame
 16. retrieval — retrieval_bench.py's loop sweep at 250 keyframes through
               isvins_tpu_torch.retrieval_bench on the card (corners and BRIEF
               on the card, tf-idf retrieval, PnP verification); held to the
               JAX package's sweep (retrieval_reference.py: the same
               keyframes and queries with a true revisit, recalls within
               0.01, verified precision within 0.005, loops within 2 %,
               median relative-pose errors within 1.5x)
An earlier line: {"launch_floor_ms": {"graph": t, "eager": t}}.
Second-to-last line: one JSON object with the per-kernel records of all
seven kernels (launches: K1-K4 and K6 from the posegraph path, K5 from the
multiseq path, K7 from the reduce path; launches_pixels, launches_system,
launches_pgdist, launches_e2e, launches_retrieval, launches_realism and
launches_scaling from those paths);
last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from isvins_tpu_torch.realism_bench import realism_config as system_config  # noqa: E402
from isvins_tpu_torch.scaling_bench import posegraph_problem  # noqa: E402,F401
from isvins_tpu_torch.utils.timing import graph_ms  # noqa: E402

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
# tensor cores, int8 on the tensor cores (dense), and HBM3. K6's product of
# bits runs on the tensor cores (binary wgmma, for which the data sheet gives
# no rate): its bound counts it as the int8 product of 0/1 bytes.
PEAK_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# popc per clock per SM on the CUDA cores (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0): K6's floor
# were it xor + popcount there
POPC_PER_CLOCK_SM = 16

# The multiseq path's batches: (a) this many bare product windows, (b) one
# estimator per seeded world. The kernels phase checks K1, K2 and K5 at both
# sequence counts.
MULTISEQ_NB = 16
MULTISEQ_SEEDS = (11, 12, 13, 14)

CARD = {}  # SM count and clocks, read by phase_device


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
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    CARD["sm_clock_mhz"], CARD["max_sm_clock_mhz"] = (float(x) for x in clocks.split(","))
    CARD["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[device] SM clock {CARD['sm_clock_mhz']:.0f} MHz (max {CARD['max_sm_clock_mhz']:.0f}), "
          f"{CARD['sms']} SMs")
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


PROFILER_SESSIONS = 3  # sessions profiler_ms may take to see every kernel of a wrapper


def profiler_ms(name, fn, reps=20):
    """torch.profiler's device time of the wrapper's own kernels per call:
    the cross-check of graph_ms (it leaves out the gaps between launches).
    On the H100 a session has recorded no launch of a ctypes kernel that
    ran (each kernel's launches are counted by its wrapper): in 2 of 4 runs
    of the whole script one wrapper's session came back without its
    kernel, a different wrapper each time. So a wrapper gets up to
    PROFILER_SESSIONS sessions, each printed, and fails if none sees every
    one of its kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(
        e, "self_cuda_time_total", 0)
    fn()
    torch.cuda.synchronize()
    for session in range(1, PROFILER_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = {k: [e for e in prof.key_averages() if k in e.key] for k in PROFILER_NAMES[name]}
        missing = [k for k, h in hits.items() if not h]
        if not missing:
            # mean per recorded launch, summed over the kernels
            return sum(sum(dev_us(e) for e in h) / sum(e.count for e in h)
                       for h in hits.values()) / 1e3
        print(f"[profiler] {name}: session {session} recorded no launch of {missing}")
    raise AssertionError(f"{name}: torch.profiler recorded no launch of {missing} in "
                         f"{PROFILER_SESSIONS} sessions")


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
        # the product of (R x 256) query bits by (256 x R K) database bits
        return (K + 1) * (R * words * 4 + R) + K * 4, 2 * K * R * R * words * 32
    if name == "schur_reduce":
        F, D = args[2].shape
        return (2 * D * D + F * D + 2 * F + 2 * D) * 4, 2 * F * D * D + 2 * F * D
    raise KeyError(name)


def kernel_bound(name, args):
    """bound_ms and which side bounds it, from this call's inputs."""
    nbytes, nops = kernel_work(name, args)
    peak = PEAK_INT8_OPS if name == "retrieval_scores" else PEAK_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, nops / peak * 1e3
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
    if name == "retrieval_scores":  # the product alone: <a, b> of every pair, int8
        qd, _, dbd, _, _ = args
        A, B = unpack_bits(qd), unpack_bits(dbd.reshape(-1, qd.shape[1]))
        try:  # a yardstick only: a shape the library refuses leaves it out
            torch._int_mm(A, B.T)
        except RuntimeError as e:
            print(f"[kernels]   torch._int_mm refused the product: {str(e).splitlines()[0][:120]}")
            return None
        return lambda: torch._int_mm(A, B.T)
    return None


def unpack_bits(words):
    """(n, 8) int32 descriptor words -> (n, 256) int8 0/1, on their device."""
    import torch

    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1).to(torch.int8).contiguous()


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
    if name == "retrieval_scores":  # the CUDA cores' floor at the card's top SM clock: text only
        R, words = args[0].shape
        floor_ms = (R * R * words * args[2].shape[0] / POPC_PER_CLOCK_SM
                    / CARD["sms"] / (CARD["max_sm_clock_mhz"] * 1e6) * 1e3)
        lib_txt += f" popc floor {floor_ms * 1e3:.3f} us (computed)"
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


# K4's and K5's widths beyond the product window's 276: the small windows
# (B = 4, 9), the largest of the shared route, and B = 21, 24, 32 on the
# global route (the tiles in a device-memory scratch)
CHOL_WIDE = (321, 366, 486)


def chol_plan_check(dev, widths=(66, 141, 276, 320) + CHOL_WIDE):
    """ops.chol_plan (Python) and chol_plan of csrc/chol.cuh (C++, through
    isv_chol_plan) must give the same layout and route for every D this
    script runs."""
    import torch

    from isvins_tpu_torch.ops import _lib
    from isvins_tpu_torch.ops.chol_batched import chol_plan

    for D in widths:
        out = torch.zeros(5, dtype=torch.int32)
        _lib.launch("isv_chol_plan", D, out, device=dev)
        if tuple(out.tolist()) != tuple(chol_plan(D)):
            raise AssertionError(f"chol_plan({D}): C++ {out.tolist()} != Python {chol_plan(D)}")
    print(f"[kernels] chol_plan: Python and C++ agree at D = {widths}: "
          f"{[(D, chol_plan(D).route, tuple(chol_plan(D))) for D in widths]} "
          "(nb, Dp, tiles, smem_bytes, scratch_floats)")


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
    for B in (18, 32):  # both routes
        H, b = chol_inputs(dev, 8, D=15 * B + 6)
        good = ops.chol_solve_batched(H, b)
        lin = small_linstep_inputs(dev, B, 1000)
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
                raise AssertionError(f"chol_solve_batched D={D}: a bad pivot at column {col} "
                                     "must give one NaN row and leave the others' bits")
            if not (bool(torch.isnan(dx).all()) and bool(torch.isnan(dl).all())):
                raise AssertionError(f"linstep D={D}: a bad pivot at column {col} must give "
                                     "NaN dx, dl")
    print("[kernels] a bad pivot at column 0, 100 and D - 1, at D = 276 and 486: K5 gives that "
          "system a NaN row and the other seven their bits; K4 gives NaN dx and dl")


def chol_wide_checks(dev, cases, records):
    """K4 and K5 on the global route, D = CHOL_WIDE (all_size 21, 24, 32):
    against their plain versions at the reference's tolerances (2e-3 of the
    largest entry, rtol 2e-3), twice with equal bits, timed by graph replay
    (K5 at NB = 1 and 16, K4 at F = 1000) into records[name]["at_D"]; then a
    full f32 solve_window at all_size 21 on make_batch_problem."""
    import numpy as np
    import torch

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.ops.chol_batched import chol_plan
    from isvins_tpu_torch.parallel.sharded import make_batch_problem
    from isvins_tpu_torch.solver import WindowDims, solve_window

    _, _, k5_rtol, k5_atol = cases["chol_solve_batched"]
    _, _, k4_rtol, k4_atol = cases["linstep"]
    records["linstep"]["at_D"], records["chol_solve_batched"]["at_D"] = {}, {}
    for D in CHOL_WIDE:
        B = (D - 6) // 15
        H, b = chol_inputs(dev, MULTISEQ_NB, D=D)
        x, ref = ops.chol_solve_batched(H, b), ops.chol_solve_batched_ref(H, b)
        _assert_close(f"chol_solve_batched D={D}", (x,), (ref,), k5_rtol, k5_atol)
        a = small_linstep_inputs(dev, B, 1000)
        out, ref4 = ops.linstep(*a), ops.linstep_ref(*a, D)
        _assert_close(f"linstep D={D}", out, ref4, k4_rtol, k4_atol)
        if not (torch.equal(ops.chol_solve_batched(H, b), x)
                and all(torch.equal(o, o2) for o, o2 in zip(ops.linstep(*a), out))):
            raise AssertionError(f"K4 or K5 at D={D}: two runs differ")
        H1, b1 = H[:1].contiguous(), b[:1].contiguous()
        t5 = {NB: graph_ms(lambda: ops.chol_solve_batched(Hn, bn))
              for NB, (Hn, bn) in ((1, (H1, b1)), (MULTISEQ_NB, (H, b)))}
        t4 = graph_ms(lambda: ops.linstep(*a))
        records["chol_solve_batched"]["at_D"][D] = {"ms": t5[1], f"ms_NB{MULTISEQ_NB}":
                                                    t5[MULTISEQ_NB],
                                                    "max_abs_err": _max_err((x,), (ref,))}
        records["linstep"]["at_D"][D] = {"ms": t4, "max_abs_err": _max_err(out, ref4)}
        print(f"[kernels] D={D} ({chol_plan(D).route} route): K5 max abs err "
              f"{_max_err((x,), (ref,)):.3g}, {t5[1] * 1e3:.2f} us at NB = 1, "
              f"{t5[MULTISEQ_NB] * 1e3:.2f} us at NB = {MULTISEQ_NB}; K4 max abs err "
              f"{_max_err(out, ref4):.3g}, {t4 * 1e3:.2f} us; both repeat bit for bit")
    dims = WindowDims(21, 8, 1000, 3072)
    prob = make_batch_problem(1, dims, torch.float32, device=dev)
    args = [_squeeze(x) for x in prob[:4]] + list(prob[4:])
    st, cost = solve_window(*args, dims, iters=10)
    c0 = float(solve_window(*args, dims, iters=0)[1])
    print(f"[kernels] solve_window at all_size 21 (D = {dims.D}, {chol_plan(dims.D).route} "
          f"route), f32 on the card: cost {c0:.6g} -> {float(cost):.6g}")
    if not (all(bool(torch.isfinite(a).all()) for a in st) and np.isfinite(float(cost))
            and float(cost) < c0):
        raise AssertionError("the f32 solve at all_size 21 did not run to a finite, lower cost")


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
    chol_wide_checks(dev, cases, records)
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
    retrieval_checks(dev)
    # K6 (above at K = 23) also at one keyframe (the path's first query, a
    # one-block grid), the slice's capacity and the default one
    # (PoseGraphConfig.max_keyframes)
    records["retrieval_scores"]["at_K"] = {}
    for K in (1, 256, 4096):
        args = retrieval_inputs(dev, K)
        print(f"[kernels] retrieval_scores K={K}:")
        rec = _measure("retrieval_scores", *cases["retrieval_scores"][:2], args, 0.0,
                       lambda r: 0.0, plain_reps=20)
        records["retrieval_scores"]["at_K"][K] = {
            k: rec[k] for k in ("ms", "bound_ms", "library_ms", "plain_ms")}
        if K >= 18 and not float(ops.retrieval_scores_ref(*args)[3]) > 0.9:
            raise AssertionError(f"retrieval_scores at K={K}: planted duplicate not found")
    return records


# K6's sizes beyond the path's: one and two keyframes (one and two blocks),
# the path's largest, one grid's worth around 64 and 129 (past a power of
# two), the slice's capacity and the default one
RETRIEVAL_SIZES = (1, 2, 23, 64, 129, 256, 4096)


def retrieval_checks(dev):
    """K6 exactly equal to its plain version on utils.synthetic's
    make_retrieval_cases at every size of RETRIEVAL_SIZES: thresholds 0,
    33, 40, 109, 257 and 600, random and near-duplicate databases, invalid
    database rows and keyframes, every query row invalid."""
    import numpy as np
    import torch

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.utils.synthetic import make_retrieval_cases

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    n = 0
    for K in RETRIEVAL_SIZES:
        for name, (qd, qv, dbd, dbv), thresh in make_retrieval_cases(K):
            args = (t(qd.view(np.int32)), t(qv), t(dbd.view(np.int32)), t(dbv), thresh)
            out, ref = ops.retrieval_scores(*args), ops.retrieval_scores_ref(*args)
            if not torch.equal(out, ref):
                raise AssertionError(f"retrieval_scores K={K} {name} thresh={thresh}: max abs "
                                     f"err {float((out - ref).abs().max()):.3g}")
            n += 1
    print(f"[kernels] retrieval_scores exact on {n} cases at K = {RETRIEVAL_SIZES} (thresholds "
          "0, 33, 40, 109, 257, 600; invalid rows, keyframes and queries)")


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


def nullspace_cost(dev, F=1000, rows=36, reps=20):
    """What device_triangulate's 4x4 nullspace costs per steady solve (one
    call a solve): estimator.min_eigvec_sym4 (the cyclic Jacobi the port
    runs, no host read) against torch.linalg.eigh (which reads its error
    flags on the host on CUDA), on F = 1000 Gram matrices of (36 x 4)
    systems (a track seen in all 18 frames of the EuRoC window). Per call:
    the host's time until it returns (median; eigh's includes its wait for
    the card), the device's time between two events, and torch.profiler's
    counts of host operators and of device kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from isvins_tpu_torch.estimator.estimator import min_eigvec_sym4

    A = torch.as_tensor(np.random.default_rng(0).normal(size=(F, rows, 4)), dtype=torch.float32,
                        device=dev)
    G = A.transpose(-1, -2) @ A
    ways = {"jacobi": lambda: min_eigvec_sym4(G),
            "eigh": lambda: torch.linalg.eigh(G)[1][..., :, 0]}
    rec = {}
    for name, fn in ways.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        host, dev_ms = [], []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            dev_ms.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        avgs = prof.key_averages()
        rec[name] = {"host_ms": float(np.median(host)), "device_ms": float(np.median(dev_ms)),
                     "host_ops": sum(e.count for e in avgs if e.key.startswith("aten::")),
                     "kernels": sum(e.count for e in avgs if e.device_type.name == "CUDA")}
    v, ref = min_eigvec_sym4(G), torch.linalg.eigh(G.double())[1][..., :, 0]
    rec["jacobi_max_err"] = float(torch.minimum((v.double() - ref).abs().amax(-1),
                                                (v.double() + ref).abs().amax(-1)).max())
    print(f"[nullspace] device_triangulate's nullspace, F={F} (36 x 4) systems, once per steady "
          f"solve: Jacobi host {rec['jacobi']['host_ms']:.3f} ms, device "
          f"{rec['jacobi']['device_ms']:.3f} ms, {rec['jacobi']['host_ops']} aten ops, "
          f"{rec['jacobi']['kernels']} kernels; eigh host {rec['eigh']['host_ms']:.3f} ms "
          f"(waits for the card), device {rec['eigh']['device_ms']:.3f} ms, "
          f"{rec['eigh']['host_ops']} aten ops, {rec['eigh']['kernels']} kernels; Jacobi "
          f"against eigh in f64: {rec['jacobi_max_err']:.3g}")
    return rec


def _squeeze(tree):
    if isinstance(tree, tuple):
        return type(tree)(*(_squeeze(x) for x in tree))
    return tree[0].contiguous()


def phase_solve(dev):
    """solve_window at the product window, through K1, K2 and K4 (+K3)."""
    import numpy as np
    import torch

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.bench import median_s
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
    it = 10  # every iteration runs; those after convergence leave the result as it is
    expect = dict.fromkeys(counts, 0)
    expect.update(proj_rows=it + 1, imu_rows=it + 1, schur_corr=it, linstep=it)
    print(f"[solve] iterations taken {int(info['iterations'])} of {it} run; "
          f"cost={float(cost):.6g} launches={counts} expected={expect}")
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
    med = median_s(lambda: solve_window(*args, dims, iters=10), 30, dev)
    print(f"[solve] median {med * 1e3:.3f} ms over 30 solves; "
          f"vio_window_solve_frames_per_s={1.0 / med:.2f}")
    return {"vio_window_solve_frames_per_s": 1.0 / med, "solve_median_ms": med * 1e3,
            "solve_rerun_max_abs_diff": rerun}


def _record_marg(est, snaps):
    """Wrap est._marg_compute so that `snaps` keeps the inputs of every
    marginalization of the drive (for _time_marg_placements after it)."""
    real = est._marg_compute

    def recording(*snap, **kw):
        snaps.append(snap)
        return real(*snap, **kw)

    est._marg_compute = recording
    return real


def _time_marg_placements(real, dev, snaps):
    """ROADMAP C10: every marginalization of the drive computed again, f64,
    on the card and on the CPU in turns (which goes first alternates), on
    the frame thread with nothing else running: per job the forward and
    backward halves (utils/perf phases est.marg_forward, est.marg_backward)
    and the whole call, and the largest gap between the two results
    (relative to 1 + |value|; the sqrt-information factors may differ by an
    orthogonal transform where the information has equal eigenvalues, so
    the gap is printed, not held)."""
    import numpy as np

    from isvins_tpu_torch.utils import perf
    from isvins_tpu_torch.utils.convert import tree_map

    times, gap = {"cuda": [], "cpu": []}, 0.0
    perf.reset()
    perf.enable(True)
    try:
        for n, snap in enumerate(snaps):
            out = {}
            for kind in (("cuda", "cpu") if n % 2 == 0 else ("cpu", "cuda")):
                perf.reset()
                t0 = time.perf_counter()
                out[kind] = real(*snap, device=dev if kind == "cuda" else "cpu")
                total = (time.perf_counter() - t0) * 1e3
                st = perf.stats()
                times[kind].append((st["est.marg_forward"]["total_ms"],
                                    st["est.marg_backward"]["total_ms"], total))
            f64 = lambda a: np.asarray(a, np.float64)
            gaps = []
            tree_map(lambda a, b: gaps.append(float(np.max(np.abs(f64(a) - f64(b))
                                                            / (1.0 + np.abs(f64(b))))))
                     if np.size(a) else None, out["cuda"], out["cpu"])
            gap = max([gap] + gaps)
    finally:
        perf.enable(False)
    rec = {}
    for kind, rows in times.items():
        f, b, tot = (np.array([r[i] for r in rows]) for i in range(3))
        rec[kind] = {"n": len(rows), "forward_median_ms": float(np.median(f)),
                     "backward_median_ms": float(np.median(b)),
                     "median_ms": float(np.median(tot)), "total_ms": float(tot.sum())}
    rec["gap"] = gap
    return rec


def phase_slice(dev, n_frames=60, n_landmarks=1800, seed=7):
    """The Estimator at the EuRoC window on a synthetic world: init through
    the ground-truth hook, then steady frames through K1-K4. After the
    drive, one steady solve is dispatched under
    torch.cuda.set_sync_debug_mode("error"), and every marginalization of
    the drive is computed again on the card and on the CPU
    (_time_marg_placements: ROADMAP C10's placement)."""
    import numpy as np
    import torch

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.config import euroc_config
    from isvins_tpu_torch.estimator.estimator import NON_LINEAR, Estimator
    from isvins_tpu_torch.geom.hostmath import mat_to_quat_np
    from isvins_tpu_torch.utils import perf
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
    feats, used, steady_ms, errs, snaps = [], [], [], [], []
    real_marg = _record_marg(est, snaps)
    perf.reset()
    perf.enable(True)
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
                taken_before, solves_before = est.lm_iterations_taken, est.steady_solves
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
        dispatch = _dispatch_without_host_reads(est, dev)
    finally:
        est.close()
        perf.enable(False)
    stats = perf.stats()
    ate = float(np.sqrt(np.mean(np.square(errs))))
    steady_counts = {k: counts[k] - (at_steady or counts)[k] for k in counts}
    # every steady solve runs all its iterations: K1 = K2 = iters + 1, K3 = K4 = iters
    iters, n_solves = cfg.solver.max_iterations, len(steady_ms)
    taken = est.lm_iterations_taken - taken_before
    if est.steady_solves - solves_before != n_solves:
        raise AssertionError(f"{est.steady_solves - solves_before} solves collected over "
                             f"{n_solves} steady frames")
    expect = dict.fromkeys(counts, 0)
    expect.update(proj_rows=n_solves * (iters + 1), imu_rows=n_solves * (iters + 1),
                  schur_corr=n_solves * iters, linstep=n_solves * iters)
    print(f"[slice] LM iterations over the {n_solves} steady solves: {taken} taken of "
          f"{n_solves * iters} run (mean {taken / n_solves:.2f} a solve); the "
          f"{n_solves * iters - taken} after convergence change no bit")
    if steady_counts != expect:
        raise AssertionError(f"steady-frame launches {steady_counts} != {expect}")
    collect = stats.get("est.marg_collect", {})
    print(f"[slice] the drive's marginalizations on the host CPU (the estimator's "
          f"placement): est.marg_forward median {stats['est.marg_forward']['median_ms']} ms, "
          f"est.marg_backward {stats['est.marg_backward']['median_ms']} ms, the frame's wait "
          f"est.marg_collect median {collect.get('median_ms')} ms, total "
          f"{collect.get('total_ms')} ms over {collect.get('count')} collects")
    marg = _time_marg_placements(real_marg, dev, snaps)
    print(f"[slice] the same {marg['cuda']['n']} marginalizations again, alone, f64 (C10): card "
          f"forward {marg['cuda']['forward_median_ms']:.2f} / backward "
          f"{marg['cuda']['backward_median_ms']:.2f} / whole {marg['cuda']['median_ms']:.2f} ms "
          f"median; CPU {marg['cpu']['forward_median_ms']:.2f} / "
          f"{marg['cpu']['backward_median_ms']:.2f} / {marg['cpu']['median_ms']:.2f} ms; largest "
          f"relative gap between the two results {marg['gap']:.3g}")
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
                    "est_ate_vio_m": ate, "steady_frames": len(steady_ms),
                    "lm_iterations_taken": int(taken),
                    "lm_iterations_run": n_solves * iters,
                    "marg_collect_median_ms": collect.get("median_ms"),
                    "marg_collect_total_ms": collect.get("total_ms"),
                    "marg_cuda_median_ms": marg["cuda"]["median_ms"],
                    "marg_cpu_median_ms": marg["cpu"]["median_ms"], "marg_placements": marg,
                    **dispatch}


def _dispatch_without_host_reads(est, dev):
    """One steady solve of the estimator's current window dispatched under
    torch.cuda.set_sync_debug_mode("error"), so that any host read of the
    device on the way (an .item(), a blocking copy, a linalg error check)
    raises: dispatch_steady must return without waiting for the card. Times
    the dispatch on the host clock beside the solve's stream time (events at
    its start and end) and the wait in collect()."""
    import torch

    from isvins_tpu_torch.estimator.estimator import dispatch_steady
    from isvins_tpu_torch.utils import perf

    was_timing = perf.enabled()
    perf.enable(True)  # dispatch_steady records its timing events while perf is on
    try:
        est._defer_dispatch = True  # build the arguments; this function dispatches them
        est.dispatch_odometry()
        args = est._solve_pending["args"]
        est._solve_pending = None  # never installed: the estimator's state stays as it was
        run = lambda: dispatch_steady(args, dev, est.dims, est.cfg.solver.max_iterations, False,
                                      est.noise, float(est.cfg.solver.max_depth))
        run().collect()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            pending = run()
            t1 = time.perf_counter()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        pending.collect()
        t2 = time.perf_counter()
    finally:
        perf.enable(was_timing)
        est._defer_dispatch = False
    rec = {"dispatch_host_ms": (t1 - t0) * 1e3, "solve_stream_ms": pending.device_ms(),
           "collect_wait_ms": (t2 - t1) * 1e3, "dispatch_iterations": int(pending.iterations)}
    print(f"[slice] dispatch_steady under set_sync_debug_mode('error'): no host read; host "
          f"{rec['dispatch_host_ms']:.2f} ms to return, the solve's stream "
          f"{rec['solve_stream_ms']:.2f} ms from upload to download, then "
          f"{rec['collect_wait_ms']:.2f} ms waited in collect()")
    return rec


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


def phase_posegraph(dev):
    """The estimator's steady frames feeding the pose graph, as
    System._feed_pose_graph feeds it (isvins_tpu/system.py:320-336), at
    bench.py's e2e configuration (isvins_tpu_torch.bench.e2e_config and
    e2e_world: 130 frames, 1.34 laps): every new PoseGraphPacket goes to
    PoseGraphBuilder.push with its keyframe points and the RoomRenderer
    image at the packet's timestamp. A deliberate cut, so that the phase
    isolates the pose graph: features come from `project` (no tracker),
    init through the ground-truth hook, one thread. The `e2e` phase runs
    the tracker and System on the same frames, which this phase renders
    and returns."""
    import numpy as np

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.bench import e2e_config, e2e_world
    from isvins_tpu_torch.estimator.estimator import NON_LINEAR, Estimator
    from isvins_tpu_torch.frontend.camera import make_camera
    from isvins_tpu_torch.geom.hostmath import mat_to_quat_np
    from isvins_tpu_torch.posegraph import PoseGraphBuilder
    from isvins_tpu_torch.posegraph import builder as builder_mod
    from isvins_tpu_torch.utils import perf
    from isvins_tpu_torch.utils.evaluation import ate_rmse
    from isvins_tpu_torch.utils.synthetic import project

    cfg, dims = e2e_config()
    world, renderer = e2e_world()
    n_frames = len(world.frame_times)
    tic, qic = np.asarray(cfg.tic_np), mat_to_quat_np(np.asarray(cfg.ric_np))
    t0 = time.perf_counter()
    frames = [renderer.render(k)[0] for k in range(n_frames)]
    print(f"[posegraph] rendered {n_frames} frames in {time.perf_counter() - t0:.1f} s")

    def image_at(ts):  # the frame at the packet's timestamp
        return frames[int(np.argmin(np.abs(world.frame_times - ts)))].astype(np.float32)

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
    _replay_k6(dev, db, cfg.posegraph, "posegraph")
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
                    "pg_est_median_ms": float(np.median(est_ms)), **opt_err}, frames


def _replay_k6(dev, db, pg, phase):
    """Every K6 query of a drive again, at its own size K = idx -
    skip_recent, from the database's device mirror (which must equal the
    host rows), against the plain version: exact."""
    import numpy as np
    import torch

    from isvins_tpu_torch import ops

    _sync(dev)  # the worker's stream wrote the mirror
    n = db.n
    if not torch.equal(db.ret_desc_dev[:n].cpu(), torch.from_numpy(db.ret_desc[:n].view(np.int32))) \
            or not torch.equal(db.ret_valid_dev[:n].cpu(), torch.from_numpy(db.ret_valid[:n])):
        raise AssertionError("the retrieval device mirror differs from the host rows")
    sizes = []
    for idx in db.match_count_queries:
        hi = idx - pg.skip_recent
        args = (db.ret_desc_dev[idx], db.ret_valid_dev[idx], db.ret_desc_dev[:hi],
                db.ret_valid_dev[:hi], pg.retrieval_match_thresh)
        out, ref = ops.retrieval_scores(*args), ops.retrieval_scores_ref(*args)
        if not torch.equal(out, ref):
            raise AssertionError(f"K6 at query {idx} (K={hi}): max abs err "
                                 f"{float((out - ref).abs().max()):.3g}")
        sizes.append(hi)
    if not sizes:
        raise AssertionError(f"[{phase}] no K6 query to replay")
    print(f"[{phase}] K6 replay: {len(sizes)} queries at K={min(sizes)}..{max(sizes)} equal "
          f"the plain version exactly")


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
    from isvins_tpu_torch.bench import median_s
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
    it = 10  # every iteration runs
    expect = dict.fromkeys(counts, 0)
    expect.update(proj_rows=it + 1, imu_rows=it + 1, chol_solve_batched=it)
    print(f"[multiseq] NB={NB} dims={tuple(dims)} iterations taken per sequence "
          f"{info['sequence_iterations'].tolist()} of {it} run; launches={counts} "
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
        med = median_s(lambda: step(*t, g, ps), 10, dev)
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


# The JAX package's run of the pixels drive on the CPU (pixels_reference.py,
# 60 frames; PERF.md section 4): the frame whose packet it self-initialized
# on (counted by packet, as _watch_init counts it; read after each frame's
# pub_image, which processes the previous frame's packet, the same run says
# 19), the ATE of its solved poses, their count. The pixels phase is held
# to it.
PIXELS_REFERENCE = {"pix_init_frame": 18, "pix_ate_vio_m": 0.12962937335972388,
                    "solved_poses": 41}
PIXELS_FRAMES = 60
PIXELS_CARD_CPU_FRAMES = 10


def pixels_config(fused_ransac=None):
    """realism_bench.py:46-64, the reference's full-resolution configuration
    (isvins_tpu_torch.realism_bench.realism_config: EuRoC cam0 at 752x480
    with radtan distortion, max_cnt 150, min_dist 25, 4 LK levels of 21x21,
    CLAHE; window 18/8/1000, N = 3072; its noise and excitation threshold;
    no ground-truth hook, estimate_extrinsic 0) with the pose graph off."""
    from isvins_tpu_torch.config import PoseGraphConfig

    cfg, dims = system_config(fused_ransac)
    return cfg.replace(posegraph=PoseGraphConfig(enabled=False)), dims


def room_world(n_frames):
    """realism_bench.py:66-74's world and RoomRenderer (realism_bench.
    realism_world: seed 7 world, seed 11 textures at tex_res 512, the
    camera's radtan model), frames rendered in memory before the drives by
    utils.synthetic.RENDER_PROCS processes. make_world's first frames
    (trajectory, IMU) do not depend on n_frames (asserted here; its
    landmarks do, and RoomRenderer draws none), so the pixels phase takes
    the first PIXELS_FRAMES of the system phase's SYSTEM_FRAMES."""
    import numpy as np

    from isvins_tpu_torch.realism_bench import REALISM_WORLD, realism_world, render_frames
    from isvins_tpu_torch.utils.synthetic import make_world

    world = realism_world(n_frames)[0]
    short = make_world(n_frames=PIXELS_FRAMES, **REALISM_WORLD)
    for f in ("frame_times", "P", "Q", "V", "imu_dts", "imu_accs", "imu_gyrs"):
        a = getattr(short, f)
        assert np.array_equal(a, getattr(world, f)[: len(a)]), f
    return world, render_frames(n_frames)


def _watch_init(est, frame_times):
    """Wrap est.process_image: the returned list receives the index of the
    frame whose packet was being processed when the estimator initialized
    (solver_flag NON_LINEAR). Counted by packet, not by call, so a
    pipelined System (which processes frame k's packet during frame k + 1)
    and a synchronous one report the same frame."""
    import numpy as np

    from isvins_tpu_torch.estimator.estimator import NON_LINEAR

    process_image, hit = est.process_image, []
    frame_times = np.asarray(frame_times)

    def watched(ids, pts, t, vels=None):
        out = process_image(ids, pts, t, vels=vels)
        if not hit and est.solver_flag == NON_LINEAR:
            hit.append(int(np.argmin(np.abs(frame_times - t))))
        return out

    est.process_image = watched
    return hit


def _timed_method(obj, name, log, sync):
    """Wrap obj.<name> to append (args, result, wall ms) to log, the card
    synchronized at both ends."""
    orig = getattr(obj, name)

    def timed(*a, **k):
        sync()
        t0 = time.perf_counter()
        out = orig(*a, **k)
        sync()
        log.append((a, k, out, (time.perf_counter() - t0) * 1e3))
        return out

    setattr(obj, name, timed)


def _slot_agreement(card, cpu):
    """Per frame, the tracker packets' slots (in packet order) with equal
    ids, and the position gaps of the ids both have."""
    import numpy as np

    equal = total = 0
    gaps = []
    for a, b in zip(card, cpu):
        n = max(len(a["ids"]), len(b["ids"]))
        m = min(len(a["ids"]), len(b["ids"]))
        equal += int(np.sum(a["ids"][:m] == b["ids"][:m]))
        total += n
        common, ia, ib = np.intersect1d(a["ids"], b["ids"], return_indices=True)
        gaps.extend(np.linalg.norm(a["pts_px"][ia] - b["pts_px"][ib], axis=1))
    return equal / max(total, 1), float(np.median(gaps)), float(np.max(gaps))


def phase_pixels(dev, smi, world, frames, render_s, n_frames=PIXELS_FRAMES):
    """The pixels-to-poses path at EuRoC's 752x480 (pixels_config): the
    first n_frames rendered frames through the port's System(enable_loop=
    False, pipeline=True) on the card: its FeatureTracker (fused RANSAC),
    its measurement alignment, and an Estimator with no ground-truth hook,
    which self-initializes (SfM, alignment) and then solves through K1-K4.
    Every steady tracker dispatch runs under
    torch.cuda.set_sync_debug_mode("error") (no pose-graph worker runs
    here: the mode is process-wide). Afterwards the first frames are
    tracked again on the CPU (the same port, device="cpu", fused RANSAC) and
    compared with the card's packets. Held to the JAX package's System run
    of the same drive (PIXELS_REFERENCE)."""
    import numpy as np
    import torch

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.estimator.estimator import NON_LINEAR
    from isvins_tpu_torch.frontend import FeatureTracker
    from isvins_tpu_torch.system import System
    from isvins_tpu_torch.utils import perf
    from isvins_tpu_torch.utils.evaluation import ate_rmse

    cfg, dims = pixels_config()
    sys_ = System(cfg, dims, enable_loop=False, pipeline=True, device=dev)
    tracker, est = sys_.tracker, sys_.estimator
    assert tracker.fused_ransac and getattr(est, "_gt_init", None) is None
    sync = lambda: torch.cuda.synchronize(dev)
    inits, solves = [], []
    _timed_method(est, "initial_structure", inits, sync)
    _timed_method(est, "solve_odometry", solves, sync)
    init_at = _watch_init(est, world.frame_times[:n_frames])
    card_packets, published, frame_ms, disp_ms, span_ms, wait_ms = [], [], [], [], [], []
    steady_pending, frame = set(), {"k": 0, "collected": 0}
    dispatch, collect = tracker.dispatch, tracker.collect

    def guarded_dispatch(img, t):
        steady = frame["k"] >= 2  # every steady dispatch reads nothing on the host
        if steady:
            torch.cuda.set_sync_debug_mode("error")
        try:
            t1 = time.perf_counter()
            pending = dispatch(img, t)
            t2 = time.perf_counter()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if steady:
            disp_ms.append((t2 - t1) * 1e3)
            steady_pending.add(id(pending))
        return pending

    def timed_collect(pending=None):
        p = tracker._pending
        t0 = time.perf_counter()
        p.wait()
        waited = (time.perf_counter() - t0) * 1e3
        out = collect(pending)
        if id(p) in steady_pending:
            wait_ms.append(waited)
            span_ms.append(p.stream_ms())
        if len(card_packets) < PIXELS_CARD_CPU_FRAMES:
            card_packets.append(out)
        frame["collected"] += 1
        if frame["collected"] > 1:  # System skips the first packet
            published.append(int((out["track_cnt"] > 1).sum()))
        return out

    tracker.dispatch, tracker.collect = guarded_dispatch, timed_collect
    print(f"[pixels] {n_frames} frames {cfg.camera.width}x{cfg.camera.height} (rendered in "
          f"{render_s:.1f} s with the system phase's); dims={tuple(dims)} "
          f"max_cnt={cfg.tracker.max_cnt}; System(pipeline=True)")
    ops.reset_launch_counts()  # just before the main path
    was_timing = perf.enabled()
    perf.enable(True)  # the tracker records its stream's timing events while perf is on
    try:
        for k in range(n_frames):
            sync()
            steady = est.solver_flag == NON_LINEAR
            ta = time.perf_counter()
            if k > 0:
                acc_t = world.frame_times[k - 1]
                for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                    acc_t += world.imu_dts[k - 1][s]
                    sys_.pub_imu(acc_t, world.imu_accs[k - 1][s], world.imu_gyrs[k - 1][s])
            frame["k"] = k
            sys_.pub_image(world.frame_times[k], frames[k])
            sync()
            if steady:
                frame_ms.append((time.perf_counter() - ta) * 1e3)
        sys_.flush()
        counts = ops.launch_counts()  # just after the main path
    finally:
        perf.enable(was_timing)
        torch.cuda.set_sync_debug_mode(0)
        del tracker.dispatch, tracker.collect
        sys_.close()
    init_frame = init_at[0] if init_at else None

    # the first frames again on the CPU, the same route (fused RANSAC)
    cpu_cfg, _ = pixels_config(fused_ransac=True)
    cpu_tracker = FeatureTracker(cpu_cfg.camera, cpu_cfg.tracker, device="cpu")
    cpu_packets = [cpu_tracker.read_image(frames[k], world.frame_times[k])
                   for k in range(PIXELS_CARD_CPU_FRAMES)]
    ids_equal, gap_median, gap_max = _slot_agreement(card_packets, cpu_packets)

    traj = sys_.vio_trajectory
    t_est = np.array([t for (t, _, _) in traj])
    p_est = np.array([P for (_, P, _) in traj])
    ate = float(ate_rmse(t_est, p_est, world.frame_times, world.P, align="se3")) \
        if len(traj) >= 3 else float("nan")
    init_ok = [ms for (_, _, ok, ms) in inits if ok]
    init_solve = [ms for (a, kw, _, ms) in solves if kw.get("first") or (a and a[0])]
    iters = cfg.solver.max_iterations
    n_steady = est.steady_solves
    rec = {
        "pix_init_frame": init_frame, "pix_steady_solves": n_steady,
        "pix_solved_poses": len(traj), "pix_ate_vio_m": ate,
        "pix_tracks_median": float(np.median(published)),
        "pix_frame_median_ms": float(np.median(frame_ms)) if frame_ms else None,
        "trk_dispatch_host_ms": float(np.median(disp_ms)),
        "trk_stream_span_ms": float(np.median(span_ms)),
        "trk_collect_wait_ms": float(np.median(wait_ms)),
        "init_ms": init_ok[0] if init_ok else None,
        "init_attempts": len(inits), "init_attempts_ms": [ms for (*_, ms) in inits],
        "init_solve_ms": init_solve[0] if init_solve else None,
        "trk_card_cpu": {"frames": PIXELS_CARD_CPU_FRAMES, "ids_equal_share": ids_equal,
                         "gap_median_px": gap_median, "gap_max_px": gap_max},
        "launches": counts, "failure_count": int(est.failure_count),
        "render_s": render_s, "reference": PIXELS_REFERENCE,
    }
    print(f"[pixels] self-initialized on frame {init_frame}'s packet (JAX reference "
          f"{PIXELS_REFERENCE['pix_init_frame']}); init {rec['init_ms']} ms over "
          f"{len(inits)} attempts, its solve {rec['init_solve_ms']} ms; {n_steady} steady solves, "
          f"{len(traj)} poses, pix_ate_vio_m={ate:.6f} (reference "
          f"{PIXELS_REFERENCE['pix_ate_vio_m']:.6f}); tracks median {rec['pix_tracks_median']}")
    print(f"[pixels] tracker step (median of {len(disp_ms)} steady frames): dispatch "
          f"{rec['trk_dispatch_host_ms']:.2f} ms on the host under set_sync_debug_mode('error'), "
          f"its stream spans {rec['trk_stream_span_ms']:.2f} ms between events, then "
          f"{rec['trk_collect_wait_ms']:.2f} ms waited; frame (tracker + estimator) median "
          f"{rec['pix_frame_median_ms']} ms; launches {counts}")
    print(f"[pixels] card against CPU over {PIXELS_CARD_CPU_FRAMES} frames: ids equal in "
          f"{ids_equal:.4f} of slots, position gap median {gap_median:.3g} px, max {gap_max:.3g}")
    print(json.dumps({"pixels": rec, "card": smi}))
    expect = dict.fromkeys(counts, 0)
    expect.update(proj_rows=n_steady * (iters + 1), imu_rows=n_steady * (iters + 1),
                  schur_corr=n_steady * iters, linstep=n_steady * iters)
    if init_frame is None or abs(init_frame - PIXELS_REFERENCE["pix_init_frame"]) > 2:
        raise AssertionError(f"self-initialized at frame {init_frame}, the reference at "
                             f"{PIXELS_REFERENCE['pix_init_frame']} (bound: within 2)")
    if n_steady < 30 or est.failure_count != 0:
        raise AssertionError(f"{n_steady} steady solves, failure_count {est.failure_count}")
    if not ate <= 1.5 * PIXELS_REFERENCE["pix_ate_vio_m"] + 0.02:
        raise AssertionError(f"pix_ate_vio_m={ate} > 1.5 x the reference's + 0.02 m")
    if ids_equal < 0.95 or gap_median > 0.05:
        raise AssertionError(f"card and CPU trackers part: ids equal {ids_equal}, median gap "
                             f"{gap_median} px")
    if counts != expect:
        raise AssertionError(f"pixels-path launches {counts} != {expect}")
    return counts, rec, (tracker, frames[n_frames - 1], world.frame_times[n_frames - 1])


def _device_busy(prof):
    """Of a torch.profiler trace's device events (kernels and copies): the
    union of their intervals (ms), their count, and the span from the first
    one's start to the last one's end (ms). Read from the raw kineto events,
    which skips building a torch FunctionEvent for each of a trace's
    ~200,000 events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda)
    busy_ns, end = 0, float("-inf")
    for a, b in spans:
        busy_ns += max(0, b - max(a, end))
        end = max(end, b)
    return busy_ns / 1e6, len(spans), (spans[-1][1] - spans[0][0]) / 1e6 if spans else 0.0


def tracker_launches(dev, trk):
    """The kernels one steady tracker step launches (dispatch and collect of
    the drive's last frame once more, after a warm-up), counted by
    torch.profiler: its device-side events (kernels and copies), beside the
    host's launch calls, and the card's busy time in the step (the union of
    those events' intervals) beside the span from the first to the last."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tracker, img, t = trk
    tracker.read_image(img, t + 0.05)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tracker.read_image(img, t + 0.1)
        torch.cuda.synchronize(dev)
    events = prof.events()
    launches = sum(1 for e in events if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    copies = sum(1 for e in events if e.name.startswith("cudaMemcpy"))
    busy_ms, device, span_ms = _device_busy(prof)
    print(f"[pixels] one steady tracker step: {device} device events (kernels and copies), "
          f"{launches} kernel launch calls and {copies} copy calls on the host (torch.profiler); "
          f"the card busy {busy_ms:.3f} ms of the {span_ms:.3f} ms from its first to its last")
    top = sorted((e for e in prof.key_averages() if e.key.startswith(("aten::", "cuda"))),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    host = {e.key: [e.count, round(e.self_cpu_time_total / 1e3, 3)] for e in top}
    print(f"[pixels] the step's aten operators and CUDA runtime calls by host time (calls, self "
          f"ms; under the profiler): {host}")
    return {"trk_launches": launches, "trk_device_events": device, "trk_copy_calls": copies,
            "trk_device_busy_ms": busy_ms, "trk_device_span_ms": span_ms,
            "trk_host_top_ops": host}


# The JAX package's run of the system drive on the CPU (system_reference.py:
# run_euroc.main on a fixture tree of the same world and frames; 6.1 min on
# one CPU host; PERF.md section 4). The system phase is held to it.
SYSTEM_REFERENCE = {
    "sys_init_frame": 18, "solved_poses": 181, "keyframes": 68, "loops_closed": 18,
    "loop_precision_vs_gt": 0.9444444444444444, "n_async_collects": 18,
    "ate_se3_m_vio": 1.5498294388417355, "ate_se3_m_kf_vio": 1.1790095310732611,
    "ate_se3_m_loop_opt": 0.34506787147660267, "csv_parser": "native", "render_s": 116.5,
    "drive_s": 234.6}
SYSTEM_FRAMES = 200
SYSTEM_PROFILED = 10  # the drive's last frames, traced by torch.profiler


_FIRST_PNP = r"""
import json, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from isvins_tpu_torch.frontend import make_camera
from isvins_tpu_torch.initial.pnp import pnp_ransac_gn
from isvins_tpu_torch.ops import _lib
from isvins_tpu_torch.posegraph import PoseGraphBuilder
cfg, _ = chip_smoke.system_config()
b = PoseGraphBuilder(cfg, camera=make_camera(cfg.camera))
t0 = time.perf_counter()
b.prewarm() if sys.argv[2] == "prewarm" else _lib.lib()
prewarm_ms = (time.perf_counter() - t0) * 1e3
X = np.random.default_rng(1).normal(size=(64, 3)) + [0.0, 0.0, 5.0]
torch.cuda.synchronize()
t0 = time.perf_counter()
ok = pnp_ransac_gn(X, X[:, :2] / X[:, 2:], [1.0, 0, 0, 0], np.zeros(3),
                   thresh=cfg.posegraph.pnp_inlier_thresh)[0]
print(json.dumps({"warm-up": sys.argv[2], "warm_up_ms": prewarm_ms, "ok": bool(ok),
                  "first_pnp_ms": (time.perf_counter() - t0) * 1e3}))
"""


def first_pnp_ms():
    """The first PnP of a fresh process on the card (64 points), after the
    pose-graph builder's warm-up as it was (the kernel library alone) and
    as it is (PoseGraphBuilder.prewarm): two processes, one after the
    other."""
    out = {}
    for mode in ("library", "prewarm"):
        r = subprocess.run([sys.executable, "-c", _FIRST_PNP, str(ROOT), mode], capture_output=True,
                           text=True, timeout=300, check=True)
        out[mode] = json.loads(r.stdout.strip().splitlines()[-1])
        assert out[mode]["ok"], out[mode]
    return out




def _loop_precision(db, gt):
    """realism_bench.py:173-187: a verified loop (cur -> old) is correct when
    its measured relative translation is within 30 cm of ground truth's."""
    import numpy as np

    from isvins_tpu_torch.geom.hostmath import quat_to_mat_np

    n_loops = n_correct = 0
    for kf in range(db.n):
        old = int(db.loop_idx[kf])
        if old < 0:
            continue
        n_loops += 1
        gi = int(np.argmin(np.abs(gt["t"] - db.ts[kf])))
        gj = int(np.argmin(np.abs(gt["t"] - db.ts[old])))
        rel_t_gt = quat_to_mat_np(gt["q"][gj]).T @ (gt["p"][gi] - gt["p"][gj])
        n_correct += float(np.linalg.norm(rel_t_gt - db.loop_dt[kf])) < 0.30
    return n_loops, (n_correct / n_loops if n_loops else None)


def _check_outputs(out_dir, n_keyframes):
    """The driver's files: TUM lines of 8 fields with epoch-scale stamps, and
    one covariance line per keyframe whose 6x6 block is symmetric (to f32
    rounding of its largest entry) with no eigenvalue below -1e-6 of its
    largest."""
    import numpy as np

    for name in ("pose_output.txt", "loop_pose_output.txt"):
        with open(out_dir / name) as f:
            rows = [line.split() for line in f.read().splitlines()]
        assert rows and all(len(r) == 8 for r in rows), name
        assert all(float(r[0]) > 1e9 for r in rows), name
    with open(out_dir / "loop_cov_output.txt") as f:
        rows = [line.split() for line in f.read().splitlines()]
    assert len(rows) == n_keyframes and all(len(r) == 4 + 36 for r in rows)
    worst_asym = worst_neg = 0.0
    for r in rows:
        C = np.array(r[4:], float).reshape(6, 6)
        scale = np.abs(C).max()
        worst_asym = max(worst_asym, float(np.abs(C - C.T).max() / scale))
        w = np.linalg.eigvalsh(0.5 * (C + C.T))
        worst_neg = max(worst_neg, float(-w.min() / w.max()))
    assert worst_asym <= 1e-5 and worst_neg <= 1e-6, (worst_asym, worst_neg)
    return worst_asym, worst_neg


def phase_system(dev, smi, world, frames, render_s):
    """The whole pipeline with loops on at 752x480 (system_config), as a
    user runs it: the frames and the world's IMU written as a EuRoC tree
    (utils.euroc_fixture, PNG by data/png.py) under build/, then
    isvins_tpu_torch.run_euroc.main on the card: the loader with the native
    CSV parser, PNG decode, System(pipeline=True, pg_thread=True) with the
    pose graph on its worker thread, the TUM and covariance writers, ATE.
    Timing wraps System.pub_imu and pub_image (a frame: the IMU samples
    before the image plus the image, as realism_bench.py times it) and the
    tracker's dispatch and collect; the last SYSTEM_PROFILED frames run
    under torch.profiler (the card's busy share) and are left out of the
    timed statistics. Held to the JAX package's run of the same drive
    (SYSTEM_REFERENCE). Returns the launch counts, the record and the VIO
    poses as (frame index, P, Q)."""
    import shutil

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from isvins_tpu_torch import ops, run_euroc
    from isvins_tpu_torch.data import EurocDataset
    from isvins_tpu_torch.estimator.estimator import NON_LINEAR
    from isvins_tpu_torch.frontend import FeatureTracker
    from isvins_tpu_torch.posegraph import PoseGraphBuilder
    from isvins_tpu_torch.posegraph import builder as builder_mod
    from isvins_tpu_torch.system import System
    from isvins_tpu_torch.utils import perf
    from isvins_tpu_torch.utils.euroc_fixture import write_euroc_fixture
    from isvins_tpu_torch.utils.evaluation import ate_rmse

    ref = SYSTEM_REFERENCE
    cfg, dims = system_config()
    t0 = time.perf_counter()
    pnp = first_pnp_ms()
    pnp_s = time.perf_counter() - t0
    print(f"[system] first PnP of a fresh process: {pnp['library']['first_pnp_ms']:.1f} ms after "
          f"the kernel library alone, {pnp['prewarm']['first_pnp_ms']:.1f} ms after "
          f"PoseGraphBuilder.prewarm ({pnp['prewarm']['warm_up_ms']:.1f} ms)")
    work = ROOT / "build" / "system_phase"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    mav0 = write_euroc_fixture(str(work), world, frames)
    write_s = time.perf_counter() - t0
    ds = EurocDataset(mav0)
    gt, image_ts = ds.ground_truth, np.array([m.t for m in ds.images])
    n = len(image_ts)
    print(f"[system] EuRoC tree of {n} frames and {len(ds.imu)} IMU samples written in "
          f"{write_s:.1f} s; IMU CSV parser: {ds.csv_parser}")

    made, frame_log, push_log, pnp_log = [], [], [], []
    acc = {"imu": 0.0, "trk": 0.0, "prof": None}
    orig = {k: getattr(System, k) for k in ("__init__", "pub_imu", "pub_image")}
    trk_orig = {k: getattr(FeatureTracker, k) for k in ("dispatch", "collect")}
    push_orig, pnp_orig = PoseGraphBuilder.push, builder_mod.pnp_ransac_gn

    def init(self, *a, **k):
        orig["__init__"](self, *a, **k)
        made.append(self)
        self._init_at = _watch_init(self.estimator, image_ts)

    def pub_imu(self, *a):
        t0 = time.perf_counter()
        orig["pub_imu"](self, *a)
        acc["imu"] += time.perf_counter() - t0

    def pub_image(self, t, img):
        k = len(frame_log)
        if k == n - SYSTEM_PROFILED:
            torch.cuda.synchronize(dev)
            # device activity only: recording every CPU operator would slow the
            # profiled frames' host and take minutes to read back
            acc["prof"] = profile(activities=[ProfilerActivity.CUDA])
            acc["prof"].__enter__()
            acc["prof_t0"] = time.perf_counter()
        kf0, loops0 = self.pgbuilder.db.n, self.pgbuilder.n_loops
        t0 = time.perf_counter()
        orig["pub_image"](self, t, img)
        ms = (time.perf_counter() - t0 + acc["imu"]) * 1e3
        # read from the frame thread while the worker may be writing: a
        # count that lands a frame late only moves a frame between groups
        frame_log.append((ms, acc["trk"] * 1e3, self.estimator.solver_flag,
                          self.pgbuilder.db.n > kf0, self.pgbuilder.n_loops > loops0))
        acc["imu"] = acc["trk"] = 0.0
        if k == n - 1:
            torch.cuda.synchronize(dev)
            acc["prof_ms"] = (time.perf_counter() - acc["prof_t0"]) * 1e3
            acc["prof"].__exit__(None, None, None)
            acc["prof_exit_s"] = time.perf_counter() - acc["prof_t0"] - acc["prof_ms"] / 1e3

    def trk_timed(name):
        def timed(self, *a, **k):
            t0 = time.perf_counter()
            out = trk_orig[name](self, *a, **k)
            acc["trk"] += time.perf_counter() - t0
            return out
        return timed

    def push(self, *a, **k):
        t0 = time.perf_counter()
        idx = push_orig(self, *a, **k)
        push_log.append(((time.perf_counter() - t0) * 1e3, idx is not None))
        return idx

    def pnp_timed(*a, **k):
        t0 = time.perf_counter()
        out = pnp_orig(*a, **k)
        pnp_log.append((time.perf_counter() - t0) * 1e3)
        return out

    System.__init__, System.pub_imu, System.pub_image = init, pub_imu, pub_image
    FeatureTracker.dispatch, FeatureTracker.collect = trk_timed("dispatch"), trk_timed("collect")
    PoseGraphBuilder.push, builder_mod.pnp_ransac_gn = push, pnp_timed
    out_dir = work / "out"
    before_mb = torch.cuda.memory_allocated(dev) / 2**20  # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats(dev)
    perf.reset()
    perf.enable(True)
    ops.reset_launch_counts()  # just before the main path
    t0 = time.perf_counter()
    try:
        res = run_euroc.main([mav0, "--out-dir", str(out_dir)], cfg=cfg, dims=dims)
    finally:
        perf.enable(False)
        for k, v in orig.items():
            setattr(System, k, v)
        FeatureTracker.dispatch, FeatureTracker.collect = trk_orig["dispatch"], trk_orig["collect"]
        PoseGraphBuilder.push, builder_mod.pnp_ransac_gn = push_orig, pnp_orig
    drive_s = time.perf_counter() - t0
    counts = ops.launch_counts()  # just after the main path
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20 - before_mb
    sys_ = made[0]
    pg, db = sys_.pgbuilder, sys_.pgbuilder.db

    t0 = time.perf_counter()
    busy_ms, n_dev_events, _ = _device_busy(acc["prof"])
    readback_s = time.perf_counter() - t0
    flags = [r[2] for r in frame_log]
    first = flags.index(NON_LINEAR)
    steady = [r for k, r in enumerate(frame_log) if first < k < n - SYSTEM_PROFILED]
    ms = np.array([r[0] for r in steady])
    trk_ms = np.array([r[1] for r in steady])
    tail = ms[len(ms) // 2:]
    kf_ms = [r[0] for r in steady if r[3]]
    other_ms = [r[0] for r in steady if not r[3]]
    # the tail's slow frames (over twice its median): how many saw the worker
    # add a keyframe, and close a loop
    slow = [r for r in steady[len(steady) // 2:] if r[0] > 2 * float(np.median(tail))]
    slow_frames = {"count": len(slow), "worker_kf": sum(r[3] for r in slow),
                   "loop": sum(r[4] for r in slow), "ms": [round(r[0], 1) for r in slow]}
    traj = sys_.vio_trajectory
    t_est = np.array([t for (t, _, _) in traj])
    p_est = np.array([P for (_, P, _) in traj])
    ts_kf, t_opt, _ = pg.trajectory()
    n_loops, precision = _loop_precision(db, gt)
    ate = lambda t, p: float(ate_rmse(t, p, gt["t"], gt["p"], align="se3"))
    asym, neg = _check_outputs(out_dir, int(db.n))
    kf_push = [m for (m, made_kf) in push_log if made_kf]
    rec = {
        "frames": res["n_frames"], "sys_init_frame": sys_._init_at[0] if sys_._init_at else None,
        "solved_poses": len(traj),
        "tracker_ms_per_frame_median": float(np.median(trk_ms)),
        "pipeline_ms_per_frame_median": float(np.median(ms)),
        "pipeline_ms_per_frame_p90": float(np.percentile(ms, 90)),
        "pipeline_ms_per_frame_max": float(ms.max()),
        "pipeline_fps": 1e3 / float(np.median(ms)),
        "steady_frames_timed": len(ms),
        "tail_ms_median": float(np.median(tail)), "tail_ms_p90": float(np.percentile(tail, 90)),
        "tail_ms_max": float(tail.max()),
        "frame_ms_median_worker_kf": float(np.median(kf_ms)) if kf_ms else None,
        "frame_ms_median_no_kf": float(np.median(other_ms)) if other_ms else None,
        "frames_worker_kf": len(kf_ms), "tail_slow_frames": slow_frames,
        "pg_push_ms_median_kf": float(np.median(kf_push)) if kf_push else None,
        "pg_pnp_calls": len(pnp_log), "pg_first_stream_pnp_ms": pnp_log[0] if pnp_log else None,
        "first_pnp_fresh_process": pnp,
        "keyframes": int(db.n), "loops_closed": n_loops, "loop_precision_vs_gt": precision,
        "n_async_collects": int(pg.n_async_collects),
        "n_async_dispatches": int(pg.n_async_dispatches),
        "k6_queries": len(db.match_count_queries),
        "ate_se3_m_vio": ate(t_est, p_est), "ate_se3_m_kf_vio": ate(ts_kf, db.vio_t[: db.n]),
        "ate_se3_m_loop_opt": ate(ts_kf, t_opt),
        "csv_parser": ds.csv_parser, "render_s": render_s, "write_s": write_s,
        "drive_s": drive_s, "max_memory_allocated_mb": peak_mb,
        "memory_allocated_before_mb": before_mb,
        "busy_share_profiled": busy_ms / acc["prof_ms"], "profiled_frames": SYSTEM_PROFILED,
        "profiled_wall_ms": acc["prof_ms"], "profiled_busy_ms": busy_ms,
        "profiled_device_events": n_dev_events, "profiler_exit_s": acc["prof_exit_s"],
        "busy_readback_s": readback_s, "first_pnp_processes_s": pnp_s,
        "cov_worst_asymmetry": asym, "cov_worst_negative_eig": neg,
        "launches": counts, "failure_count": int(sys_.estimator.failure_count),
        "phases": perf.stats(), "reference": ref,
    }
    print(f"[system] {rec['frames']} frames in {drive_s:.1f} s: initialized on frame "
          f"{rec['sys_init_frame']}'s packet (JAX {ref['sys_init_frame']}), {len(traj)} poses, "
          f"{db.n} keyframes (JAX {ref['keyframes']}), {n_loops} loops (JAX "
          f"{ref['loops_closed']}), precision {precision} (JAX {ref['loop_precision_vs_gt']})")
    print(f"[system] ATE se3: vio {rec['ate_se3_m_vio']:.4f} m, keyframe vio "
          f"{rec['ate_se3_m_kf_vio']:.4f}, loop-optimized {rec['ate_se3_m_loop_opt']:.4f} (JAX "
          f"{ref['ate_se3_m_vio']:.4f}, {ref['ate_se3_m_kf_vio']:.4f}, "
          f"{ref['ate_se3_m_loop_opt']:.4f})")
    print(f"[system] steady frame ({len(ms)} timed): median {rec['pipeline_ms_per_frame_median']:.1f}"
          f" ms, p90 {rec['pipeline_ms_per_frame_p90']:.1f}, max "
          f"{rec['pipeline_ms_per_frame_max']:.1f}; tracker {rec['tracker_ms_per_frame_median']:.1f}"
          f" ms; frames during a worker keyframe {rec['frame_ms_median_worker_kf']} ms "
          f"({len(kf_ms)}) against {rec['frame_ms_median_no_kf']} ms; card busy "
          f"{busy_ms:.1f} of {acc['prof_ms']:.1f} ms over the last {SYSTEM_PROFILED} frames "
          f"(under torch.profiler); peak memory {peak_mb:.0f} MiB over the {before_mb:.0f} MiB held "
          f"before; launches {counts}")
    print(f"[system] the tail's frames over twice its median: {slow_frames}")
    print("[system] utils/perf phases over the drive (worker's pg.* beside the frame thread's):\n"
          + perf.report(len(frame_log)))
    print(json.dumps({"system": rec, "card": smi}))

    fails = []
    if ds.csv_parser != "native":
        fails.append(f"IMU CSV parsed by {ds.csv_parser}, not the native parser")
    if rec["sys_init_frame"] is None or abs(rec["sys_init_frame"] - ref["sys_init_frame"]) > 2:
        fails.append(f"sys_init_frame {rec['sys_init_frame']} not within 2 of "
                     f"{ref['sys_init_frame']}")
    if abs(db.n - ref["keyframes"]) > 0.1 * ref["keyframes"]:
        fails.append(f"{db.n} keyframes, not within 10 % of {ref['keyframes']}")
    if n_loops < 1 or precision < ref["loop_precision_vs_gt"]:
        fails.append(f"{n_loops} loops at precision {precision} (JAX "
                     f"{ref['loop_precision_vs_gt']})")
    if not rec["ate_se3_m_loop_opt"] <= 1.5 * ref["ate_se3_m_loop_opt"] + 0.05:
        fails.append(f"ate_se3_m_loop_opt {rec['ate_se3_m_loop_opt']} > 1.5 x JAX's + 0.05 m")
    if not rec["ate_se3_m_loop_opt"] <= 0.5 * rec["ate_se3_m_kf_vio"]:
        fails.append(f"ate_se3_m_loop_opt {rec['ate_se3_m_loop_opt']} > half the keyframe VIO "
                     f"ATE {rec['ate_se3_m_kf_vio']}")
    if len(tail) < 20 or rec["tail_ms_p90"] > 3 * rec["tail_ms_median"] \
            or rec["tail_ms_max"] > 8 * rec["tail_ms_median"]:
        fails.append(f"frames stall over the second half of the steady frames: median "
                     f"{rec['tail_ms_median']}, p90 {rec['tail_ms_p90']}, max {rec['tail_ms_max']}")
    if n_dev_events == 0:
        fails.append("torch.profiler recorded no device event over the profiled frames")
    if sys_._pg_exc is not None or pg._pending_opt is not None:
        fails.append("the worker parked an error or an optimization is pending after flush()")
    if rec["failure_count"] != 0:
        fails.append(f"failure_count {rec['failure_count']}")
    on_path = ("proj_rows", "imu_rows", "schur_corr", "linstep", "retrieval_scores")
    if any(counts[k] <= 0 for k in on_path) or counts["chol_solve_batched"] \
            or counts["schur_reduce"]:
        fails.append(f"system-path launches {counts}: K1-K4 and K6 must run, K5 and K7 not")
    if counts["retrieval_scores"] != len(db.match_count_queries):
        fails.append(f"K6 launches {counts['retrieval_scores']} != its queries "
                     f"{len(db.match_count_queries)}")
    if fails:
        raise AssertionError("; ".join(fails))
    by_frame = [(int(np.argmin(np.abs(image_ts - t))), P, Q) for t, P, Q in traj]
    return counts, rec, by_frame


# The JAX package's run of realism_bench.py's configuration with the async
# solve on the CPU (realism_reference.py: `JAX_PLATFORMS=cpu python3
# realism_reference.py`, 2026-10-17; render 130.5 s, drive 188.7 s on one
# CPU host; PERF.md section 4). The realism phase is held to it.
REALISM_REFERENCE = {
    "init_frame": 18, "solved_poses": 181, "keyframes": 68, "loops_closed": 18,
    "loop_precision_vs_gt": 0.9444444444444444, "loop_rel_t_err_median_m": 0.06225088344224547,
    "ate_se3_m_vio": 1.5978225942592268, "ate_se3_m_kf_vio": 1.2007749887009533,
    "ate_se3_m_loop_opt": 0.34839810008255795, "first_solved_frame": 19, "steady_frames": 180}


def phase_realism(dev, smi, world, frames, system_rec, system_traj):
    """realism_bench.py's drive on the card through
    isvins_tpu_torch.realism_bench.drive_realism: the system phase's world
    and rendered frames (in memory, no PNG) through System(enable_loop=True,
    pipeline=True, pg_thread=True, solve_async=True), as a user runs it (no
    sync-debug guard). Prints realism_bench.py's fields beside the system
    phase's synchronous drive of the same configuration, the largest pose
    gap between the two drives over the frames both solved (printed only:
    the system phase's frames went through 8-bit PNGs), the wait for the
    marginalization and the frames during which the pose-graph worker added
    a keyframe against the others. Held to the JAX package's run
    (REALISM_REFERENCE): init frame within 2, keyframes within 10 %, loops
    >= 1 at a precision no lower, loop-optimized ATE within 1.5x + 5 cm and
    under half the keyframe VIO ATE, no stalling frame over the second half
    of the steady frames; launches K1-K4 by the steady solves and K6 by the
    match-count queries, each K6 query replayed exactly."""
    import numpy as np

    from isvins_tpu_torch import ops, realism_bench
    from isvins_tpu_torch.system import System

    ref = REALISM_REFERENCE
    cfg, dims = realism_bench.realism_config()
    ops.reset_launch_counts()  # just before the main path
    sys_ = System(cfg, dims, enable_loop=True, pipeline=True, pg_thread=True, solve_async=True,
                  device=dev)
    init_at = _watch_init(sys_.estimator, world.frame_times)
    t0 = time.perf_counter()
    try:
        out = realism_bench.drive_realism(sys_, world, frames)
        _sync(dev)
        counts = ops.launch_counts()  # just after the main path
    finally:
        sys_.close()
    drive_s = time.perf_counter() - t0
    est, db = sys_.estimator, sys_.pgbuilder.db
    _replay_k6(dev, db, cfg.posegraph, "realism")
    fields = {k: out[k] for k in realism_bench.FIELDS}
    steady = np.array(out["frame_ms"])
    tail = steady[len(steady) // 2:]
    kf = [m for m, w in zip(out["frame_ms"], out["worker_kf"]) if w]
    other = [m for m, w in zip(out["frame_ms"], out["worker_kf"]) if not w]
    by_frame = {int(np.argmin(np.abs(world.frame_times - t))): (P, Q)
                for t, P, Q in out["trajectory"]}
    common = [(by_frame[k], (P, Q)) for k, P, Q in system_traj if k in by_frame]
    gap_p = max(float(np.abs(a[0] - b[0]).max()) for a, b in common)
    gap_q = max(float(np.abs(a[1] - b[1]).max()) for a, b in common)
    ph = lambda name, stat="median_ms": out["phases"].get(name, {}).get(stat)
    rec = {
        **fields, "init_frame": init_at[0] if init_at else None, "drive_s": drive_s,
        "steady_frames": len(steady), "tail_ms_median": float(np.median(tail)),
        "tail_ms_p90": float(np.percentile(tail, 90)), "tail_ms_max": float(tail.max()),
        "frame_ms_median_worker_kf": float(np.median(kf)) if kf else None,
        "frame_ms_median_no_kf": float(np.median(other)) if other else None,
        "frames_worker_kf": len(kf),
        "est_marg_collect_median_ms": ph("est.marg_collect"),
        "est_marg_collect_max_ms": ph("est.marg_collect", "max_ms"),
        "est_solve_dispatch_median_ms": ph("est.solve_dispatch"),
        "est_solve_collect_median_ms": ph("est.solve_collect"),
        "trk_dispatch_median_ms": ph("trk.dispatch"),
        "pg_kf_device_step_median_ms": ph("pg.kf_device_step"),
        "pg_opt_dispatch_median_ms": ph("pg.opt_dispatch"),
        "steady_solves": est.steady_solves, "k6_queries": len(db.match_count_queries),
        "vs_system_frames_compared": len(common), "vs_system_max_dP_m": gap_p,
        "vs_system_max_dQ": gap_q, "launches_realism": counts,
        "failure_count": int(est.failure_count), "phases": out["phases"], "reference": ref,
    }
    sync = {k: system_rec[k] for k in ("pipeline_ms_per_frame_median", "pipeline_ms_per_frame_p90",
                                       "pipeline_ms_per_frame_max", "pipeline_fps",
                                       "tracker_ms_per_frame_median", "tail_ms_median",
                                       "tail_ms_p90", "tail_ms_max", "keyframes", "loops_closed",
                                       "ate_se3_m_loop_opt")}
    print(json.dumps(fields))
    print(json.dumps({"realism": rec, "system_sync": sync, "card": smi}))
    f4 = lambda x: "None" if x is None else f"{x:.4f}"
    print(f"[realism] async drive of {len(frames)} frames in {drive_s:.1f} s: init on frame "
          f"{rec['init_frame']}'s packet (JAX {ref['init_frame']}), {out['solved_poses']} poses, "
          f"{out['keyframes']} keyframes (JAX {ref['keyframes']}), {out['loops_closed']} loops at "
          f"precision {out['loop_precision_vs_gt']} (JAX {ref['loops_closed']} at "
          f"{ref['loop_precision_vs_gt']}); ATE vio {f4(out['ate_se3_m_vio'])} m, keyframe vio "
          f"{f4(out['ate_se3_m_kf_vio'])}, loop-optimized {f4(out['ate_se3_m_loop_opt'])} (JAX "
          f"{ref['ate_se3_m_vio']:.4f}, {ref['ate_se3_m_kf_vio']:.4f}, "
          f"{ref['ate_se3_m_loop_opt']:.4f})")
    print(f"[realism] steady frame median / p90: async {out['pipeline_ms_per_frame_median']:.1f} / "
          f"{out['pipeline_ms_per_frame_p90']:.1f} ms (tracker "
          f"{out['tracker_ms_per_frame_median']:.1f}), the system phase's sync drive "
          f"{sync['pipeline_ms_per_frame_median']:.1f} / {sync['pipeline_ms_per_frame_p90']:.1f} ms "
          f"(tracker {sync['tracker_ms_per_frame_median']:.1f}); frames with a worker keyframe "
          f"{rec['frame_ms_median_worker_kf']} ms ({len(kf)}) against {rec['frame_ms_median_no_kf']}"
          f" ms; marginalization wait median {rec['est_marg_collect_median_ms']} ms, max "
          f"{rec['est_marg_collect_max_ms']} ms; against the system phase over {len(common)} "
          f"frames: max|dP| {gap_p:.3g} m, max|dQ| {gap_q:.3g}; launches {counts}")

    fails = []
    if rec["init_frame"] is None or abs(rec["init_frame"] - ref["init_frame"]) > 2:
        fails.append(f"init frame {rec['init_frame']} not within 2 of {ref['init_frame']}")
    if abs(out["keyframes"] - ref["keyframes"]) > 0.1 * ref["keyframes"]:
        fails.append(f"{out['keyframes']} keyframes, not within 10 % of {ref['keyframes']}")
    if out["loops_closed"] < 1 or not out["loop_precision_vs_gt"] >= ref["loop_precision_vs_gt"]:
        fails.append(f"{out['loops_closed']} loops at precision {out['loop_precision_vs_gt']} "
                     f"(JAX {ref['loop_precision_vs_gt']})")
    loop_ate, kf_ate = out["ate_se3_m_loop_opt"], out["ate_se3_m_kf_vio"]
    if loop_ate is None or not loop_ate <= 1.5 * ref["ate_se3_m_loop_opt"] + 0.05:
        fails.append(f"ate_se3_m_loop_opt {loop_ate} > 1.5 x JAX's + 0.05 m")
    if loop_ate is None or kf_ate is None or not loop_ate <= 0.5 * kf_ate:
        fails.append(f"ate_se3_m_loop_opt {out['ate_se3_m_loop_opt']} > half the keyframe VIO "
                     f"ATE {out['ate_se3_m_kf_vio']}")
    if len(tail) < 20 or rec["tail_ms_p90"] > 3 * rec["tail_ms_median"] \
            or rec["tail_ms_max"] > 8 * rec["tail_ms_median"]:
        fails.append(f"frames stall over the second half of the steady frames: median "
                     f"{rec['tail_ms_median']}, p90 {rec['tail_ms_p90']}, max {rec['tail_ms_max']}")
    if rec["failure_count"]:
        fails.append(f"failure_count {rec['failure_count']}")
    iters = cfg.solver.max_iterations
    n_solves = est.steady_solves
    expect = dict.fromkeys(counts, 0)
    expect.update(proj_rows=n_solves * (iters + 1), imu_rows=n_solves * (iters + 1),
                  schur_corr=n_solves * iters, linstep=n_solves * iters,
                  retrieval_scores=len(db.match_count_queries))
    if counts != expect or not counts["retrieval_scores"] or n_solves < len(frames) // 2:
        fails.append(f"realism-path launches {counts} != {expect} over {n_solves} steady solves "
                     "(K6 must run)")
    if fails:
        raise AssertionError("; ".join(fails))
    return counts, rec


# The pose graph across devices (ROADMAP A5). (a) The reference's product
# configuration, scaling_bench.bench_posegraph_dd (scaling_bench.py:100-147):
# K = 1024 poses, E = K chain edges, K / 16 loops, 3 GN iterations, with
# covariance, over 2, 4 and 8 devices (the card listed nd times). (b) Its
# upper end, the PoseGraphConfig.max_active_poses clamp: K = 4096, 256 loops,
# nd = 8. (c) The router on a 600-keyframe database (the K = 1024 bucket).
PGDIST_K, PGDIST_ITERS, PGDIST_ND = 1024, 3, (2, 4, 8)
PGDIST_CLAMP_K, PGDIST_CLAMP_ND = 4096, 8
ROUTER_KF, ROUTER_LOOPS, ROUTER_DEVICES = 600, 16, 8
# f64 solves are held to the reference's own tests' tolerances
# (tests/test_distributed.py:245-250): poses atol 1e-10, covariance rtol 1e-6
# atol 2e-8, cost rtol 1e-12
F64_BOUNDS = {"t": 1e-10, "q": 1e-10, "cov_rtol": 1e-6, "cov_atol": 2e-8, "cost_rtol": 1e-12}
# f32 solves are held to the f64 answer within the bounds _replay_last_solve
# uses (256 f32 ulps of the largest coordinate, of 1.0 for quaternions;
# covariance blocks 5 %), or within F32_MARGIN times the error of an f32 solve
# of the same configuration by other arithmetic (the CPU's, or the card's
# dense solve), where that is larger: GN's steps in f32 on a system of
# thousands of poses carry cond(H) times f32 rounding, which the 256 ulps
# (sized for a converged segment of tens of poses) do not cover
F32_MARGIN = 4.0


def drifted_circle_db(make_db, n, n_loops):
    """tests/test_distributed.py:16-44 at n keyframes: a circle of radius 5 m
    whose VIO poses drift in yaw and translation (by keyframe n - 1 as much
    as that test's 40 do), ground-truth chain edges (sqrt-information 30 I)
    and n_loops loop edges of weight 500, from keyframe n - n_loops + l back
    to keyframe l (at n = 40 and one loop, that test's graph). make_db()
    gives an empty KeyframeDB of either package. Returns (db, t_gt)."""
    import numpy as np

    from isvins_tpu_torch.geom.hostmath import (mat_to_quat_np, quat_conj_np, quat_mul_np,
                                                quat_normalize_np, quat_to_mat_np)

    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    t_gt = np.stack([5 * np.cos(th), 5 * np.sin(th), np.zeros(n)], axis=1)
    q_gt = np.stack([np.cos((th + np.pi / 2) / 2), 0 * th, 0 * th,
                     np.sin((th + np.pi / 2) / 2)], axis=1)
    rate = 40.0 / n
    db = make_db()
    for k in range(n):
        dy = 0.004 * rate * k
        Rz = np.array([[np.cos(dy), -np.sin(dy), 0], [np.sin(dy), np.cos(dy), 0], [0, 0, 1]])
        tv = Rz @ t_gt[k] + np.array([0.002, 0.001, 0.0]) * rate * k
        qv = quat_normalize_np(quat_mul_np(mat_to_quat_np(Rz), q_gt[k]))
        db.add(ts=float(k), vio_t=tv, vio_q=qv, opt_t=tv, opt_q=qv)

    def rel(i, j):
        return (quat_to_mat_np(q_gt[i]).T @ (t_gt[j] - t_gt[i]),
                quat_normalize_np(quat_mul_np(quat_conj_np(q_gt[i]), q_gt[j])))

    for k in range(n - 1):
        db.edge_dt[k], db.edge_dq[k] = rel(k, k + 1)
        db.edge_sqrt[k] = np.eye(6) * 30.0
        db.edge_valid[k] = True
    for l in range(n_loops):
        j = n - n_loops + l
        db.loop_idx[j] = l
        db.loop_dt[j], db.loop_dq[j] = rel(l, j)
        db.loop_weight[j] = 500.0
    return db, t_gt


def _f32(arrays):
    import numpy as np

    return tuple(a.astype(np.float32) if a.dtype == np.float64 else a for a in arrays)


def _pg_errors(out, ref):
    """Of a solve (t, q, cov[, cost]) against another: max |dt|, max |dq| (up
    to the quaternion's sign), the
    largest relative Frobenius error of a covariance block, the largest
    covariance error beyond rtol * |ref| (for F64_BOUNDS), the relative cost
    gap."""
    import numpy as np

    h = lambda x: np.asarray(x.detach().cpu().double() if hasattr(x, "detach") else x,
                             np.float64)
    t, q, c = (h(x) for x in out[:3])
    tr, qr, cr = (h(x) for x in ref[:3])
    # q and -q are one rotation, and quat_normalize picks w >= 0, so a
    # rotation with w near 0 may come out with either sign: the distance of
    # each quaternion to the nearer of +-q_ref
    dq = np.minimum(np.abs(q - qr).max(axis=-1), np.abs(q + qr).max(axis=-1))
    err = {"dt": float(np.abs(t - tr).max()), "dq": float(dq.max()),
           "dcov": float((np.linalg.norm(c - cr, axis=(1, 2))
                          / np.linalg.norm(cr, axis=(1, 2))).max()),
           "dcov_abs": float((np.abs(c - cr) - F64_BOUNDS["cov_rtol"] * np.abs(cr)).max()),
           "t_max": float(np.abs(tr).max())}
    if len(out) > 3:
        err["dcost"] = abs(float(out[3]) - float(ref[3])) / abs(float(ref[3]))
    return err


def _f32_bounds(ref_t_max, base=None):
    """The f32 bounds: 256 ulps, 5 %; or F32_MARGIN x `base`'s errors."""
    import numpy as np

    b = {"t": 256 * float(np.spacing(np.float32(ref_t_max))),
         "q": 256 * float(np.spacing(np.float32(1.0))), "dcov": 0.05}
    if base is not None:
        b["t"] = max(b["t"], F32_MARGIN * base["dt"])
        b["q"] = max(b["q"], F32_MARGIN * base["dq"])
    return b


def _pg_check(label, out, ref, bounds, records):
    """Hold a solve to another within `bounds` (F64_BOUNDS or _f32_bounds);
    print the errors beside their bounds; raise on a miss."""
    import numpy as np

    err = _pg_errors(out, ref)
    if "cov_rtol" in bounds:
        ok = (err["dt"] <= bounds["t"] and err["dq"] <= bounds["q"]
              and err["dcov_abs"] <= bounds["cov_atol"] and err["dcost"] <= bounds["cost_rtol"])
        text = (f"max|dt| {err['dt']:.3g} m (bound {bounds['t']:g}), max|dq| {err['dq']:.3g} "
                f"(bound {bounds['q']:g}), covariance beyond rtol {bounds['cov_rtol']:g}: "
                f"{err['dcov_abs']:.3g} (atol {bounds['cov_atol']:g}), relative cost gap "
                f"{err['dcost']:.3g} (bound {bounds['cost_rtol']:g})")
    else:
        ulps = 256 * float(np.spacing(np.float32(err["t_max"])))
        ok = err["dt"] <= bounds["t"] and err["dq"] <= bounds["q"] and err["dcov"] <= bounds["dcov"]
        text = (f"max|dt| {err['dt']:.3g} m (bound {bounds['t']:.3g}; 256 ulps of "
                f"{err['t_max']:.3g} m: {ulps:.3g}), max|dq| {err['dq']:.3g} (bound "
                f"{bounds['q']:.3g}), covariance blocks {err['dcov']:.3g} relative (bound "
                f"{bounds['dcov']:g})" + (f", relative cost gap {err['dcost']:.3g}"
                                          if "dcost" in err else ""))
    print(f"[pgdist] {label}: {text}")
    records[label] = {**err, "bounds": bounds}
    if not ok:
        raise AssertionError(f"{label}: outside its bounds")
    return err


def _pg_timed(dev, label, fn, reps=3):
    """fn() once (its result, and the peak memory of that run), then `reps`
    runs on the host clock: to fn's return (the enqueue) and to a
    synchronize() after it (the wall time); then one run under
    torch.profiler (device activity only): the card's busy time and its
    kernels and copies."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    _sync(dev)
    mem = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    enq, wall = [], []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        _sync(dev)
        enq.append(t1 - t0)
        wall.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(dev)
    busy, events, _ = _device_busy(prof)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sum(1 for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cuda and not e.name().startswith(("Memcpy", "Memset")))
    rec = {"wall_ms_median": float(np.median(wall)) * 1e3,
           "enqueue_ms_median": float(np.median(enq)) * 1e3,
           "device_busy_ms": busy, "kernels": kernels, "copies": events - kernels,
           "max_memory_allocated_mb": mem}
    print(f"[pgdist] {label}: wall {rec['wall_ms_median']:.2f} ms (median of {reps}), host "
          f"enqueue {rec['enqueue_ms_median']:.2f} ms, card busy {busy:.2f} ms, {kernels} kernels "
          f"and {events - kernels} copies per solve (torch.profiler), max_memory_allocated "
          f"{mem:.1f} MiB")
    return out, rec


def _interface(nd, args):
    """NB and the interface size of dd_partition on a problem's arrays."""
    from isvins_tpu_torch.parallel.dd_solver import dd_partition

    part = dd_partition(nd, len(args[0]), *(args[k] for k in (4, 5, 9, 10, 13, 14, 15, 19)))
    return {"NB": int(part["NB"]), "interface": int(part["bnd_valid"].sum()),
            "Ki": int(part["Ki"])}


def phase_pgdist(dev):
    """The pose graph across devices (ROADMAP A5), one process over a list
    of torch devices with the card listed nd times. (a) The product
    configuration (K = 1024): the edge-sharded dense solve on [card] and
    dd_pose_graph_solve on [card] * 2, 4, 8, in f64 held to the port's f64 dd
    solve on ["cpu"] * 8 at the reference tests' tolerances, and in f32 (the
    card's precision: timed) held to it within the f32 bounds; dd against
    dense on the card in f64 (the exactness claim). (b) The clamp
    (K = 4096, nd = 8): dd against dense, both on the card, in f64 and in
    f32, with peak memory (no f64 CPU solve: the dense one at D = 24,576
    would take minutes). (c) The router: optimize_pose_graph on a
    600-keyframe drifted circle with 16 loops (the K = 1024 bucket, nd = 8)
    dispatched async on [card] * 8 under set_sync_debug_mode("error"), then
    finalized; held to the dense route on the card and to the f64 router on
    ["cpu"] * 8, and the loop closed (max position error < 0.25 m, the JAX
    test's bound); the dense route on the card timed beside it. The path
    launches none of K1-K7."""
    import numpy as np
    import torch

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.parallel import dd_pose_graph_solve, distributed_pose_graph_solve
    from isvins_tpu_torch.posegraph import KeyframeDB, optimize_pose_graph
    from isvins_tpu_torch.posegraph import optimize as optimize_mod

    torch.cuda.empty_cache()
    checks, timed = {}, {}

    def solves(K, nds, iters):
        out = {"dense": lambda a: distributed_pose_graph_solve([dev], *a, iters=iters,
                                                               with_cov=True)}
        for nd in nds:
            out[f"dd{nd}"] = lambda a, nd=nd: dd_pose_graph_solve([dev] * nd, *a, iters=iters,
                                                                  with_cov=True)
        return out

    # (a) the product configuration
    K = PGDIST_K
    prob = posegraph_problem(K, K, K // 16)
    p32 = _f32(prob)
    t0 = time.perf_counter()
    ref = dd_pose_graph_solve(["cpu"] * 8, *prob, iters=PGDIST_ITERS, with_cov=True)
    cpu_s = time.perf_counter() - t0
    cpu32 = dd_pose_graph_solve(["cpu"] * 8, *p32, iters=PGDIST_ITERS, with_cov=True)
    base = _pg_errors(cpu32, ref)
    print(f"[pgdist] K={K} E={K} loops={K // 16} iters={PGDIST_ITERS}: the f64 reference, "
          f"dd on ['cpu'] * 8, took {cpu_s:.2f} s; the same solve in f32 on the CPU is "
          f"{base['dt']:.3g} m / {base['dq']:.3g} from it (the f32 error of this configuration)")
    bounds32 = _f32_bounds(base["t_max"], base)
    outs64 = {}
    for name, fn in solves(K, PGDIST_ND, PGDIST_ITERS).items():
        part = _interface(int(name[2:]), prob) if name != "dense" else {}
        outs64[name] = fn(prob)
        _pg_check(f"K={K} {name} card f64 vs CPU f64", outs64[name], ref, F64_BOUNDS, checks)
        if name != "dense":
            _pg_check(f"K={K} {name} vs dense, card f64", outs64[name], outs64["dense"],
                      F64_BOUNDS, checks)
        out32, rec = _pg_timed(dev, f"K={K} {name} card f32 {part}", lambda: fn(p32))
        _pg_check(f"K={K} {name} card f32 vs CPU f64", out32, ref, bounds32, checks)
        timed[f"K{K}_{name}"] = {**rec, **part}
    del outs64
    torch.cuda.empty_cache()

    # (b) the clamp: dd against dense, both on the card
    K, nd = PGDIST_CLAMP_K, PGDIST_CLAMP_ND
    prob = posegraph_problem(K, K, K // 16)
    p32 = _f32(prob)
    fns = solves(K, (nd,), PGDIST_ITERS)
    dense64 = fns["dense"](prob)
    dd64 = fns[f"dd{nd}"](prob)
    _pg_check(f"K={K} dd{nd} vs dense, card f64", dd64, dense64, F64_BOUNDS, checks)
    dense32, rec = _pg_timed(dev, f"K={K} dense card f32", lambda: fns["dense"](p32))
    timed[f"K{K}_dense"] = rec
    # no independent f32 solve at this size (the CPU's would take minutes):
    # the dense f32 solve's pose errors are printed, and they bound dd's
    base = _pg_check(f"K={K} dense card f32 vs dense card f64", dense32, dense64,
                     {"t": float("inf"), "q": float("inf"), "dcov": 0.05}, checks)
    del dense32
    torch.cuda.empty_cache()
    part = _interface(nd, prob)
    dd32, rec = _pg_timed(dev, f"K={K} dd{nd} card f32 {part}", lambda: fns[f"dd{nd}"](p32))
    timed[f"K{K}_dd{nd}"] = {**rec, **part}
    _pg_check(f"K={K} dd{nd} card f32 vs dense card f64", dd32, dense64,
              _f32_bounds(base["t_max"], base), checks)
    del dense64, dd64, dd32
    torch.cuda.empty_cache()

    # (c) the router: the dd branch dispatched async on the card listed 8 times
    n = ROUTER_KF
    make = lambda d: drifted_circle_db(lambda: KeyframeDB(n, 8, 8, device=d), n,
                                       ROUTER_LOOPS)
    meshes, real = [], optimize_mod.dd_pose_graph_solve

    def recording(devices, *a, **kw):
        meshes.append(len(devices))
        return real(devices, *a, **kw)

    optimize_mod.dd_pose_graph_solve = recording
    try:
        cpu_db, t_gt = make("cpu")
        t0 = time.perf_counter()
        optimize_pose_graph(cpu_db, 0, n - 1, devices=["cpu"] * ROUTER_DEVICES)
        cpu_s = time.perf_counter() - t0
        route = lambda db: optimize_pose_graph(db, 0, n - 1, async_dispatch=True,
                                               devices=[dev] * ROUTER_DEVICES)
        dbs = [make(dev)[0] for _ in range(7)]
        route(dbs.pop()).finalize()  # warm-up
        card_db = dbs.pop()
        _sync(dev)
        ops.reset_launch_counts()  # just before the main path
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            pending = route(card_db)
            t1 = time.perf_counter()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        pending.finalize()
        t2 = time.perf_counter()
        counts = ops.launch_counts()  # just after the main path
        if meshes != [8, 8, 8] or not pending.landed:
            raise AssertionError(f"the router's dd meshes {meshes}, landed {pending.landed}")
        loops = [k for k in range(n) if card_db.loop_idx[k] >= 0]
        part = _interface(8, optimize_mod._dd_inputs(card_db, 0, n - 1, n, loops, np.float32)[0])
        # dispatch (the enqueue) and the card's work; finalize is timed above
        _, rec = _pg_timed(dev, f"router n={n} dd{ROUTER_DEVICES} dispatch {part}",
                           lambda: route(dbs.pop()))
    finally:
        optimize_mod.dd_pose_graph_solve = real
    dense_db = make(dev)[0]
    optimize_pose_graph(dense_db, 0, n - 1, devices=[dev])
    # the same segment through the dense route on one card (n = 600, D = 3,600)
    dbs = [make(dev)[0] for _ in range(5)]
    _, rec_dense = _pg_timed(dev, f"router n={n} dense route [card] dispatch",
                             lambda: optimize_pose_graph(dbs.pop(), 0, n - 1, async_dispatch=True,
                                                         devices=[dev]))
    as_out = lambda db: (db.opt_t[:n], db.opt_q[:n], db.cov[:n])
    err_loop = float(np.linalg.norm(card_db.opt_t[:n] - t_gt, axis=1).max())
    print(f"[pgdist] router: n={n} keyframes, {ROUTER_LOOPS} loops, K=1024 bucket, nd=8; "
          f"async dispatch under set_sync_debug_mode('error'): no host read, returned in "
          f"{(t1 - t0) * 1e3:.2f} ms, finalize waited {(t2 - t1) * 1e3:.2f} ms; the f64 "
          f"router on ['cpu'] * 8 took {cpu_s:.2f} s; K1-K7 launches {counts}; max position "
          f"error to ground truth {err_loop:.4g} m (bound 0.25)")
    b = _f32_bounds(float(np.abs(cpu_db.opt_t[:n]).max()))
    _pg_check("router dd card f32 vs router CPU f64", as_out(card_db), as_out(cpu_db), b, checks)
    _pg_check("router dd card f32 vs dense route card f32", as_out(card_db), as_out(dense_db),
              b, checks)
    if not err_loop < 0.25:
        raise AssertionError(f"the router did not close the loop: {err_loop} m")
    if any(counts.values()):
        raise AssertionError(f"the pose graph across devices launched a kernel: {counts}")
    timed["router"] = {**rec, **part, "dispatch_host_ms": (t1 - t0) * 1e3,
                       "finalize_wait_ms": (t2 - t1) * 1e3, "max_pos_err_m": err_loop}
    timed["router_dense"] = rec_dense
    torch.cuda.empty_cache()
    return counts, {"timed": timed, "checks": checks}


SCALING_DRYRUN_N = 4  # __graft_entry__.dryrun_multichip's mesh, as on a four-card host


def _window_gaps(st, cost, ref_st, ref_cost, scale_cost):
    """Of batched window rows against others: the largest gap over every
    leaf and the cost, the largest relative cost gap (over scale_cost), and
    the median over the sequences of each one's largest |dP|."""
    NB = cost.shape[0]
    largest = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip((*st, cost), (*ref_st, ref_cost)))
    rel = float(((cost.double() - ref_cost.double()).abs() / scale_cost.double()).max())
    dP = (st.P.double() - ref_st.P.double()).abs().reshape(NB, -1).amax(dim=1)
    return largest, rel, float(dP.median())


def phase_scaling(dev, smi):
    """scaling_bench.py and __graft_entry__.py's dry run through the port
    (isvins_tpu_torch.scaling_bench.run, isvins_tpu_torch.multichip), over
    every card torch sees (one card: listed nd times): the dense against the
    dd pose-graph sweep at K = 256 and 1024 (f64, with covariance), 16
    product windows over nd = 1, 2, 4, 8, the dd solve's per-device programs
    timed by graph replay at K = 256 and 1024, and
    dryrun_multichip(SCALING_DRYRUN_N). Held: f64 dd against f64 dense at
    the reference tests' tolerances; the window rows of every nd against
    the nd = 1 batch within the multiseq phase's f32 bar (3x the gap of the
    16 windows solved one by one to the f64 solve), in cost and in
    position, their gap to the f64 solve printed; each nd's batched solve
    dispatched again under set_sync_debug_mode("error") with the same bits;
    the dry run's assertions. Launches: K1, K2 and K5 (the batched windows),
    none of K3, K4, K6, K7."""
    import torch

    from isvins_tpu_torch import multichip, ops, scaling_bench
    from isvins_tpu_torch.parallel import cycle_mesh, make_batch_problem, sharded_batch_solve
    from isvins_tpu_torch.solver import solve_window
    from isvins_tpu_torch.utils.convert import tree_map

    checks, sols, windows = {}, {}, {}
    ops.reset_launch_counts()  # just before the main path
    t0 = time.perf_counter()
    out = scaling_bench.run(dd_solutions=sols, window_results=windows)
    t1 = time.perf_counter()
    dry = multichip.dryrun_multichip(SCALING_DRYRUN_N)
    _sync(dev)
    counts = ops.launch_counts()  # just after the main path
    t2 = time.perf_counter()
    print(json.dumps(out))
    for K, by_nd in sols.items():
        for nd in scaling_bench.DD_NDS:
            _pg_check(f"scaling K={K} dd{nd} vs dense, card f64", by_nd[nd], by_nd[1],
                      F64_BOUNDS, checks)

    # the window rows of every nd against the nd = 1 batch, within the
    # multiseq phase's f32 bar: 3x the gap of the 16 windows solved one by
    # one (solve_window, K3 and K4 inside) to the f64 solve of the same
    # windows, in cost and in position. The rows of nd devices are those of
    # chunks of 16 / nd windows solved on one device, bit for bit; a chunk of
    # 2 rounds its batched matrix-vector products (the IMU whitening, the
    # gradient, W dx) and the cost's row sums otherwise than a chunk of 16,
    # and five f32 LM iterations carry that as far as another f32 path does
    # (window_batch_probe.py)
    dims, nb, iters = scaling_bench.PRODUCT_DIMS, scaling_bench.WINDOW_NB, scaling_bench.WINDOW_ITERS
    prob = make_batch_problem(nb, dims, torch.float32, device=dev)
    f64 = lambda t: tree_map(lambda a: a.double() if a.is_floating_point() else a, t)
    st64, c64 = sharded_batch_solve([dev], dims, iters=iters)[0](*f64(prob[:4]), prob[4].double(),
                                                                   prob[5].double())
    row = lambda k: [tree_map(lambda a: a[k].contiguous(), t) for t in prob[:4]]
    solo = [solve_window(*row(k), prob[4], prob[5], dims, iters=iters) for k in range(nb)]
    solo_st = type(st64)(*(torch.stack(leaf) for leaf in zip(*(st for st, _ in solo))))
    _, own_rel, own_mid = _window_gaps(solo_st, torch.stack([c for _, c in solo]), st64, c64, c64)
    st1, c1 = windows[1]
    wrec, bad = {"single_f32_rel_cost_gap_vs_f64": own_rel,
                 "single_f32_median_dP_vs_f64_m": own_mid}, []
    for nd, (st, cost) in windows.items():
        mesh = cycle_mesh(nd)
        step, shard = sharded_batch_solve(mesh, dims, iters=iters)
        shards = shard(prob[:4])
        trees = shards if nd == 1 else tuple(zip(*shards))
        _sync(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = step(*trees, prob[4], prob[5])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        rerun = _window_gaps(*again, st, cost, c64)[0]
        largest, rel, mid = _window_gaps(st, cost, st1, c1, c64)
        _, rel64, mid64 = _window_gaps(st, cost, st64, c64, c64)
        wrec[str(nd)] = {"max_abs_gap_vs_nd1": largest, "rel_cost_gap_vs_nd1": rel,
                         "median_dP_vs_nd1_m": mid, "rel_cost_gap_vs_f64": rel64,
                         "median_dP_vs_f64_m": mid64, "guarded_rerun_gap": rerun,
                         "distinct_devices": len(set(mesh))}
        print(f"[scaling] window rows nd={nd} ({len(set(mesh))} distinct) against nd=1: "
              + ("equal bit for bit" if largest == 0.0 else
                 f"largest gap {largest:.3g}, rel cost {rel:.3g}, median max|dP| {mid:.3g} m")
              + f" (bar: 3x the single f32 solves' gap to f64, {own_rel:.3g} and {own_mid:.3g} m);"
              f" against f64: rel cost {rel64:.3g}, median max|dP| {mid64:.3g} m; dispatched "
              f"again under set_sync_debug_mode('error'): gap {rerun:.3g}")
        if not (rel <= 3 * own_rel + 1e-6 and mid <= 3 * own_mid + 1e-6 and rerun == 0.0):
            bad.append(nd)
    n_cards = torch.cuda.device_count()
    rec = {"scaling": out, "checks": checks, "window_rows": wrec, "cards": n_cards,
           "dryrun": {"mesh": dry["mesh"], "distinct_devices": dry["distinct_devices"],
                      "n_solved": dry["n_solved"],
                      "sequence_costs": [s["last_cost"] for s in dry["sequences"]]},
           "sweep_s": t1 - t0, "dryrun_s": t2 - t1, "launches_scaling": counts}
    print(json.dumps({"scaling_checks": {k: v for k, v in rec.items() if k != "scaling"},
                      "card": smi}))
    print(f"[scaling] {n_cards} card(s); distinct devices per dd row: "
          + ", ".join(f"K={K}: " + "/".join(str(r["distinct_devices"]) for r in
                                            out[f"posegraph_dd_K{K}"]["measured_virtual_mesh"]
                                            .values()) for K in (256, 1024))
          + f"; sweep {t1 - t0:.1f} s, dryrun_multichip({SCALING_DRYRUN_N}) on {dry['mesh']} "
          f"{t2 - t1:.1f} s ({dry['n_solved']} sequences solved); launches {counts}")
    fails = []
    if bad:
        fails.append(f"window rows at nd {bad} further from the nd = 1 rows than 3x the single "
                     "f32 solves' gap to f64, or a guarded rerun differs")
    on = ("proj_rows", "imu_rows", "chol_solve_batched")
    if any(counts[k] <= 0 for k in on) or any(counts[k] for k in counts if k not in on):
        fails.append(f"scaling-path launches {counts}: K1, K2 and K5 must run, no other")
    if fails:
        raise AssertionError("; ".join(fails))
    return counts, rec


# The JAX package's run of bench.py's e2e stage on the CPU (bench_reference.py:
# `JAX_PLATFORMS=cpu python3 bench_reference.py`, 2026-10-17; render 10.9 s,
# drive 114.0 s on one CPU host; PERF.md section 4). The e2e phase is held to
# it: the frame whose packet the estimator initialized on, keyframes, loops and
# their precision (30 cm rule), both ATEs.
E2E_REFERENCE = {"e2e_init_frame": 19, "e2e_keyframes": 55, "e2e_loops_closed": 7,
                 "e2e_loop_precision": 1.0, "e2e_ate_vio_m": 0.6221357444957835,
                 "e2e_ate_loop_m": 0.2950747561049152, "e2e_frames_measured": 55,
                 "solved_poses": 110}
E2E_BUDGET_S = 300.0  # each drive's wall budget: a spent budget fails the phase
POSE_GAP_TOL = 1e-9  # async against sync (tests/test_pipeline_mode.py:73-98)


def phase_e2e(dev, smi, frames, solve_fps, batched):
    """bench.py's e2e stage on the card through isvins_tpu_torch.bench:
    System(enable_loop=True, pipeline=True, pg_thread=True,
    solve_async=True) on the posegraph phase's 130 rendered frames, then the
    same frames with solve_async=False. In the async drive every steady
    solve dispatch (Estimator._dispatch_steady) runs under
    torch.cuda.set_sync_debug_mode("error"), which raises at any host read;
    the mode is process-wide, so the pose-graph worker's items
    (PoseGraphBuilder.push, where all its device work and host reads are)
    and the guarded dispatches exclude each other through one lock. Every K6
    query of the drive is replayed exactly. Held to the JAX package's run
    (E2E_REFERENCE), to the synchronous drive (poses within POSE_GAP_TOL,
    the same keyframes and loops) and to no stalling frame."""
    import threading

    import numpy as np
    import torch

    from isvins_tpu_torch import bench, ops
    from isvins_tpu_torch.estimator.estimator import Estimator
    from isvins_tpu_torch.posegraph import PoseGraphBuilder
    from isvins_tpu_torch.system import System

    ref = E2E_REFERENCE
    cfg, _ = bench.e2e_config()
    world, _ = bench.e2e_world()
    lock, guarded, made = threading.Lock(), [], []
    dispatch, push, init = Estimator._dispatch_steady, PoseGraphBuilder.push, System.__init__

    def guarded_dispatch(self, args, device=None):
        with lock:
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = dispatch(self, args, device)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        guarded.append(1)
        return out

    def locked_push(self, *a, **k):
        with lock:
            return push(self, *a, **k)

    def watched_init(self, *a, **k):
        init(self, *a, **k)
        made.append(self)
        self._init_at = _watch_init(self.estimator, world.frame_times)

    print(f"[e2e] bench.bench_e2e on the card: {len(frames)} frames "
          f"{cfg.camera.width}x{cfg.camera.height}, max_cnt {cfg.tracker.max_cnt}, "
          f"System(pipeline=True, pg_thread=True, solve_async=True), then solve_async=False")
    Estimator._dispatch_steady, PoseGraphBuilder.push = guarded_dispatch, locked_push
    System.__init__ = watched_init
    ops.reset_launch_counts()  # just before the main path
    try:
        a = bench.bench_e2e(dev, solve_async=True, frames=frames, budget_s=E2E_BUDGET_S)
        _sync(dev)
        counts = ops.launch_counts()  # just after the main path
    finally:
        Estimator._dispatch_steady, PoseGraphBuilder.push = dispatch, push
        System.__init__ = init
    sa = made[0]
    db, est = sa.pgbuilder.db, sa.estimator
    _replay_k6(dev, db, cfg.posegraph, "e2e")
    s = bench.bench_e2e(dev, solve_async=False, frames=frames, budget_s=E2E_BUDGET_S)
    ss = s["system"]
    head = bench.headline(solve_fps, batched)
    print(json.dumps(head))
    print(json.dumps(bench.final_line(head, a)))

    ta, ts_ = a["trajectory"], s["trajectory"]
    same_ts = [x[0] for x in ta] == [x[0] for x in ts_]
    gap_p = max(float(np.abs(x[1] - y[1]).max()) for x, y in zip(ta, ts_))
    gap_q = max(float(np.abs(x[2] - y[2]).max()) for x, y in zip(ta, ts_))
    n_loops, precision = _loop_precision(db, {"t": world.frame_times, "p": world.P,
                                              "q": world.Q})
    med = lambda name: a["phases"].get(name, {}).get("median_ms")
    n_solves = est.steady_solves
    rec = {
        "e2e_init_frame": sa._init_at[0] if sa._init_at else None,
        "e2e_loop_precision": precision, "solved_poses": len(ta), "steady_solves": n_solves,
        "guarded_dispatches": len(guarded), "k6_queries": len(db.match_count_queries),
        "e2e_median_ms_sync": s["e2e_median_ms"], "e2e_p90_ms_sync": s["e2e_p90_ms"],
        "e2e_max_ms_sync": s["e2e_max_ms"], "e2e_pipeline_fps_sync": s["e2e_pipeline_fps"],
        "e2e_keyframes_sync": s["e2e_keyframes"], "e2e_loops_closed_sync": s["e2e_loops_closed"],
        "est_solve_dispatch_median_ms": med("est.solve_dispatch"),
        "est_solve_collect_median_ms": med("est.solve_collect"),
        "trk_dispatch_median_ms": med("trk.dispatch"),
        "est_process_image_median_ms": med("est.process_image"),
        "sync_est_process_image_median_ms":
            s["phases"].get("est.process_image", {}).get("median_ms"),
        "async_sync_same_timestamps": same_ts, "async_sync_max_dP_m": gap_p,
        "async_sync_max_dQ": gap_q, "launches_e2e": counts,
        "phases_async": a["phases"], "reference": ref,
    }
    print(json.dumps({"e2e": rec, "card": smi}))
    print(f"[e2e] async: init on frame {rec['e2e_init_frame']}'s packet (JAX "
          f"{ref['e2e_init_frame']}), {a['e2e_keyframes']} keyframes (JAX {ref['e2e_keyframes']}), "
          f"{a['e2e_loops_closed']} loops at precision {precision} (JAX {ref['e2e_loops_closed']} at "
          f"{ref['e2e_loop_precision']}), ATE vio {a['e2e_ate_vio_m']:.4f} m, loop "
          f"{a['e2e_ate_loop_m']:.4f} m (JAX {ref['e2e_ate_vio_m']:.4f}, {ref['e2e_ate_loop_m']:.4f})")
    print(f"[e2e] steady frame median / p90 / max: async {a['e2e_median_ms']:.1f} / "
          f"{a['e2e_p90_ms']:.1f} / {a['e2e_max_ms']:.1f} ms, sync {s['e2e_median_ms']:.1f} / "
          f"{s['e2e_p90_ms']:.1f} / {s['e2e_max_ms']:.1f} ms; est.solve_dispatch "
          f"{rec['est_solve_dispatch_median_ms']} ms, est.solve_collect "
          f"{rec['est_solve_collect_median_ms']} ms (medians); async against sync: max|dP| "
          f"{gap_p:.3g} m, max|dQ| {gap_q:.3g}; {len(guarded)} dispatches under "
          f"set_sync_debug_mode('error'); launches {counts}")

    fails = []
    if a["e2e_frames_processed"] != len(frames) or s["e2e_frames_processed"] != len(frames):
        fails.append(f"frames processed {a['e2e_frames_processed']} / "
                     f"{s['e2e_frames_processed']} of {len(frames)} (a spent budget)")
    if rec["e2e_init_frame"] is None or abs(rec["e2e_init_frame"] - ref["e2e_init_frame"]) > 2:
        fails.append(f"e2e_init_frame {rec['e2e_init_frame']} not within 2 of "
                     f"{ref['e2e_init_frame']}")
    if abs(a["e2e_keyframes"] - ref["e2e_keyframes"]) > 0.1 * ref["e2e_keyframes"]:
        fails.append(f"{a['e2e_keyframes']} keyframes, not within 10 % of "
                     f"{ref['e2e_keyframes']}")
    if n_loops < 1 or precision < ref["e2e_loop_precision"]:
        fails.append(f"{n_loops} loops at precision {precision} (JAX "
                     f"{ref['e2e_loop_precision']})")
    for k in ("e2e_ate_loop_m", "e2e_ate_vio_m"):
        if not a[k] <= 1.5 * ref[k] + 0.05:
            fails.append(f"{k} {a[k]} > 1.5 x JAX's {ref[k]} + 0.05 m")
    for d, label in ((a, "async"), (s, "sync")):
        if d["e2e_p90_ms"] > 3 * d["e2e_median_ms"] or d["e2e_max_ms"] > 8 * d["e2e_median_ms"]:
            fails.append(f"{label} frames stall over the second half of the steady frames: "
                         f"median {d['e2e_median_ms']}, p90 {d['e2e_p90_ms']}, max "
                         f"{d['e2e_max_ms']}")
    if not (same_ts and len(ta) == len(ts_) > 0 and gap_p <= POSE_GAP_TOL
            and gap_q <= POSE_GAP_TOL):
        fails.append(f"async and sync drives part: same timestamps {same_ts} "
                     f"({len(ta)} against {len(ts_)} poses), max|dP| {gap_p}, max|dQ| {gap_q}")
    if (a["e2e_keyframes"], a["e2e_loops_closed"]) != (s["e2e_keyframes"], s["e2e_loops_closed"]) \
            or not np.array_equal(db.loop_idx[:db.n], ss.pgbuilder.db.loop_idx[:db.n]):
        fails.append(f"keyframes / loops: async {a['e2e_keyframes']} / {a['e2e_loops_closed']}, "
                     f"sync {s['e2e_keyframes']} / {s['e2e_loops_closed']}")
    if len(guarded) != n_solves - 1 or n_solves < 8:
        # every steady solve but the init frame's (solve_odometry(first=True))
        fails.append(f"{len(guarded)} guarded dispatches for {n_solves} steady solves")
    if est.failure_count or ss.estimator.failure_count:
        fails.append(f"failure_count {est.failure_count} / {ss.estimator.failure_count}")
    iters = cfg.solver.max_iterations
    expect = dict.fromkeys(counts, 0)
    expect.update(proj_rows=n_solves * (iters + 1), imu_rows=n_solves * (iters + 1),
                  schur_corr=n_solves * iters, linstep=n_solves * iters,
                  retrieval_scores=len(db.match_count_queries))
    if counts != expect or not counts["retrieval_scores"]:
        fails.append(f"e2e-path launches {counts} != {expect} (K6 must run)")
    if fails:
        raise AssertionError("; ".join(fails))
    return counts, {**{k: a[k] for k in ("e2e_pipeline_fps",) + bench.E2E_FIELDS}, **rec}


# The JAX package's retrieval sweep on the CPU (retrieval_reference.py:
# `JAX_PLATFORMS=cpu python3 retrieval_reference.py --keyframes 250 500`,
# 2026-10-17; build 69.8 s and evaluation 53.9 s at 500 keyframes, 35.0 s and
# 39.8 s at 250, on one CPU host; PERF.md section 4). Its 500-keyframe fields
# equal RETRIEVAL_r05.json's rounded ones. The retrieval phase is held to it.
RETRIEVAL_REFERENCE = {
    500: {"keyframes": 500, "queries_with_truth": 417, "retrieval_recall_at_4": 0.9328537170263789,
          "retrieval_precision": 0.6845637583892618, "verified_loop_recall": 0.9904076738609112,
          "verified_loop_precision": 0.9954441913439636, "loops_fired": 439,
          "loop_rel_t_err_median_m": 0.015594935356193124,
          "loop_rel_yaw_err_median_deg": 0.1537919358418094},
    250: {"keyframes": 250, "queries_with_truth": 167, "retrieval_recall_at_4": 0.9041916167664671,
          "retrieval_precision": 0.5266497461928934, "verified_loop_recall": 0.9700598802395209,
          "verified_loop_precision": 0.9893617021276596, "loops_fired": 188,
          "loop_rel_t_err_median_m": 0.01776116608211717,
          "loop_rel_yaw_err_median_deg": 0.2692296842421058},
}
RETRIEVAL_KF = 250  # retrieval_bench.py runs 500; 250 keeps the script inside its time


def _render_retrieval(n_kf, ks):
    """Frames ks of retrieval_bench.retrieval_world(n_kf)'s renderer."""
    from isvins_tpu_torch.retrieval_bench import retrieval_world

    renderer = retrieval_world(n_kf)[1]
    return [renderer.render(k)[0] for k in ks]


def phase_retrieval(dev, n_kf=RETRIEVAL_KF):
    """retrieval_bench.py's loop-retrieval sweep through the port on the card
    (isvins_tpu_torch.retrieval_bench): n_kf keyframes about 0.3 m apart on
    an r = 3 m circle (about 8 laps at 500), corners and BRIEF on the card,
    the keyframe database's post-freeze tf-idf retrieval and the builder's
    PnP verification. Frames are rendered first by
    utils.synthetic.RENDER_PROCS processes.
    Held to the JAX package's sweep (RETRIEVAL_REFERENCE)."""
    import numpy as np

    from isvins_tpu_torch import ops
    from isvins_tpu_torch.config import PoseGraphConfig
    from isvins_tpu_torch.retrieval_bench import build_db, evaluate, summarize
    from isvins_tpu_torch.utils.synthetic import render_in_processes

    ref = RETRIEVAL_REFERENCE[n_kf]
    t0 = time.perf_counter()
    frames = render_in_processes(_render_retrieval, n_kf, n_kf)
    render_s = time.perf_counter() - t0
    pg = PoseGraphConfig(skip_recent=50, min_loop_matches=15)
    ops.reset_launch_counts()  # just before the main path
    t0 = time.perf_counter()
    db, gt_t, gt_yaw, _, _ = build_db(n_kf, device=dev, frames=frames)
    t1 = time.perf_counter()
    st = evaluate(db, gt_t, gt_yaw, pg)
    t2 = time.perf_counter()
    _sync(dev)
    counts = ops.launch_counts()  # just after the main path
    out = summarize(st, db.n)
    rec = {**out, "match_count_queries": len(db.match_count_queries), "build_s": t1 - t0,
           "evaluate_s": t2 - t1, "render_s": render_s,
           "find_connection_median_ms": float(np.median(st["find_connection_ms"])),
           "find_connection_calls": len(st["find_connection_ms"]),
           "launches_retrieval": counts, "reference": ref}
    print(json.dumps({"retrieval": rec}))
    print(f"[retrieval] {n_kf} keyframes (rendered in {render_s:.1f} s): built in "
          f"{rec['build_s']:.1f} s, evaluated in {rec['evaluate_s']:.1f} s "
          f"({rec['find_connection_calls']} _find_connection calls, median "
          f"{rec['find_connection_median_ms']:.2f} ms); recall@4 "
          f"{out['retrieval_recall_at_4']:.4f} (JAX {ref['retrieval_recall_at_4']:.4f}), verified "
          f"recall {out['verified_loop_recall']:.4f} at precision "
          f"{out['verified_loop_precision']:.4f} (JAX {ref['verified_loop_recall']:.4f} at "
          f"{ref['verified_loop_precision']:.4f}), {out['loops_fired']} loops (JAX "
          f"{ref['loops_fired']}); K6 queries {rec['match_count_queries']}")
    fails = []
    for k in ("keyframes", "queries_with_truth"):
        if out[k] != ref[k]:
            fails.append(f"{k} {out[k]} != JAX's {ref[k]}")
    for k in ("retrieval_recall_at_4", "verified_loop_recall"):
        if out[k] < ref[k] - 0.01:
            fails.append(f"{k} {out[k]} < JAX's {ref[k]} - 0.01")
    if out["verified_loop_precision"] < ref["verified_loop_precision"] - 0.005:
        fails.append(f"verified_loop_precision {out['verified_loop_precision']} < JAX's "
                     f"{ref['verified_loop_precision']} - 0.005")
    if abs(out["loops_fired"] - ref["loops_fired"]) > 0.02 * ref["loops_fired"]:
        fails.append(f"loops_fired {out['loops_fired']} not within 2 % of {ref['loops_fired']}")
    for k in ("loop_rel_t_err_median_m", "loop_rel_yaw_err_median_deg"):
        if not out[k] <= 1.5 * ref[k]:
            fails.append(f"{k} {out[k]} > 1.5 x JAX's {ref[k]}")
    expect = dict.fromkeys(counts, 0)
    expect["retrieval_scores"] = len(db.match_count_queries)
    if counts != expect:
        fails.append(f"retrieval-path launches {counts} != {expect}")
    if fails:
        raise AssertionError("; ".join(fails))
    return counts, rec


def main():
    import torch

    phase_s, t = {}, [time.perf_counter()]

    def lap(name):  # wall seconds of each phase, printed with the results
        now = time.perf_counter()
        phase_s[name] = round(now - t[0], 1)
        t[0] = now

    dev, smi = phase_device()
    phase_build()
    lap("device+build")
    records = phase_kernels(dev)
    lap("kernels")
    solve = phase_solve(dev)
    lap("solve")
    _, sl = phase_slice(dev)
    lap("slice")
    counts, pg, pg_frames = phase_posegraph(dev)
    lap("posegraph")
    ms_counts, ms = phase_multiseq_solve(dev, solve["vio_window_solve_frames_per_s"],
                                         records["chol_solve_batched"]["ms"])
    est_counts, ms_est = phase_multiseq_estimators(dev)
    lap("multiseq")
    red_counts = phase_reduce(dev)
    lap("reduce")
    world, frames = room_world(SYSTEM_FRAMES)
    lap("render")
    render_s = phase_s["render"]
    print(f"[render] {SYSTEM_FRAMES} frames at 752x480 in {render_s:.1f} s")
    pix_counts, pix, trk = phase_pixels(dev, smi, world, frames, render_s)
    lap("pixels")
    nullspace = nullspace_cost(dev)  # its host times before phase_profiler's tracing
    phase_profiler(dev, records)
    pix.update(tracker_launches(dev, trk))  # the profiler's count, after its phase
    lap("profiler")
    sys_counts, system, sys_traj = phase_system(dev, smi, world, frames, render_s)
    lap("system")
    rea_counts, realism = phase_realism(dev, smi, world, frames, system, sys_traj)
    del frames
    lap("realism")
    pgd_counts, pgdist = phase_pgdist(dev)
    lap("pgdist")
    sca_counts, scaling = phase_scaling(dev, smi)
    lap("scaling")
    e2e_counts, e2e = phase_e2e(dev, smi, pg_frames, solve["vio_window_solve_frames_per_s"],
                                {nb: ms[f"batched_x{nb}_throughput"] for nb in (8, 16, 32)})
    lap("e2e")
    ret_counts, retrieval = phase_retrieval(dev)
    lap("retrieval")
    # K5's launches are the multiseq path's (both halves), K7's its own
    # path's, the others' the posegraph path's; `launches_pixels` and
    # `launches_system` are the pixels and system paths', `launches_pgdist`
    # the pose graph across devices' (none: plain torch), `launches_e2e` and
    # `launches_retrieval` bench.py's e2e stage's and the retrieval sweep's,
    # `launches_realism` and `launches_scaling` realism_bench.py's async drive's
    # and the multi-device sweeps' with the dry run
    counts["chol_solve_batched"] = (ms_counts["chol_solve_batched"]
                                    + est_counts["chol_solve_batched"])
    counts["schur_reduce"] = red_counts["schur_reduce"]
    print(json.dumps({"solve": solve, "slice": sl, "posegraph": pg,
                      "multiseq": {**ms, **ms_est}, "pixels": pix, "system": system,
                      "realism": realism, "pgdist": pgdist, "scaling": scaling, "e2e": e2e,
                      "retrieval": retrieval,
                      "nullspace": nullspace, "phase_s": phase_s}))
    print(smi)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_META[k][0],
         "replaces": KERNEL_META[k][1], "launches": counts[k],
         "launches_pixels": pix_counts[k], "launches_system": sys_counts[k],
         "launches_pgdist": pgd_counts[k], "launches_e2e": e2e_counts[k],
         "launches_retrieval": ret_counts[k], "launches_realism": rea_counts[k],
         "launches_scaling": sca_counts[k], **records[k]}
        for k in KERNEL_META]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
