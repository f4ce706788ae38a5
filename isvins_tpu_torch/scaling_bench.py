"""Multi-device scaling of the distributed pose-graph solve and the
data-parallel window solver (port of scaling_bench.py).

    python -m isvins_tpu_torch.scaling_bench [--device cpu] [--out PATH]

Prints one JSON line with scaling_bench.py's keys (scaling_bench.py:356-362):

  1. `posegraph_dd_K256`, `posegraph_dd_K1024`: the dense edge-sharded
     solve on one device against the nested-dissection (dd) solve over 2, 4
     and 8 devices, 3 Gauss-Newton iterations with covariance, f64, on
     scaling_bench.py's random pose graph (K poses, K chain edges, K / 16
     loops); host clock around a synchronize() of every device, the mean of
     two runs after a warm-up.
  2. `window_solve_data_parallel`: 16 product windows (B=18/Vo=8/F=1000,
     N=3072, f32, 5 LM iterations) through sharded_batch_solve over 1, 2, 4
     and 8 devices; no communication inside the solve.
  3. `chip`: chip_phases at K = 256 and 1024, the dd solve's per-device
     programs at their exact shapes (f32), each timed on the card by CUDA-
     graph replay, and the interface sum between distinct cards.

The devices: every CUDA card torch sees (`--device` names one device for
all of them). A sweep point that asks for more devices than there are lists
them in turn (parallel.cycle_mesh: on one card, the card nd times, whose
shards then run as one batched program), and every row says how many
distinct devices it ran on (`distinct_devices`). The keys keep
scaling_bench.py's names (`measured_virtual_mesh`,
`measured_ms_virtual_mesh`), which there meant 8 virtual CPU devices.
Writes a file only at `--out`. A failure raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .bench import PRODUCT_DIMS
from .solver import WindowDims

DD_NDS = (2, 4, 8)
WINDOW_NDS = (1, 2, 4, 8)
WINDOW_NB, WINDOW_ITERS = 16, 5


def _log(msg: str):
    print(f"# {msg}", file=sys.stderr, flush=True)


def posegraph_problem(K, E, n_loops, seed=0):
    """scaling_bench._posegraph_problem (scaling_bench.py:73-97) in numpy,
    f64, the same draws in the same order: a random-walk chain of K poses
    (pose 0 fixed), E chain edges k -> k + 1 (the last ones clamped to
    K - 2 -> K - 1) with sqrt-information 20 I, a roll-pitch edge on every
    pose (5 I), max(16, n_loops) loops of weight 100 from the first half to
    the second. The 20 arrays of distributed_pose_graph_solve."""
    rng = np.random.default_rng(seed)
    ident = lambda n: np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))
    t = np.cumsum(rng.normal(size=(K, 3)) * 0.05, axis=0)
    e_i = np.minimum(np.arange(E), K - 2).astype(np.int32)
    e_dt = rng.normal(size=(E, 3)) * 0.05
    L = max(16, n_loops)
    loop_i = rng.integers(0, K // 2, L).astype(np.int32)
    loop_j = rng.integers(K // 2, K - 1, L).astype(np.int32)
    loop_dt = rng.normal(size=(L, 3)) * 0.05
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (t, ident(K), np.ones(K, bool), fixed,
            e_i, e_i + 1, e_dt, ident(E), np.tile(np.eye(6)[None] * 20.0, (E, 1, 1)),
            np.ones(E, bool),
            np.arange(K, dtype=np.int32), ident(K), np.tile(np.eye(2)[None] * 5.0, (K, 1, 1)),
            np.ones(K, bool),
            loop_i, loop_j, loop_dt, ident(L), np.ones(L) * 100.0, np.ones(L, bool))


def _sync(devices):
    import torch

    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _mean_s(fn, devices, n):
    """fn() once (its result), then the mean host-clock seconds of n more
    calls, every device of the mesh synchronized at both ends."""
    out = fn()
    _sync(devices)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(devices)
    return (time.perf_counter() - t0) / n, out


def _distinct(mesh) -> int:
    return len(set(mesh))


def bench_posegraph_dd(K: int = 1024, iters: int = 3, devices=None, reps: int = 2,
                       solutions=None) -> dict:
    """scaling_bench.py:100-147: the dense solve on the first device against
    dd at nd = 2, 4, 8 (parallel.cycle_mesh over `devices`), with
    covariance, f64. Rows: `ms`, and for dd `speedup_vs_dense_1dev`,
    `efficiency_vs_dense` (t_dense / (nd t_dd)) and
    `efficiency_fixed_alg_vs_2dev` (2 t_dd(2) / (nd t_dd(nd))), each with
    `distinct_devices`. `solutions`, a dict, receives each row's solve
    (t, q, cov, cost) under its nd (1: the dense solve)."""
    from .parallel import cycle_mesh, dd_pose_graph_solve, distributed_pose_graph_solve

    args = posegraph_problem(K, K, max(16, K // 16))
    home = cycle_mesh(1, devices)
    t1, sol = _mean_s(lambda: distributed_pose_graph_solve(home, *args, iters=iters,
                                                           with_cov=True), home, reps)
    _log(f"posegraph K={K} dense 1-dev: {t1 * 1e3:.1f} ms")
    rows = {"1": {"ms": t1 * 1e3, "solver": "dense", "distinct_devices": 1}}
    if solutions is not None:
        solutions[1] = sol
    t_dd = {}
    for nd in DD_NDS:
        mesh = cycle_mesh(nd, devices)
        tn, sol = _mean_s(lambda: dd_pose_graph_solve(mesh, *args, iters=iters, with_cov=True),
                          mesh, reps)
        if solutions is not None:
            solutions[nd] = sol
        t_dd[nd] = tn
        rows[str(nd)] = {"ms": tn * 1e3, "solver": "dd", "distinct_devices": _distinct(mesh),
                         "speedup_vs_dense_1dev": t1 / tn, "efficiency_vs_dense": t1 / (nd * tn),
                         "efficiency_fixed_alg_vs_2dev": 2 * t_dd[2] / (nd * tn)}
        _log(f"posegraph K={K} dd {nd}-dev ({_distinct(mesh)} distinct): {tn * 1e3:.1f} ms "
             f"({t1 / tn:.2f}x vs dense)")
    return {
        "K": K, "E": K, "loops": max(16, K // 16), "iters": iters, "with_cov": True,
        "dtype": "float64", "device": str(home[0]), "measured_virtual_mesh": rows,
        "note": "host clock around a synchronize() of every device, the mean of"
                f" {reps} runs after a warm-up. A mesh with fewer distinct devices"
                " than nd lists a device more than once; its shards run as one"
                " batched program there. efficiency_vs_dense includes the"
                " algorithmic win of dd over the dense solve;"
                " efficiency_fixed_alg_vs_2dev holds the dd algorithm fixed.",
    }


def bench_window_dp(devices=None, nb: int = WINDOW_NB, dims: WindowDims = PRODUCT_DIMS,
                    iters: int = WINDOW_ITERS, reps: int = 3, results=None) -> dict:
    """scaling_bench.py:307-339: make_batch_problem(nb, dims, f32) through
    sharded_batch_solve over nd = 1, 2, 4, 8 devices (parallel.cycle_mesh;
    nd up to nb): strong scaling, the batch cut into nd contiguous chunks,
    no collective.
    The mean host-clock time of `reps` batched solves after a warm-up.
    `results`, a dict, receives each nd's (state, cost) on the first
    device."""
    import torch

    from .parallel import cycle_mesh, make_batch_problem, sharded_batch_solve

    home = cycle_mesh(1, devices)[0]
    prob = make_batch_problem(nb, dims, torch.float32, device=home)
    trees, G, psi = prob[:4], prob[4], prob[5]
    nds, distinct, times = [], [], []
    for nd in (nd for nd in WINDOW_NDS if nd <= nb):
        mesh = cycle_mesh(nd, devices)
        step, shard = sharded_batch_solve(mesh, dims, iters=iters)
        shards = shard(trees)
        call = ((lambda: step(*shards, G, psi)) if nd == 1
                else (lambda: step(*zip(*shards), G, psi)))
        dt, out = _mean_s(call, mesh, reps)
        if results is not None:
            results[nd] = out
        nds.append(nd)
        distinct.append(_distinct(mesh))
        times.append(dt * 1e3)
        _log(f"window-dp {nd} device(s) ({distinct[-1]} distinct): {dt * 1e3:.1f} ms for {nb} "
             "solves")
    return {
        "batch": nb, "dims": f"B={dims.B},F={dims.F},N={dims.N},iters={iters}",
        "devices": nds, "distinct_devices": distinct,
        "measured_ms_virtual_mesh": times, "collectives_inside_solve": 0,
        "note": "zero-collective data parallelism: the batch is cut into nd contiguous"
                " chunks, one batched solve per device, concatenated on the first; a"
                " device listed more than once runs its chunks one after the other",
    }


def _timer(dev, reps):
    """ms per call of a program on `dev`: by CUDA-graph replay on the card
    (utils.timing.graph_ms), by the host clock on the CPU."""
    if dev.type == "cuda":
        from .utils.timing import graph_ms

        return lambda fn: graph_ms(fn, reps=reps, replays=3)

    def host(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    return host


def chip_phases(K: int = 1024, n_loops=None, iters: int = 3, devices=None) -> dict:
    """scaling_bench.py:150-305: the dd solve's per-device programs and the
    single-device dense solve at their exact shapes, f32, each timed on the
    first device (CUDA-graph replay on the card; the chained fori_loop of
    the reference works around the TPU runtime and is not copied). Dense:
    one GN iteration (JᵀJ + 2I, Cholesky, a solve) and the covariance (H⁻¹)
    at D = 6K. Per nd = 2, 4, 8 on dd_partition's shapes: the interior
    Cholesky, W = A⁻¹B, the Schur complement S and its Cholesky, the
    back-solves (`gn_iter`), and the covariance blocks (`cov`: the program
    with them less gn_iter). The interface sum is measured where the mesh
    holds two or more distinct devices: every device's (nBd² + nBd) f32
    partial copied to the first and summed in mesh order, host clock around
    a synchronize() of every device; else it is null (nothing crosses a
    link). total_model = iters (gn_iter + interface) + cov."""
    import torch

    from .parallel import cycle_mesh
    from .parallel.dd_solver import dd_partition
    from .parallel.distributed import _cho_solve, _mesh_sum

    if n_loops is None:
        n_loops = max(16, K // 16)
    dev = cycle_mesh(1, devices)[0]
    big = K >= 1024
    timed = _timer(dev, 5 if big else 20)
    rng = np.random.default_rng(0)
    e_i = np.minimum(np.arange(K), K - 2).astype(np.int32)
    loop_i = rng.integers(0, K // 2, n_loops).astype(np.int32)
    loop_j = rng.integers(K // 2, K - 1, n_loops).astype(np.int32)
    f32 = torch.float32
    normal = lambda rows, cols: torch.as_tensor(
        rng.normal(size=(rows, cols)) / np.sqrt(rows), dtype=f32).to(dev)
    eye = lambda n: torch.eye(n, dtype=f32, device=dev)
    chol = lambda M: torch.linalg.cholesky_ex(M)[0]

    D = 6 * K
    J1 = normal(12 * (K + n_loops) + 2 * K, D)
    I_D = eye(D)

    def dense_gn():
        L = chol(J1.T @ J1 + 2.0 * I_D)
        return _cho_solve(J1[0][:, None], L)

    def dense_cov():
        L = chol(J1.T @ J1 + 2.0 * I_D)
        return _cho_solve(I_D, L)

    t_gn1 = timed(dense_gn)
    t_cov1 = max(timed(dense_cov) - t_gn1, 1e-4)
    t1 = iters * t_gn1 + t_cov1
    del J1, I_D
    out = {"backend": str(dev), "K": K, "iters": iters, "dtype": "float32",
           "timing": "CUDA-graph replay" if dev.type == "cuda" else "host clock",
           "dense_1dev_ms": {"gn_iter": t_gn1, "cov": t_cov1, "total_model": t1},
           "per_device_ms": {}, "eff_model_vs_dense": {}, "eff_model_fixed_alg_vs_2dev": {}}
    t_dd = {}
    for nd in DD_NDS:
        part = dd_partition(nd, K, e_i, e_i + 1, np.ones(K, bool), np.arange(K, dtype=np.int32),
                            np.ones(K, bool), loop_i, loop_j, np.ones(n_loops, bool))
        Ki, NB = part["Ki"], part["NB"]
        nI, nBd = 6 * Ki, 6 * NB
        J = normal(12 * (K // nd + n_loops // nd) + 2 * (K // nd), nI + nBd)
        I_I, I_B = eye(nI), eye(nBd)

        def factor():
            H = J.T @ J
            A, B, C = H[:nI, :nI] + 2.0 * I_I, H[:nI, nI:], H[nI:, nI:]
            LA = chol(A)
            W = _cho_solve(B, LA)
            S = C - B.T @ W + (2.0 + nBd) * I_B
            return A, S, LA, W, chol(S)

        def dd_gn():
            A, S, LA, W, LS = factor()
            xB = _cho_solve(S[0][:, None], LS)
            return _cho_solve(A[0][:, None], LA) - W @ xB, xB

        def dd_cov():
            _, _, LA, W, LS = factor()
            U = _cho_solve(W.T, LS)
            corr = torch.einsum("kaB,Bkb->kab", W.reshape(Ki, 6, nBd), U.reshape(nBd, Ki, 6))
            return _cho_solve(I_I, LA), corr, _cho_solve(I_B[:, : max(nBd // nd, 6)], LS)

        t_gn = timed(dd_gn)
        t_cov = max(timed(dd_cov) - t_gn, 1e-4)
        mesh = cycle_mesh(nd, devices)
        n_dist = _distinct(mesh)
        iface_bytes = (nBd * nBd + nBd) * 4
        t_if = None
        if n_dist >= 2:
            parts = [torch.ones(nBd * nBd + nBd, dtype=f32, device=d) for d in mesh]
            t_if_s, _ = _mean_s(lambda: _mesh_sum([p.to(mesh[0]) for p in parts]), mesh, 20)
            t_if = t_if_s * 1e3
        tn = iters * (t_gn + (t_if or 0.0)) + t_cov
        t_dd[nd] = tn
        out["per_device_ms"][str(nd)] = {
            "Ki": int(Ki), "NB": int(NB), "gn_iter": t_gn, "cov": t_cov,
            "interface_sum_ms": t_if, "interface_bytes": iface_bytes,
            "distinct_devices": n_dist, "total_model": tn}
        out["eff_model_vs_dense"][str(nd)] = t1 / (nd * tn)
        out["eff_model_fixed_alg_vs_2dev"][str(nd)] = 2 * t_dd[2] / (nd * tn)
        _log(f"chip-phases K={K} nd={nd} ({n_dist} distinct): per-device gn {t_gn:.3f} ms, cov "
             f"{t_cov:.3f} ms, interface sum {t_if} ms; total {tn:.3f} ms, eff_dense "
             f"{t1 / (nd * tn):.2f}")
        del J, I_I, I_B
    out["interface_note"] = (
        "interface_sum_ms: measured on each mesh of two or more distinct devices (every"
        " device's (nBd^2 + nBd) f32 partial copied to the first and summed in mesh order);"
        " null where the mesh lists one device only: nothing crosses a link, and no analytic"
        " link rate stands in for a measurement")
    return out


def run(devices=None, dd_solutions=None, window_results=None) -> dict:
    """scaling_bench.py:356-362's object: the two pose-graph sweeps, the
    window sweep and the chip phases at K = 256 and 1024, on `devices`
    (None: every CUDA card). `dd_solutions` ({K: {nd: solve}}) and
    `window_results` ({nd: (state, cost)}), dicts, receive the solves."""
    from .parallel import cycle_mesh

    sols = {256: {}, 1024: {}} if dd_solutions is None else dd_solutions
    return {
        "metric": "multi_device_scaling",
        "cores": os.cpu_count() or 1,
        "devices": sorted({str(d) for d in cycle_mesh(8, devices)}),
        "posegraph_dd_K256": bench_posegraph_dd(K=256, devices=devices,
                                                solutions=sols.setdefault(256, {})),
        "posegraph_dd_K1024": bench_posegraph_dd(K=1024, devices=devices,
                                                 solutions=sols.setdefault(1024, {})),
        "window_solve_data_parallel": bench_window_dp(devices=devices, results=window_results),
        "chip": {f"chip_phases_K{k}": chip_phases(K=k, devices=devices) for k in (256, 1024)},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="one torch device for every mesh entry (default: every CUDA card)")
    ap.add_argument("--out", default=None, help="also write the JSON object to this path")
    args = ap.parse_args(argv)
    out = run(None if args.device is None else [args.device])
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
