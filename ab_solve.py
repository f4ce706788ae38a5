#!/usr/bin/env python3
"""Time the port's single window solve from two checkouts on one card.

    python3 ab_solve.py PARENT_ROOT CHANGE_ROOT [--rounds 4] [--slice]

Each root holds a checkout of this repository (an `isvins_tpu_torch`
package). Every measurement is a process of its own that imports the
package under one root, builds its kernels, and times `solve_window` on
make_batch_problem(1, (18, 8, 1000, 3072), float32), 10 LM iterations:
3 warm-ups, then 20 solves by the host clock around a synchronize, 20 more
with Python's cyclic garbage collector off, then one solve under
torch.profiler for the counts of host operators and device operations (the
summary's `note` says by how much K3's cluster launch moves the latter),
then the device times of K3, K7, K4, K5 (NB = 1 and 16), K1 and K2 (one
window's rows and 16 windows') at the product shapes: 100 calls of each
wrapper captured in a CUDA graph and replayed between two events, so the
kernels of two checkouts are compared in one call on one card (K6 and,
where the checkout takes them, K4 and K5 at D = 321, 366 and 486 as
well); with --slice each process then runs its root's 60-frame estimator
drive (chip_smoke.phase_slice) for est_steady_median_ms. The
processes run interleaved, parent, change, change, parent per
two rounds, so that a host that slows down mid-call slows both. Printed:
one JSON line per process, a line per root with its device busy ms per
solve and kernel times, then one JSON line with each root's medians and
the paired ratios; a first line per root gives its kernel build's seconds,
and for the change also the seconds of the same sources built by ONE nvcc
command (what the build did before it compiled the sources in parallel).
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time


def graph_ms(fn, reps=100, replays=5) -> float:
    """Median device time of fn() over replays of a CUDA graph of `reps` calls."""
    import numpy as np
    import torch

    for _ in range(3):
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
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def sequences(args, S, per_seq):
    """The rows of one window's kernel inputs repeated for S sequences laid
    end to end, as the batched solve flattens them; the inputs at the
    positions `per_seq` become one row per sequence, each a little apart
    (tic/qic for K1, G for K2)."""
    import torch

    out = [a.repeat((S,) + (1,) * (a.dim() - 1)) for a in args]
    for i in per_seq:
        step = 0.001 * torch.arange(S, device=args[i].device, dtype=torch.float32)[:, None]
        out[i] = args[i].reshape(1, -1) + step
    return out


def kernel_times(dev) -> dict:
    """Graph-replay device ms of the root's K3, K7 and K4 wrappers on the
    inputs of the root's own chip_smoke.kernel_inputs, of its K5 at NB = 1
    and 16 on chip_smoke.chol_inputs, of its K1 and K2 on the product
    window's rows (N = 3072 observations, n = 17 factors) and on those of 16
    sequences, of its K6 at K = 1, 23, 256 and 4096 keyframes
    (chip_smoke.retrieval_inputs), and of its K5 (NB = 1) and K4 at D = 321,
    366 and 486 (None where the checkout refuses them)."""
    import chip_smoke  # the root's: it is first on sys.path

    from isvins_tpu_torch import ops

    inp = chip_smoke.kernel_inputs(dev)
    out = {name: graph_ms(lambda: getattr(ops, name)(*inp[name]))
           for name in ("schur_corr", "schur_reduce", "linstep")}
    for S in (1, 16):
        a1 = sequences(inp["proj_rows"], S, (6, 7)) if S > 1 else inp["proj_rows"]
        a2 = sequences(inp["imu_rows"], S, (17,)) if S > 1 else inp["imu_rows"]
        out[f"proj_rows_S{S}"] = graph_ms(lambda: ops.proj_rows(*a1))
        out[f"imu_rows_S{S}"] = graph_ms(lambda: ops.imu_rows(*a2))
    for NB in (1, 16):
        H, b = chip_smoke.chol_inputs(dev, NB)
        out[f"chol_solve_batched_NB{NB}"] = graph_ms(lambda: ops.chol_solve_batched(H, b))
    for K in (1, 23, 256, 4096):
        a6 = chip_smoke.retrieval_inputs(dev, K)
        out[f"retrieval_scores_K{K}"] = graph_ms(lambda: ops.retrieval_scores(*a6))
    for D in (321, 366, 486):  # a checkout whose K4 and K5 refuse them records None
        H, b = chip_smoke.chol_inputs(dev, 1, D=D)
        a4 = chip_smoke.small_linstep_inputs(dev, (D - 6) // 15, 1000)
        try:
            out[f"chol_solve_batched_D{D}"] = graph_ms(lambda: ops.chol_solve_batched(H, b))
            out[f"linstep_D{D}"] = graph_ms(lambda: ops.linstep(*a4))
        except ValueError:
            out[f"chol_solve_batched_D{D}"] = out[f"linstep_D{D}"] = None
    return out


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from isvins_tpu_torch.ops import _lib
    from isvins_tpu_torch.parallel.sharded import make_batch_problem
    from isvins_tpu_torch.solver import WindowDims, solve_window

    _lib.lib()
    dev = torch.device("cuda")
    dims = WindowDims(18, 8, 1000, 3072)
    prob = make_batch_problem(1, dims, torch.float32, device=dev)

    def squeeze(t):
        return type(t)(*(squeeze(x) for x in t)) if isinstance(t, tuple) else t[0].contiguous()

    args = [squeeze(x) for x in prob[:4]] + list(prob[4:])
    for _ in range(3):
        solve_window(*args, dims, iters=10)

    def series():
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cost = solve_window(*args, dims, iters=10)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times, cost

    times, cost = series()
    gc.disable()  # a second series without Python's cyclic collector
    times_gc_off, _ = series()
    gc.enable()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve_window(*args, dims, iters=10)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    dev_time = lambda e: getattr(e, "self_device_time_total", 0) or getattr(
        e, "self_cuda_time_total", 0)
    host_ops = {e.key: e.count for e in avgs if e.key.startswith("aten::")}
    device_ops = {e.key: e.count for e in avgs if e.device_type.name == "CUDA" or dev_time(e) > 0}
    return {"root": root, "median_ms": float(np.median(times)), "min_ms": min(times),
            "times_ms": [round(t, 1) for t in times],
            "gc_off_median_ms": float(np.median(times_gc_off)),
            "gc_off_times_ms": [round(t, 1) for t in times_gc_off],
            "cost": float(cost), "build_s": _lib.build_info.get("seconds"),
            "host_ops": sum(host_ops.values()),
            "device_ops": sum(device_ops.values()),
            "device_busy_ms": sum(dev_time(e) for e in avgs) / 1e3,
            "kernel_graph_ms": kernel_times(dev),
            "slice": slice_times(dev) if "--slice" in sys.argv else None,
            "host_op_counts": host_ops, "device_op_counts": device_ops}


def slice_times(dev) -> dict:
    """The root's own chip_smoke.phase_slice (the 60-frame estimator drive
    at the EuRoC window): est_steady_median_ms and, where the root prints
    them, the LM iterations taken and run."""
    import chip_smoke

    _, rec = chip_smoke.phase_slice(dev)
    keep = ("est_steady_median_ms", "est_ate_vio_m", "lm_iterations_taken", "lm_iterations_run")
    return {k: rec[k] for k in keep if k in rec}


def one_command_build(root: str) -> float:
    """Seconds of ONE nvcc command over all of the root's kernel sources."""
    sys.path.insert(0, root)
    import tempfile

    from isvins_tpu_torch.ops import _lib

    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I", str(_lib.CSRC), "-o",
               f"{tmp}/lib.so"] + [str(p) for p in sorted(_lib.CSRC.glob("*.cu"))]
        t0 = time.perf_counter()
        subprocess.run(cmd, check=True, capture_output=True)
        return time.perf_counter() - t0


def main():
    if sys.argv[1] == "--measure":
        print("AB " + json.dumps(measure(sys.argv[2])))
        return
    parent, change = sys.argv[1], sys.argv[2]
    rounds = int(sys.argv[sys.argv.index("--rounds") + 1]) if "--rounds" in sys.argv else 4
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"one_command_build_s_of_change": one_command_build(change)}))
    runs = {parent: [], change: []}
    for r in range(rounds):
        for root in ((parent, change) if r % 2 == 0 else (change, parent)):
            out = subprocess.run([sys.executable, __file__, "--measure", root]
                                 + (["--slice"] if "--slice" in sys.argv else []),
                                 capture_output=True, text=True, check=True).stdout
            rec = json.loads(next(l for l in out.splitlines() if l.startswith("AB "))[3:])
            runs[root].append(rec)
            print(json.dumps({k: v for k, v in rec.items() if not k.endswith("_op_counts")}))
    med = lambda xs: sorted(xs)[len(xs) // 2] if len(xs) % 2 else sum(sorted(xs)[len(xs) // 2 - 1:
                                                                                 len(xs) // 2 + 1]) / 2
    summary = {name: {"medians_ms": [r["median_ms"] for r in runs[root]],
                      "mins_ms": [r["min_ms"] for r in runs[root]],
                      "gc_off_medians_ms": [r["gc_off_median_ms"] for r in runs[root]],
                      "median_of_medians_ms": med([r["median_ms"] for r in runs[root]]),
                      "host_ops": runs[root][0]["host_ops"],
                      "device_ops": runs[root][0]["device_ops"],
                      "device_busy_ms": med([r["device_busy_ms"] for r in runs[root]]),
                      "kernel_graph_ms": {k: [r["kernel_graph_ms"][k] for r in runs[root]]
                                          for k in runs[root][0]["kernel_graph_ms"]},
                      "slice": [r["slice"] for r in runs[root]],
                      "first_build_s": runs[root][0]["build_s"]}
               for name, root in (("parent", parent), ("change", change))}
    for kind in ("host", "device"):
        a, b = (runs[root][0][f"{kind}_op_counts"] for root in (parent, change))
        diff = {k[:120]: b.get(k, 0) - a.get(k, 0) for k in set(a) | set(b)}
        summary[f"{kind}_op_count_diff_top"] = dict(
            sorted(((k, v) for k, v in diff.items() if v), key=lambda kv: -abs(kv[1]))[:10])
    summary["paired_ratio_change_over_parent"] = [
        c["median_ms"] / p["median_ms"] for p, c in zip(runs[parent], runs[change])]
    summary["note"] = (
        "device_ops counts the profiler's device-side records, CUDA runtime calls included. "
        "K3 (schur_corr) is one kernel per LM iteration before and after its redesign; as a "
        "thread block cluster it goes through cudaLaunchKernelEx and two cudaFuncSetAttribute "
        "calls, so against a checkout with the old K3 device_ops moves by +151 per 10-iteration "
        "solve (cudaLaunchKernelExC +131, cudaFuncSetAttribute +30, cudaLaunchKernel -10) and "
        "the kernels on the card by 0. kernel_graph_ms: graph-replay device ms per call.")
    for name in ("parent", "change"):
        print(f"{name}: device busy {summary[name]['device_busy_ms']:.3f} ms per solve (median "
              f"over processes); graph-replay ms {summary[name]['kernel_graph_ms']}")
    print(json.dumps({"card": smi, "summary": summary}))


if __name__ == "__main__":
    main()
