"""Arithmetic the readers share: medians of utils.perf phases and each
kernel's work and bound (the union of device intervals is
benchmark/trace.summarize_events').

kernel_work and the peaks are copied from chip_smoke.py (kernel_work,
PEAK_*), where the kernel table of PERF.md section 6 was measured: every
input read once and every output written once, and the operations the
algorithm needs at the given shapes. K1's per-row operation count (~600)
is an estimate read off its source; bytes bound K1 anyway.

A kernel that kernel_work does not know keeps its work in its reader's
own file, as a function of window_shapes' shapes returning (bytes,
operations), and hands that function to roofline_pct in place of a name."""

from __future__ import annotations

import numpy as np

# published peaks of one H100 SXM (NVIDIA's data sheet): f32 outside the
# tensor cores and HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def phase_median_ms(ctx, name: str):
    """Median (ms) of every sample of a utils.perf phase in the window but
    those recorded while the profiler ran (ctx["excluded"]: index ranges),
    or None where the phase recorded nothing."""
    xs = ctx.get("samples", {}).get(name)
    if xs:
        drop = np.zeros(len(xs), bool)
        for a, b in ctx.get("excluded", {}).get(name, ()):
            drop[a:b] = True
        kept = np.asarray(xs, np.float64)[~drop]
        return float(np.median(kept) * 1e3) if kept.size else None
    st = ctx.get("phases", {}).get(name)
    if st and st.get("count"):
        return float(st["median_ms"])
    return None


def kernel_work(name: str, shapes: dict):
    """(bytes, operations) of one call at the given shapes: K1 `proj_rows`
    over N rows; K4 `linstep` on H (D x D) with the landmark coupling W
    (F x Dr) (its Schur product, Cholesky and triangular solves)."""
    if name == "proj_rows":
        N = shapes["N"]
        return N * ((21 + 28) * 4 + 1) + 7 * 4, 600 * N
    if name == "linstep":
        D, F, Dr = shapes["D"], shapes["F"], shapes["Dr"]
        return ((D * D + D + F * Dr + 2 * F + 1 + D + F) * 4,
                2 * F * Dr * (Dr + 1) + D ** 3 // 3 + 2 * D * D + 2 * F * Dr)
    raise KeyError(name)


def kernel_bound_s(work, shapes: dict) -> float:
    """The least time (s) the card could take for one call: the larger of
    bytes over peak bandwidth and operations over peak f32 rate. `work` is
    a name kernel_work knows, or a function shapes -> (bytes, operations)."""
    nbytes, nops = work(shapes) if callable(work) else kernel_work(work, shapes)
    return max(nbytes / PEAK_BYTES, nops / PEAK_FLOPS)


def window_shapes(dims: dict) -> dict:
    """The steady solve's static shapes for a window B/Vo/F/N: D = 15 B + 6
    state dimensions, Dr = 6 B + 6 coupling columns (solver/window.py)."""
    B = int(dims["B"])
    return {"N": int(dims["N"]), "F": int(dims["F"]), "D": 15 * B + 6, "Dr": 6 * B + 6}


def roofline_pct(ctx, work, kernels: tuple, per_call: str):
    """100 x bound / (device time per call): the device time of every
    kernel whose name contains one of `kernels`, over the number of calls,
    counted as the kernels named `per_call`; None without a trace or a
    call. `work` is as kernel_bound_s takes it."""
    tr = ctx.get("trace")
    if not tr:
        return None
    k = tr["kernels"]
    calls = sum(c for name, (c, _) in k.items() if per_call in name)
    t = sum(s for name, (_, s) in k.items() if any(x in name for x in kernels))
    if calls == 0 or t <= 0:
        return None
    return 100.0 * kernel_bound_s(work, window_shapes(ctx["dims"])) / (t / calls)
