"""Lightweight per-phase wall-clock accounting for the frame path.

A single registry accumulates the samples of each named phase so a caller
can publish an attributed per-frame budget breakdown. Copied from the JAX
package's utils/perf.py with one repair: the registry is guarded by a lock,
because phases are recorded from the marginalization worker thread as well
as from the frame thread (appending to a shared defaultdict from several
threads is a check-then-act race).

Zero-cost when disabled (one attribute check per phase); phases nest
freely — each phase records its own inclusive wall time.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

_ENABLED = False
_LOCK = threading.Lock()
_SAMPLES = defaultdict(list)  # name -> [dt_s, ...] (frame-path counts; tiny)


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


def reset():
    with _LOCK:
        _SAMPLES.clear()


@contextlib.contextmanager
def phase(name: str):
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add(name, time.perf_counter() - t0)


def add(name: str, dt: float):
    """Record an externally-timed interval."""
    if _ENABLED:
        with _LOCK:
            _SAMPLES[name].append(dt)


def stats() -> dict:
    """{name: {count, total_ms, mean_ms, median_ms, max_ms}} snapshot.
    The median is the steady-state cost (immune to the one-off build and
    warm-up spikes that dominate mean/max on a fresh process)."""
    import numpy as np

    with _LOCK:
        items = [(k, list(v)) for k, v in _SAMPLES.items()]
    out = {}
    for name, xs in items:
        a = np.asarray(xs)
        out[name] = {
            "count": int(a.size),
            "total_ms": round(float(a.sum()) * 1e3, 2),
            "mean_ms": round(float(a.mean()) * 1e3, 3),
            "median_ms": round(float(np.median(a)) * 1e3, 3),
            "max_ms": round(float(a.max()) * 1e3, 2),
        }
    return out


def report(n_frames: int = 0) -> str:
    """Human-readable table, sorted by total time; with n_frames the
    per-frame amortized cost is shown."""
    rows = sorted(stats().items(), key=lambda kv: -kv[1]["total_ms"])
    lines = []
    for name, s in rows:
        per_frame = (
            f" {s['total_ms'] / max(n_frames, 1):8.2f} ms/frame"
            if n_frames
            else ""
        )
        lines.append(
            f"{name:<28} n={s['count']:<5} total={s['total_ms']:9.1f} ms "
            f"med={s['median_ms']:8.3f} ms mean={s['mean_ms']:8.3f} ms "
            f"max={s['max_ms']:8.1f} ms{per_frame}"
        )
    return "\n".join(lines)
