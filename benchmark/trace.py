"""The traced slice of a `--trace 1` run: torch.profiler (CPU and CUDA
activity) over a few consecutive frames in mid-window, read from the raw
kineto events.

A torch.profiler session on the H100 has been seen to record no launch of
a ctypes kernel that ran (PERF.md records it). So `sessions` slices are traced
one after another, and the first whose device kernels of K1-K4 equal the
launches the port's own counters (ops.launch_counts) say were made over it
is kept; if none does, the last is kept with `consistent` False."""

from __future__ import annotations

import time

import numpy as np

# the CUDA kernels each counted wrapper of the steady solve launches once a call
COUNTED = {"proj_rows": "proj_rows_kernel", "imu_rows": "imu_rows_kernel",
           "schur_corr": "schur_corr_kernel", "linstep": "linstep_chol_kernel"}
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")


def warm_up(device):
    """One empty profiler session: the first session of a process starts
    the profiler's tracing library, which takes seconds; a run pays that in
    its set-up, not in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize(device)


class Slice:
    """`sessions` consecutive profiler sessions of `frames` frames each,
    from window frame `start` on. Each session's trace is read after the
    window (reading it takes seconds, which would otherwise fall inside
    the window); the first whose K1-K4 kernels match the launch counters is
    kept. `excluded` lists, per utils.perf phase, the sample index ranges
    recorded while a session ran, which the per-layer readers leave out
    (the profiler slows every host operation it records)."""

    def __init__(self, device, start: int, frames: int, sessions: int):
        self.device, self.start, self.frames, self.sessions = device, start, frames, sessions
        self.prof = None
        self.done = []  # (profile, wall_s, launch counts over it, frames)
        self.summary = None
        self.excluded = {}
        self._first = None

    def before(self, w_i: int, system):
        if self.prof is not None or len(self.done) >= self.sessions:
            return
        if w_i != self.start + len(self.done) * self.frames:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        from isvins_tpu_torch import ops

        torch.cuda.synchronize(self.device)
        self._marks0 = _sample_marks()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._counts0 = ops.launch_counts()
        self._first, self._n = w_i, 0
        self._t0 = time.perf_counter()

    def after(self, w_i: int, system):
        if self.prof is not None:
            self._n += 1
            if self._n == self.frames:
                self._stop()

    def close(self, system):
        """After the window: stop a session the window ended in (its frames
        so far), then read every session and keep the first consistent one."""
        if self.prof is not None:
            self._stop()
        for i, (prof, wall, counts, n) in enumerate(self.done):
            s = summarize(prof, wall)
            s["frames"] = n
            s["launch_counts"] = counts
            s["consistent"] = all(
                sum(c for name, (c, _) in s["kernels"].items() if k_name in name) == counts[w]
                for w, k_name in COUNTED.items())
            s["session"] = i + 1
            self.summary = s
            if s["consistent"]:
                break

    def _stop(self):
        import torch

        from isvins_tpu_torch import ops

        torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - self._t0
        prof, self.prof = self.prof, None
        counts = {k: v - self._counts0[k] for k, v in ops.launch_counts().items()}
        prof.__exit__(None, None, None)
        marks1 = _sample_marks()
        for name, end in marks1.items():
            self.excluded.setdefault(name, []).append((self._marks0.get(name, 0), end))
        self.done.append((prof, wall, counts, self._n))


def _sample_marks() -> dict:
    """How many samples each utils.perf phase holds now."""
    from isvins_tpu_torch.utils import perf

    reg, lock = getattr(perf, "_SAMPLES", None), getattr(perf, "_LOCK", None)
    if reg is None or lock is None:
        return {}
    with lock:
        return {k: len(v) for k, v in reg.items()}


def summarize(prof, wall_s: float) -> dict:
    """summarize_events over one profiler session's raw kineto events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        (dev if e.device_type() == cuda else host).append((e.start_ns(), e.end_ns(), e.name()))
    return summarize_events(dev, host, wall_s)


def summarize_events(dev, host, wall_s: float) -> dict:
    """From (start_ns, end_ns, name) device and host events: the host's
    kernel-launch calls, the device's busy time (the union of its kernel and
    copy intervals), each device operation's count and time, the ten
    costliest device operations and the ten longest idle gaps between device
    operations, each named by the innermost host operation under its middle."""
    n_launch = sum(1 for _, _, name in host if name.startswith(LAUNCH_CALLS))
    dev = sorted(dev)
    busy_ns, end, gaps = 0, None, []
    for a, b, _ in dev:
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        busy_ns += max(0, b - (a if end is None else max(a, end)))
        end = b if end is None else max(end, b)
    kernels = {}
    for a, b, name in dev:
        c, t = kernels.get(name, (0, 0.0))
        kernels[name] = (c + 1, t + (b - a) / 1e9)
    ops_top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    gaps.sort(reverse=True)
    if host:
        hs = np.array([h[0] for h in host], np.int64)
        he = np.array([h[1] for h in host], np.int64)
    idle = []
    for g, a, b in gaps[:10]:
        label = "no host operation"
        if host:
            mid = (a + b) // 2
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            if cover.size:
                label = host[int(cover[np.argmax(hs[cover])])][2]
        idle.append([label, g / 1e9])
    return {"launches": n_launch, "busy_s": busy_ns / 1e9, "window_s": wall_s,
            "kernels": kernels,
            "device_ops": [[name, t] for name, (_, t) in ops_top],
            "idle_gaps": idle}
