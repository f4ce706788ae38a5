"""Device time on the card by CUDA-graph replay."""

from __future__ import annotations

import numpy as np
import torch


def graph_ms(fn, reps=100, replays=5):
    """Device time of fn(): `reps` calls captured into one CUDA graph,
    replayed between two events; the median replay over `reps`. The host
    enqueues nothing during a replay, so this is the device's time per call,
    launch gaps inside the graph included. Raises if fn() cannot be captured
    (a host read of device memory, a synchronize)."""
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
