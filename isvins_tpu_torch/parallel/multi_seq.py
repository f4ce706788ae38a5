"""Sequence-data-parallel estimator stepping (port of
isvins_tpu/parallel/multi_seq.py): N independent VIO sequences, one
sliding-window solve each, ONE batched device program per round.

The per-sequence host state machines stay independent Python objects while
their steady-state window solves run as a single batched program
(estimator.steady_solve with a leading sequence axis: DLT seeding,
preintegration, solve_window_batched through K1, K2 and K5). Each estimator
leaves the host argument tree of its solve in its pending record; the
coordinator stacks the trees along a new axis 0, uploads once, solves once,
downloads once and hands every estimator its row.

Usage:
    ests = [Estimator(cfg, dims, solve_async=True) for _ in range(N)]
    for e in ests: e._defer_dispatch = True
    coord = MultiSequenceSolver()
    # per frame: feed imu/features to each estimator (process_image defers
    # its dispatch), then
    coord.step(ests)   # one batched solve for all N, results installed

Two differences from the reference, both deliberate: solves batch by
structure (same window shapes, iteration count, extrinsic mode, noise; a mix
raises), and step() collects EVERY estimator that has a pending solve, also
one that dispatched its own, where the reference left such an estimator
uncollected whenever another one had deferred."""

from __future__ import annotations

import numpy as np

from ..utils import perf
from ..utils.convert import tree_map
from .sharded import make_mesh


class MultiSequenceSolver:
    def __init__(self, devices=None):
        """`devices` as make_mesh takes them: None is the one CUDA card. With
        several devices the batch is cut into contiguous chunks, one batched
        solve per device."""
        self.devices = make_mesh(devices)

    def step(self, estimators) -> int:
        """Batch all deferred dispatches into one solve (one per device) and
        install every result (collect_solve per estimator). Estimators
        without a pending solve (still initializing, say) are skipped: they
        run their own path. Returns the number of sequences solved in the
        batch."""
        pend = [(e, e._solve_pending) for e in estimators
                if e._solve_pending is not None and e._solve_pending["handle"] is None]
        if pend:
            key = pend[0][1]["key"]
            if any(p["key"] != key for _, p in pend):
                raise ValueError("mixed solve programs in one batch: the estimators differ in "
                                 "window shapes, iterations, extrinsic mode or noise")
            n, nd = len(pend), min(len(self.devices), len(pend))
            cuts = [round(k * n / nd) for k in range(nd + 1)]
            with perf.phase("mseq.batched_solve"):
                for k in range(nd):
                    chunk = pend[cuts[k]: cuts[k + 1]]
                    stacked = tree_map(lambda *leaves: np.stack(leaves),
                                       *(p["args"] for _, p in chunk))
                    batch = chunk[0][0]._dispatch_steady(stacked, self.devices[k])
                    for row, (_, p) in enumerate(chunk):
                        p["handle"] = batch.row(row)
        for e in estimators:
            e.collect_solve()
        return len(pend)
