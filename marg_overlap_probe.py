#!/usr/bin/env python3
"""Where the synchronous e2e frame loses time: bench.py's e2e stage on the
card (isvins_tpu_torch.bench.bench_e2e, 130 frames, loops on), driven in
turns as

  - sync: System(solve_async=False), the production run_euroc topology;
  - sync_marg_waited: the same, but the frame thread waits for each
    marginalization job as soon as it is submitted to the marginalization
    worker, so the job never overlaps the frame thread's next tracker
    dispatch (the outputs are the same: the job is installed where it was);
  - async: System(solve_async=True), whose dispatch waits for the previous
    marginalization before it reads the priors;

twice each (sync, sync_marg_waited, async, sync, sync_marg_waited, async),
in one process on one card. Prints one JSON line per drive: the e2e median,
p90 and max (ms), the keyframes and loops, and the utils.perf medians of
the tracker dispatch, the estimator step, the marginalization's two halves
and the wait for it, the worker's keyframe step and the solve.

    python3 marg_overlap_probe.py
"""

from __future__ import annotations

import json

DRIVES = ("sync", "sync_marg_waited", "async") * 2


def main():
    from isvins_tpu_torch import bench
    from isvins_tpu_torch.device import resolve_device
    from isvins_tpu_torch.estimator.estimator import Estimator
    from isvins_tpu_torch.ops import _lib

    dev = resolve_device("cuda")
    _lib.lib()
    world, renderer = bench.e2e_world()
    frames = [renderer.render(k)[0] for k in range(len(world.frame_times))]
    real = Estimator._marginalize

    def waited(self, pf, G, psi, asynchronous=False):
        real(self, pf, G, psi, asynchronous=asynchronous)
        if self._marg_future is not None:
            self._marg_future.result()

    try:
        for label in DRIVES:
            Estimator._marginalize = waited if label == "sync_marg_waited" else real
            out = bench.bench_e2e(dev, solve_async=label == "async", frames=frames, budget_s=300)
            med = {k: v["median_ms"] for k, v in out["phases"].items()}
            print(json.dumps({
                "drive": label, "median_ms": out["e2e_median_ms"], "p90_ms": out["e2e_p90_ms"],
                "max_ms": out["e2e_max_ms"], "keyframes": out["e2e_keyframes"],
                "loops": out["e2e_loops_closed"],
                **{k: med.get(k) for k in ("trk.dispatch", "est.process_image", "est.marg_forward",
                                           "est.marg_backward", "est.marg_collect",
                                           "pg.kf_device_step", "est.solve_device",
                                           "est.solve_dispatch")}}), flush=True)
    finally:
        Estimator._marginalize = real


if __name__ == "__main__":
    main()
