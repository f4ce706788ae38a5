"""Faults planted under the timed path, for the upper readings of the
limits of `correct` (PERF.md section 2): each is a callable given the
System after set-up and before the window (harness.run_cell's `fault`),
and breaks that System's own objects only, so that runs of several seeds
in one process do not add up.

    python3 -m benchmark.control --workload <cell> --seeds a,b,c --seconds 30 --fault <name>

- `lift_k1_off`: the tracker's float32 camera model (`cam32`, what its
  device step lifts every tracked point and new corner through) with k1
  1 % off;
- `lift_fx_off`: the same with fx 0.1 % off (a camera without radial
  distortion, where k1 is 0);
- `extrinsic_never_installed`: the estimator installs a solve's answer but
  keeps its old tic and qic.

A CUDA graph of the tracker's steady step holds the model's constants as
they were at its capture: the fault drops the graph, so that the next
steady step runs eagerly and the one after captures the broken model."""

from __future__ import annotations


def _lift_off(field: str, factor: float):
    def plant(system):
        trk = system.tracker
        trk.cam32 = trk.cam32._replace(**{field: getattr(trk.cam32, field) * factor})
        trk._graph = None
        trk._warm_key = None
    return plant


def extrinsic_never_installed(system):
    est = system.estimator
    install = est._install_solution

    def keep_old_extrinsic(*args, **kw):
        tic, qic = est.tic, est.qic
        out = install(*args, **kw)
        est.tic, est.qic = tic, qic
        return out

    est._install_solution = keep_old_extrinsic


FAULTS = {"lift_k1_off": _lift_off("k1", 1.01), "lift_fx_off": _lift_off("fx", 1.001),
          "extrinsic_never_installed": extrinsic_never_installed}
