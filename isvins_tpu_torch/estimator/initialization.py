"""Visual-inertial initialization entry (torch port of
isvins_tpu/estimator/initialization.py; reference src/initial/*,
estimator.cpp:239-429): IMU-excitation check, relative pose, global SfM,
PnP chaining, gyro-bias estimation, linear velocity/gravity/scale alignment
and gravity refinement (estimator/vi_init.py).

`initial_structure(est)` is the entry called by the Estimator when the
window first fills. Tests and benches may install `est._gt_init` (a
callable taking the estimator) to set the window states instead.
"""

from __future__ import annotations


def initial_structure(est) -> bool:
    """estimator.cpp:239-355. Returns True when the window states (Ps, Qs,
    Vs, Bgs, scaled landmarks, gravity-aligned frame) are initialized."""
    hook = getattr(est, "_gt_init", None)
    if hook is not None:
        hook(est)
        return True

    from .vi_init import run_visual_inertial_init

    return run_visual_inertial_init(est)
