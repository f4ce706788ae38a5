"""Visual-inertial initialization entry (port of
isvins_tpu/estimator/initialization.py).

`initial_structure(est)` is called by the Estimator when the window first
fills. In this port only the `_gt_init` hook is available: a test or a
calling script installs `est._gt_init` (a callable taking the estimator)
that sets the window states. The SfM chain (five-point, global SfM, PnP,
the rest of vi_init, ex_rotation) is item 3, "SfM initialization", of the
ROADMAP's port queue; until it is ported, an estimator without the hook
stops here loudly.
"""

from __future__ import annotations


def initial_structure(est) -> bool:
    """Returns True when the window states are initialized."""
    hook = getattr(est, "_gt_init", None)
    if hook is None:
        raise NotImplementedError(
            "isvins_tpu_torch has no SfM initialization yet (ROADMAP, queue A, "
            "'SfM initialization'); install est._gt_init to initialize the window")
    hook(est)
    return True
