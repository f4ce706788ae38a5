"""Sliding-window solver on torch tensors (port of isvins_tpu/solver)."""

from .window import (  # noqa: F401
    ImuFactors,
    PriorState,
    ProjFactors,
    RollPitchFactors,
    WindowDims,
    WindowState,
    build_normal_equations,
    retract_state,
    solve_window,
    solve_window_batched,
    window_cost,
)
