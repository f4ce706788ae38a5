"""Visual-inertial alignment and PnP (port of isvins_tpu/initial; the
five-point and extrinsic-rotation modules are not ported yet)."""

from .alignment import linear_alignment, solve_gyroscope_bias  # noqa: F401
