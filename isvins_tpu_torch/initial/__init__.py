"""Visual-inertial alignment, PnP, two-view relative pose and the hand-eye
extrinsic rotation calibration (port of isvins_tpu/initial)."""

from .alignment import linear_alignment, solve_gyroscope_bias  # noqa: F401
from .five_point import solve_relative_pose  # noqa: F401
