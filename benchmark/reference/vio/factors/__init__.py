"""Factor library on torch tensors (port of isvins_tpu/factors): residual +
analytic minimal-coordinate Jacobians, batched over leading dims."""

from .preintegration import (  # noqa: F401
    ImuNoise,
    Preintegration,
    integrate_segment,
    imu_residual,
    imu_residual_jacobians,
    sqrt_info_from_cov,
)
from .projection import projection_residual, projection_residual_jacobians  # noqa: F401
from .priors import (  # noqa: F401
    linear9_residual_jacobians,
    relpose_residual,
    relpose_residual_jacobians,
    rollpitch_residual,
    rollpitch_residual_jacobians,
    se3_prior_residual,
    se3_prior_residual_jacobians,
    yaw_residual_jacobians,
)
