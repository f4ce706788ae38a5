"""Lie-group / quaternion geometry core on torch tensors (port of isvins_tpu/geom)."""

from .so3 import (  # noqa: F401
    skew,
    unskew,
    quat_identity,
    quat_mul,
    quat_conj,
    quat_normalize,
    quat_rotate,
    quat_to_mat,
    mat_to_quat,
    so3_exp_quat,
    so3_exp_mat,
    quat_log,
    so3_log_mat,
    right_jacobian_so3,
    right_jacobian_inv_so3,
    left_jacobian_so3,
    left_jacobian_inv_so3,
    ypr_to_mat,
    mat_to_ypr,
    g2R,
)
from .se3 import (  # noqa: F401
    se3_compose,
    se3_inverse,
    se3_apply,
    se3_relative,
    se3_adjoint,
    se3_exp,
    se3_log,
)
