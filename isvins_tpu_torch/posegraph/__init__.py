"""Pose graph + loop closure (torch port of isvins_tpu/posegraph): BRIEF
descriptors and batched Hamming matching, the keyframe database with
retrieval (kernel K6 before the vocabulary freezes), the dense pose-graph
Gauss-Newton with per-pose covariance, and the builder orchestration."""

from .brief import (  # noqa: F401
    brief_descriptors,
    hamming_matrix,
    make_brief_pattern,
    match_descriptors,
)
from .keyframe_db import KeyframeDB  # noqa: F401
from .optimize import optimize_pose_graph  # noqa: F401
from .builder import PoseGraphBuilder  # noqa: F401
