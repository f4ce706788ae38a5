"""Frontend (torch port of isvins_tpu/frontend): the batched camodocal
camera-model family (pinhole+radtan, Mei, Kannala-Brandt, Scaramuzza) and
the image kernels the pose graph's keyframe step needs. The tracker
(FeatureTracker, LK, the rest of image_ops) is not ported yet."""

from .camera import (  # noqa: F401
    EquidistantCamera,
    MeiCamera,
    OcamCamera,
    PinholeRadtan,
    make_camera,
)
