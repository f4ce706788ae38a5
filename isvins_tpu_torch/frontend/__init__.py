"""Frontend (torch port of isvins_tpu/frontend): the batched camodocal
camera-model family (pinhole+radtan, Mei, Kannala-Brandt, Scaramuzza),
image kernels (blur/pyramid/CLAHE/Shi-Tomasi), pyramidal Lucas-Kanade
tracking, and the feature tracker orchestration."""

from .camera import (  # noqa: F401
    EquidistantCamera,
    MeiCamera,
    OcamCamera,
    PinholeRadtan,
    make_camera,
)
from .tracker import FeatureTracker  # noqa: F401
