"""Offline covariance dump and plot (port of isvins_tpu/utils/visualization.py).

The reference renders per-keyframe covariance ellipses live in Pangolin
(pose_graph_builder.cpp:272-301 draws the 2-sigma ellipse of each pose's
positional covariance). The pose graph computes the same per-pose 6x6
blocks (posegraph/optimize.py, ceres::Covariance parity) and they surface
as:

- `covariance_tum(ts, t, cov)`: a text dump, one line per keyframe,
  `t x y z c00 c01 ... c55` (row-major 6x6), written next to the TUM
  outputs by run_euroc.py;
- `plot_covariance_ellipses(...)`: a top-down trajectory plot with 2-sigma
  xy ellipses, saved to a file (needs matplotlib, imported inside).
"""

from __future__ import annotations

import numpy as np


def covariance_tum(ts, t, cov) -> str:
    """One line per keyframe: timestamp, position, row-major 6x6 covariance."""
    lines = []
    for k in range(len(ts)):
        c = " ".join(f"{v:.9g}" for v in np.asarray(cov[k]).reshape(-1))
        lines.append(f"{ts[k]:.9f} {t[k][0]} {t[k][1]} {t[k][2]} {c}")
    return "\n".join(lines)


def plot_covariance_ellipses(ts, t, cov, path: str, n_sigma: float = 2.0,
                             stride: int = 1, gt: np.ndarray = None):
    """Top-down (x, y) trajectory with per-keyframe n-sigma position
    ellipses (the Pangolin drawing of pose_graph_builder.cpp:272-301, saved
    as an image). `cov` is (K, 6, 6) with the translation block at [:3, :3]."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Ellipse

    t = np.asarray(t)
    fig, ax = plt.subplots(figsize=(8, 8))
    if gt is not None:
        ax.plot(gt[:, 0], gt[:, 1], "-", color="0.75", lw=1.0, label="ground truth")
    ax.plot(t[:, 0], t[:, 1], "-", color="#1f77b4", lw=1.2, label="optimized")
    for k in range(0, len(t), stride):
        C = np.asarray(cov[k])[:2, :2]
        C = 0.5 * (C + C.T)
        w, V = np.linalg.eigh(C)
        w = np.clip(w, 0.0, None)
        ang = np.degrees(np.arctan2(V[1, -1], V[0, -1]))
        ax.add_patch(Ellipse((t[k, 0], t[k, 1]), width=2 * n_sigma * np.sqrt(w[-1]),
                             height=2 * n_sigma * np.sqrt(w[0]), angle=ang, fill=False,
                             color="#d62728", lw=0.6, alpha=0.7))
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend(loc="best")
    ax.set_title(f"keyframe trajectory with {n_sigma:.0f}-sigma covariance ellipses")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path
