"""Write a real-format EuRoC `mav0/` tree from a synthetic world (port of
isvins_tpu/utils/euroc_fixture.py).

A rehearsal fixture for the EuRoC driver path when no real sequence is at
hand: nanosecond-stamped CSVs with the real headers (the same bytes as the
JAX package's writer), 8-bit grayscale PNG frames named by timestamp
(written by data/png.py), and `state_groundtruth_estimate0` with the
17-column layout, so that `run_euroc.main` replays it through the same
loader, native parser, PNG decode and ground-truth alignment a real
`mav0/` takes (run_euroc.cpp:26-88 semantics).
"""

from __future__ import annotations

import os

import numpy as np

from ..data.png import write_png

_IMU_HEADER = ("#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
               "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
               "a_RS_S_z [m s^-2]\n")
_CAM_HEADER = "#timestamp [ns],filename\n"
_GT_HEADER = ("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
              "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z [], "
              "v_RS_R_x [m s^-1], v_RS_R_y [m s^-1], v_RS_R_z [m s^-1], "
              "b_w_RS_S_x [rad s^-1], b_w_RS_S_y [rad s^-1], "
              "b_w_RS_S_z [rad s^-1], b_a_RS_S_x [m s^-2], "
              "b_a_RS_S_y [m s^-2], b_a_RS_S_z [m s^-2]\n")

# real EuRoC sequences start at epoch-scale nanosecond stamps; using one
# exercises the ns -> s conversion precision the loader must preserve
_T0_NS = 1403636579763555584


def write_euroc_fixture(root: str, world, frames) -> str:
    """Write `<root>/mav0` from a `make_world` world and rendered `frames`
    (uint8 or float grayscale, one per world frame; floats are clipped to
    [0, 255] and truncated to uint8). Returns the mav0 path."""
    mav0 = os.path.join(root, "mav0")
    imu_dir = os.path.join(mav0, "imu0")
    cam_dir = os.path.join(mav0, "cam0")
    img_dir = os.path.join(cam_dir, "data")
    gt_dir = os.path.join(mav0, "state_groundtruth_estimate0")
    for d in (imu_dir, img_dir, gt_dir):
        os.makedirs(d, exist_ok=True)

    ns = lambda t: _T0_NS + int(round(float(t) * 1e9))

    # imu0/data.csv: gyro first, then accel (EuRoC's column order)
    with open(os.path.join(imu_dir, "data.csv"), "w") as f:
        f.write(_IMU_HEADER)
        for k in range(len(world.frame_times) - 1):
            t = world.frame_times[k]
            m = int(np.sum(world.imu_dts[k] > 0))
            for s in range(m):
                t = t + world.imu_dts[k][s]
                g = world.imu_gyrs[k][s]
                a = world.imu_accs[k][s]
                f.write(f"{ns(t)},{g[0]:.9f},{g[1]:.9f},{g[2]:.9f},"
                        f"{a[0]:.9f},{a[1]:.9f},{a[2]:.9f}\n")

    # cam0/data.csv + PNG frames named by timestamp
    with open(os.path.join(cam_dir, "data.csv"), "w") as f:
        f.write(_CAM_HEADER)
        for k, img in enumerate(frames):
            tns = ns(world.frame_times[k])
            name = f"{tns}.png"
            f.write(f"{tns},{name}\n")
            arr = np.asarray(img)
            if arr.dtype != np.uint8:
                arr = np.clip(arr, 0, 255).astype(np.uint8)
            write_png(os.path.join(img_dir, name), arr)

    # ground truth (17-column EuRoC layout; biases zeroed)
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write(_GT_HEADER)
        for k in range(len(world.frame_times)):
            tns = ns(world.frame_times[k])
            p = world.P[k]
            q = world.Q[k]  # wxyz
            v = world.V[k]
            f.write(f"{tns},{p[0]:.9f},{p[1]:.9f},{p[2]:.9f},"
                    f"{q[0]:.9f},{q[1]:.9f},{q[2]:.9f},{q[3]:.9f},"
                    f"{v[0]:.9f},{v[1]:.9f},{v[2]:.9f},0,0,0,0,0,0\n")
    return mav0
