"""EuRoC MAV dataset loader (port of isvins_tpu/data/euroc.py).

Parses `mav0/imu0/data.csv` (ns timestamp, gyro xyz, accel xyz) and
`mav0/cam0/data.csv` (ns timestamp, image filename), mirroring the
reference driver's readers (test/run_euroc.cpp:26-88) but streaming
measurements in timestamp order without throttling. Images load lazily as
float32 grayscale through the package's own PNG codec (data/png.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

from .png import read_png


@dataclass
class ImuSample:
    t: float
    gyr: np.ndarray
    acc: np.ndarray


@dataclass
class ImageSample:
    t: float
    path: str

    def load(self) -> np.ndarray:
        return read_png(self.path).astype(np.float32)


class EurocDataset:
    def __init__(self, mav0_path: str):
        self.root = mav0_path
        imu_csv = os.path.join(mav0_path, "imu0", "data.csv")
        cam_csv = os.path.join(mav0_path, "cam0", "data.csv")
        self.csv_parser = "numpy"  # which parser read the IMU CSV: "native" or "numpy"
        self.imu = self._parse_imu(imu_csv)
        self.images = self._parse_cam(cam_csv, os.path.join(mav0_path, "cam0", "data"))
        gt_csv = os.path.join(mav0_path, "state_groundtruth_estimate0", "data.csv")
        self.ground_truth = self._parse_gt(gt_csv) if os.path.exists(gt_csv) else None

    def _parse_imu(self, path):
        from .. import native

        if native.available():
            parsed = native.parse_csv_ns(path, 6)
            if parsed is not None:
                self.csv_parser = "native"
                ts, data = parsed
                return [ImuSample(t=ts[i], gyr=data[i, :3].copy(), acc=data[i, 3:6].copy())
                        for i in range(len(ts))]
        rows = np.genfromtxt(path, delimiter=",", skip_header=1)
        return [ImuSample(t=r[0] / 1e9, gyr=r[1:4].copy(), acc=r[4:7].copy()) for r in rows]

    @staticmethod
    def _parse_cam(path, img_dir):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, name = line.split(",")[:2]
                out.append(ImageSample(t=float(ts) / 1e9, path=os.path.join(img_dir, name.strip())))
        return out

    @staticmethod
    def _parse_gt(path):
        rows = np.genfromtxt(path, delimiter=",", skip_header=1)
        return {
            "t": rows[:, 0] / 1e9,
            "p": rows[:, 1:4],
            "q": rows[:, 4:8],  # wxyz in EuRoC
            "v": rows[:, 8:11],
        }

    def stream(self) -> Iterator[Tuple[str, object]]:
        """Yield ('imu', ImuSample) / ('image', ImageSample) in time order."""
        i = j = 0
        while i < len(self.imu) or j < len(self.images):
            if j >= len(self.images) or (i < len(self.imu) and self.imu[i].t <= self.images[j].t):
                yield "imu", self.imu[i]
                i += 1
            else:
                yield "image", self.images[j]
                j += 1
