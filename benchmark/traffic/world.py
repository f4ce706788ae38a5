"""The benchmark's world generator: a frozen copy of make_world and its
quaternion helpers (isvins_tpu_torch/utils/synthetic.py, itself a copy of
isvins_tpu/utils/synthetic.py), NumPy on the host.

A circle of radius traj_r at angular rate traj_w with a vertical
oscillation and a small pitch/roll wobble; the IMU samples at imu_hz are
the analytic specific force and angular rate plus the biases and white
noise drawn from `seed`."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Batched numpy quaternion helpers (wxyz, leading batch dims).
def _q_mul(q, p):
    w0, x0, y0, z0 = np.moveaxis(np.asarray(q), -1, 0)
    w1, x1, y1, z1 = np.moveaxis(np.asarray(p), -1, 0)
    return np.stack([
        w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
        w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
        w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
        w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1,
    ], axis=-1)


def _q_conj(q):
    return np.asarray(q) * np.array([1.0, -1.0, -1.0, -1.0])


def _q_to_mat(q):
    w, x, y, z = np.moveaxis(np.asarray(q), -1, 0)
    row = lambda a, b, c: np.stack([a, b, c], axis=-1)
    return np.stack([
        row(1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        row(2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        row(2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    ], axis=-2)


def _q_rotate(q, v):
    return np.einsum("...ij,...j->...i", _q_to_mat(q), np.asarray(v))


@dataclass
class SynthWorld:
    frame_times: np.ndarray  # (B,)
    P: np.ndarray  # (B,3) GT positions (body/IMU in world)
    Q: np.ndarray  # (B,4) GT quaternions wxyz
    V: np.ndarray  # (B,3)
    landmarks: np.ndarray  # (M,3)
    # per-frame-segment IMU buffers, zero-padded to capacity
    imu_dts: np.ndarray  # (B-1, C)
    imu_accs: np.ndarray  # (B-1, C, 3)
    imu_gyrs: np.ndarray  # (B-1, C, 3)
    imu_acc0: np.ndarray  # (B-1, 3) sample at segment start
    imu_gyr0: np.ndarray  # (B-1, 3)
    gravity: np.ndarray  # (3,)
    ba: np.ndarray  # (3,) true accel bias
    bg: np.ndarray  # (3,)


def _traj(t, r=5.0, w=0.4, h=0.6, w2=0.9):
    """Circle with vertical oscillation."""
    p = np.stack([r * np.cos(w * t), r * np.sin(w * t), h * np.sin(w2 * t)], axis=-1)
    return p


def _traj_quat(t, w=0.4, wobble=(0.12, 0.1)):
    """Body x points radially outward (at the landmark ring); small pitch/roll
    wobble for IMU excitation. Larger `wobble` amplitudes give the 3-axis
    rotational excitation hand-eye extrinsic calibration needs."""
    yaw = w * t
    pitch = wobble[0] * np.sin(0.7 * t)
    roll = wobble[1] * np.cos(1.1 * t)
    # R = Rz(yaw) Ry(pitch) Rx(roll)
    qz = np.stack([np.cos(yaw / 2), 0 * t, 0 * t, np.sin(yaw / 2)], axis=-1)
    qy = np.stack([np.cos(pitch / 2), 0 * t, np.sin(pitch / 2), 0 * t], axis=-1)
    qx = np.stack([np.cos(roll / 2), np.sin(roll / 2), 0 * t, 0 * t], axis=-1)
    return _q_mul(qz, _q_mul(qy, qx))


def make_world(
    n_frames: int = 18,
    frame_hz: float = 10.0,
    imu_hz: float = 200.0,
    imu_capacity: int = 64,
    n_landmarks: int = 300,
    g_norm: float = 9.81007,
    ba=(0.0, 0.0, 0.0),
    bg=(0.0, 0.0, 0.0),
    noise_acc: float = 0.0,
    noise_gyr: float = 0.0,
    t0: float = 0.0,
    seed: int = 0,
    traj_r: float = 5.0,
    traj_w: float = 0.4,
    wobble=(0.12, 0.1),
    lm_rad=(6.5, 12.0),
    lm_z=(-2.0, 3.0),
) -> SynthWorld:
    rng = np.random.default_rng(seed)
    G = np.array([0.0, 0.0, g_norm])
    fdt = 1.0 / frame_hz
    idt = 1.0 / imu_hz
    frame_times = t0 + np.arange(n_frames) * fdt
    eps = 1e-6

    def pos(t):
        return _traj(np.atleast_1d(t), r=traj_r, w=traj_w)

    def quat(t):
        return _traj_quat(np.atleast_1d(t), w=traj_w, wobble=wobble)

    def vel(t):
        return (pos(t + eps) - pos(t - eps)) / (2 * eps)

    def acc_w(t):
        return (pos(t + eps) - 2 * pos(t) + pos(t - eps)) / (eps * eps)

    def omega_body(t):
        q0 = quat(t - eps)
        q1 = quat(t + eps)
        dq = _q_mul(_q_conj(q0), q1)
        # log(dq)/2eps
        v = dq[..., 1:]
        w = np.clip(dq[..., :1], -1, 1)
        ang = 2 * np.arctan2(np.linalg.norm(v, axis=-1, keepdims=True), w)
        axis = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
        return axis * ang / (2 * eps)

    P = pos(frame_times)
    Q = quat(frame_times)
    V = vel(frame_times)

    ba = np.asarray(ba)
    bg = np.asarray(bg)

    C = imu_capacity
    B = n_frames
    imu_dts = np.zeros((B - 1, C))
    imu_accs = np.zeros((B - 1, C, 3))
    imu_gyrs = np.zeros((B - 1, C, 3))
    imu_acc0 = np.zeros((B - 1, 3))
    imu_gyr0 = np.zeros((B - 1, 3))

    def imu_at(t):
        R = _q_to_mat(quat(t))[0]
        a = R.T @ (acc_w(t)[0] + G) + ba + rng.normal(size=3) * noise_acc
        g = omega_body(t)[0] + bg + rng.normal(size=3) * noise_gyr
        return a, g

    for k in range(B - 1):
        ts = np.arange(frame_times[k], frame_times[k + 1] + idt * 0.5, idt)
        ts[-1] = frame_times[k + 1]
        a0, g0 = imu_at(ts[0])
        imu_acc0[k] = a0
        imu_gyr0[k] = g0
        n = len(ts) - 1
        assert n <= C
        for i in range(n):
            imu_dts[k, i] = ts[i + 1] - ts[i]
            a, g = imu_at(ts[i + 1])
            imu_accs[k, i] = a
            imu_gyrs[k, i] = g

    # landmarks: ring around the trajectory at varied radius/height
    th = rng.uniform(0, 2 * np.pi, n_landmarks)
    rad = rng.uniform(lm_rad[0], lm_rad[1], n_landmarks)
    z = rng.uniform(lm_z[0], lm_z[1], n_landmarks)
    landmarks = np.stack([rad * np.cos(th), rad * np.sin(th), z], axis=-1)

    return SynthWorld(
        frame_times=frame_times, P=P, Q=Q, V=V, landmarks=landmarks,
        imu_dts=imu_dts, imu_accs=imu_accs, imu_gyrs=imu_gyrs,
        imu_acc0=imu_acc0, imu_gyr0=imu_gyr0, gravity=G, ba=ba, bg=bg,
    )


