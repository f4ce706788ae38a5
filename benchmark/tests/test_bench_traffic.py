"""The benchmark's traffic generator against the port's on the CPU.

- traffic/world.make_world is a frozen copy of the port's make_world: equal
  arrays for equal arguments;
- traffic/render.gaussian_matrix is scipy.ndimage.gaussian_filter's kernel
  and boundary;
- traffic/render.RoomRenderer, given the port's RoomRenderer's textures,
  renders the port's noise-free frames at a small size (EuRoC's radtan
  model cut to 188x120);
- the frames come from the seed: the same seed gives the same frames,
  another seed other textures and noise on the same room."""

import json

import numpy as np
import pytest
import torch

from benchmark.traffic.render import RoomRenderer, gaussian_matrix
from benchmark.traffic.world import make_world

from conftest import ROOT

CAM = dict(width=188, height=120, fx=115.4, fy=115.075, cx=90.75, cy=62.025,
           k1=-0.2917, k2=0.08228, p1=5.333e-05, p2=-0.0001578)
R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
Q_BC = np.array([0.5, -0.5, 0.5, -0.5])  # wxyz of R_BC
ROOM = dict(n_walls=28, wall_radius=9.0, wall_z=5.0, radius_jitter=1.0, tex_res=64,
            noise_sigma=1.5, geometry_seed=18)


def _world(n=12, seed=7):
    return make_world(n_frames=n, frame_hz=20.0, imu_hz=200.0, n_landmarks=10, seed=seed,
                      traj_r=3.0, traj_w=0.9, noise_acc=0.02, noise_gyr=0.002,
                      ba=(0.02, -0.015, 0.01), bg=(0.002, -0.003, 0.004))


def test_make_world_is_the_ports():
    from isvins_tpu_torch.utils.synthetic import make_world as port_make_world

    kw = dict(n_frames=30, frame_hz=20.0, imu_hz=200.0, n_landmarks=10, seed=2**40 + 3,
              traj_r=3.0, traj_w=0.9, noise_acc=0.02, noise_gyr=0.002,
              ba=(0.02, -0.015, 0.01), bg=(0.002, -0.003, 0.004))
    a, b = make_world(**kw), port_make_world(**kw)
    for f in ("frame_times", "P", "Q", "V", "landmarks", "imu_dts", "imu_accs", "imu_gyrs",
              "imu_acc0", "imu_gyr0", "gravity", "ba", "bg"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("sigma", [1.5, 64 / 48, 64 / 16, 40.0])
def test_gaussian_matrix_is_scipys_filter(sigma):
    from scipy.ndimage import gaussian_filter

    u = np.random.default_rng(0).uniform(size=(64, 64))
    G = gaussian_matrix(64, sigma).numpy()
    np.testing.assert_allclose(G @ u @ G.T, gaussian_filter(u, sigma), rtol=0, atol=1e-12)


def test_quat_of_the_extrinsic():
    from benchmark.harness import quat_from_mat
    from isvins_tpu_torch.geom.hostmath import mat_to_quat_np

    for R in (R_BC, np.eye(3), np.array([[-1.0, 0, 0], [0, -1.0, 0], [0, 0, 1.0]])):
        q, p = quat_from_mat(R), mat_to_quat_np(R)
        assert min(np.abs(q - p).max(), np.abs(q + p).max()) < 1e-12


def test_frames_match_the_ports_renderer():
    """The noise-free frames of both renderers on the port's textures. The
    two compute the same ray-wall intersections in other orders of
    float64 operations; a pixel whose ray meets a wall's edge within that
    rounding can take the next wall, so up to 0.2 % of the pixels may
    differ (0.05-0.06 % measured at this size); all others agree to 1e-9
    of an intensity unit."""
    from isvins_tpu_torch.config import CameraConfig
    from isvins_tpu_torch.frontend import make_camera
    from isvins_tpu_torch.utils.synthetic import RoomRenderer as PortRenderer

    world = _world()
    cam = CameraConfig(**CAM)
    port = PortRenderer(world, cam, np.zeros(3), Q_BC, seed=11, camera_model=make_camera(cam),
                        tex_res=64, noise_sigma=0.0)
    ours = RoomRenderer(world, CAM, np.zeros(3), Q_BC, ROOM, torch.Generator().manual_seed(1),
                        "cpu", textures=torch.as_tensor(port.textures))
    for k in (0, 6, 11):
        a, b = port.render(k)[0], ours.clean(k).numpy()
        far = np.abs(a - b) > 1e-9
        assert far.mean() <= 2e-3, (k, far.mean())


def test_same_seed_same_frames_other_seed_other_frames():
    world = _world(n=3)
    render = lambda s: RoomRenderer(world, CAM, np.zeros(3), Q_BC, ROOM,
                                    torch.Generator().manual_seed(s), "cpu").render(range(3))
    a, b, c = render(5), render(5), render(2**63 + 11)
    assert a.dtype == torch.uint8 and a.shape == (3, 120, 188)
    assert torch.equal(a, b)
    assert (a != c).float().mean() > 0.5


def test_traffic_files_name_what_the_harness_reads():
    for name in ("circle_revisit", "circle_steady"):
        t = json.loads((ROOT / "benchmark" / "traffic" / f"{name}.json").read_text())
        assert set(t) >= {"world", "room", "warmup", "window_frames_per_s", "trace", "check"}
        assert t["warmup"]["until"] in ("loops", "keyframes", "steady_solves", "poses")
        assert t["window_frames_per_s"] == t["world"]["frame_hz"] == 20.0
