"""The frozen camera models (benchmark/traffic/camera.py) and the renderer
through them, on the CPU.

- each model's lift is the port's (isvins_tpu_torch/frontend/camera.py)
  in float64, scaled to z = 1 as the port hands it on;
- pixel -> ray -> pixel: with each inverse run to convergence, every
  model but Scaramuzza's comes back within 1e-9 px (Scaramuzza's forward
  projection is a fitted inverse polynomial, so its round trip holds to
  the fit); at the port's own iteration counts, within what those counts
  leave at the calibrations below (the equidistant model's 10 Newton
  steps converge; radtan's 25 and MEI's 8 fixed-point steps stop short at
  a strongly distorted edge);
- the pinhole render is the one the benchmark has always rendered: the
  same frames, bit for bit, as before the renderer took other models
  (sha256 of frames rendered before that change at this size);
- an equidistant and a MEI camera render the room, and a pixel outside
  MEI's valid disc renders 0."""

import hashlib

import numpy as np
import pytest
import torch

from benchmark.traffic import camera
from benchmark.traffic.render import RoomRenderer

from test_bench_traffic import CAM, Q_BC, ROOM, _world

_BASE = dict(width=752, height=480, fx=461.6, fy=460.3, cx=363.0, cy=248.1, k1=-0.2917,
             k2=0.08228, p1=5.333e-05, p2=-0.0001578, model="pinhole", xi=0.0,
             kb=[0.0, 0.0, 0.0, 0.0], ocam_poly=[], ocam_inv_poly=[], ocam_cde=[1.0, 0.0, 0.0])


def _fit_ocam():
    """A quasi-parabolic mirror's forward polynomial and its inverse fitted
    numerically, as the Scaramuzza toolbox ships them (tests/test_cameras.py)."""
    a0, a2, a3 = -160.0, 9.0e-4, 1.5e-7
    phi = np.linspace(0.0, 420.0, 500)
    theta = np.arctan2(a0 + a2 * phi ** 2 + a3 * phi ** 3, phi)
    return [a0, 0.0, a2, a3], list(np.polynomial.polynomial.polyfit(theta, phi, 11))


_POLY, _INV = _fit_ocam()
# each model's calibration (tests/test_torch_frontend_ops.py's), and the
# widest round trip (px) that the port's iteration counts leave on its image
CAMS = {
    "pinhole": (dict(_BASE), 3e-7),
    "mei": (dict(_BASE, model="mei", xi=0.9, fx=600.0, fy=602.0, cx=370.0, cy=240.0, k1=-0.2,
                 k2=0.05, p1=1e-4, p2=-2e-4), 3e-3),
    "equidistant": (dict(_BASE, model="equidistant", width=512, height=512, fx=285.7, fy=286.0,
                         cx=254.9, cy=256.9, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
                         kb=[0.00348, 0.000715, -0.00205, 0.000203]), 1e-9),
    "scaramuzza": (dict(_BASE, model="scaramuzza", width=640, height=480, fx=160.0, cx=320.0,
                        cy=240.0, ocam_poly=_POLY, ocam_inv_poly=_INV,
                        ocam_cde=[1.0002, -3e-5, 4e-5]), 2e-5),
}


def _pixels(cam):
    H, W = cam["height"], cam["width"]
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64) + 0.5,
                            torch.arange(W, dtype=torch.float64) + 0.5, indexing="ij")
    return torch.stack([xs, ys], dim=-1)


@pytest.mark.parametrize("model", sorted(CAMS))
def test_lift_is_the_ports(model):
    from isvins_tpu_torch.config import CameraConfig
    from isvins_tpu_torch.frontend.camera import make_camera

    cam = CAMS[model][0]
    port = make_camera(CameraConfig(**{k: tuple(v) if isinstance(v, list) else v
                                       for k, v in cam.items()}))
    uv = _pixels(cam)[::7, ::7]
    want = port.lift_projective(uv)
    got = camera.z1(camera.lift(cam, uv))
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)
    pts = camera.lift(cam, uv, iters=100)
    torch.testing.assert_close(camera.space_to_plane(cam, pts), port.space_to_plane(pts),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("model", sorted(CAMS))
def test_pixel_ray_pixel_round_trip(model):
    cam, at_port_counts = CAMS[model]
    uv = _pixels(cam)[::4, ::4]  # the corners, where the inverses stop shortest, among them
    gap = lambda rays: float((camera.space_to_plane(cam, rays) - uv).norm(dim=-1).max())
    assert gap(camera.lift(cam, uv)) <= at_port_counts
    converged = gap(camera.lift(cam, uv, iters=100))
    assert converged <= (2e-5 if model == "scaramuzza" else 1e-9), converged


def test_a_fisheye_ray_may_look_sideways():
    cam = dict(CAMS["equidistant"][0], fx=100.0, fy=100.0)
    d = camera.lift(cam, torch.tensor([[cam["cx"] + 200.0, cam["cy"]]], dtype=torch.float64))
    assert d[0, 2] < 0.0  # beyond 90 degrees off the axis: behind the image plane
    assert camera.z1(d)[0, 2] == 1.0


# frames rendered by the benchmark's renderer before it took other camera
# models, at this file's cut (188x120 radtan, 64-texel walls, frames 0-2)
PINHOLE_SHA256 = {2**40 + 5: "dbebc951ac63f75d6f87d4da1bc8a3af1722c73aa6d6857fe35c5dfcaf2d51c2",
                  7: "3db1e72ac50b6503759db6350968488dbda046ecc9097a7210b7d10ad0075d18"}


@pytest.mark.parametrize("seed", sorted(PINHOLE_SHA256))
def test_pinhole_render_is_bit_for_bit_the_one_before(seed):
    r = RoomRenderer(_world(n=3), CAM, np.zeros(3), Q_BC, ROOM, torch.Generator().manual_seed(seed),
                     "cpu")
    assert r.seen is None
    frames = r.render(range(3)).numpy()
    assert hashlib.sha256(frames.tobytes()).hexdigest() == PINHOLE_SHA256[seed]


def _render(cam, seed=3):
    cam = dict(cam, width=160, height=120)
    return RoomRenderer(_world(n=2), cam, np.zeros(3), Q_BC, ROOM,
                        torch.Generator().manual_seed(seed), "cpu")


def test_an_equidistant_camera_renders_the_room():
    cam = dict(CAMS["equidistant"][0], fx=100.0, fy=100.0, cx=80.0, cy=60.0)
    r = _render(cam)
    assert bool(r.seen.all())
    img = r.clean(1)
    assert float((img > 0).float().mean()) > 0.9
    # the rays are the lift's directions: over 50 degrees off the axis at the corners
    ang = torch.rad2deg(torch.acos(r.rays[..., 2] / r.rays.norm(dim=-1)))
    assert float(ang.max()) > 50.0


def test_a_pixel_outside_meis_valid_disc_renders_zero():
    cam = dict(CAMS["mei"][0], xi=1.6, fx=90.0, fy=90.0, cx=80.0, cy=60.0, k1=0.0, k2=0.0,
               p1=0.0, p2=0.0)
    r = _render(cam)
    rho2 = ((_pixels(dict(cam, width=160, height=120)) - torch.tensor([80.0, 60.0])) / 90.0
            ).pow(2).sum(-1)
    outside = rho2 > 1.0 / (1.6 ** 2 - 1.0)
    assert bool(outside.any()) and bool((~outside).any())
    assert not bool(r.seen[outside].any())
    img = r.clean(1)
    assert bool((img[outside] == 0).all())
    assert float((img[~outside] > 0).float().mean()) > 0.3  # the others see past the walls' tops
