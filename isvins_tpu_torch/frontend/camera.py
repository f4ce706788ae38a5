"""The camodocal camera-model family, batched over points (torch port of
isvins_tpu/frontend/camera.py).

PinholeRadtan (radtan), MeiCamera (unified catadioptric), EquidistantCamera
(Kannala-Brandt fisheye) and OcamCamera (Scaramuzza OCAM), plus the
`make_camera` factory. Every model exposes `space_to_plane` (3D
camera-frame points (..., 3) -> pixels (..., 2)) and `lift_projective`
(pixels (..., 2) -> normalized rays [x, y, 1] (..., 3)). Tensors go in and
out; results keep the input's device and dtype (the parameters are Python
floats). The iterative inverses are fixed-iteration loops, as in the
reference: fixed-point for the distortion inverses, Newton for the KB
radius polynomial. Rays at or beyond 90 deg off-axis are clamped to a tiny
positive z before the z = 1 normalization.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


def _clamp_abs(z, eps):
    """z where |z| > eps, else eps (the reference's jnp.where guard)."""
    return torch.where(z.abs() > eps, z, torch.full_like(z, eps))


def _radtan(m, xy):
    """Apply radtan distortion (k1, k2, p1, p2 of model m) on (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = m.k1 * r2 + m.k2 * r2 * r2
    dx = x * radial + 2.0 * m.p1 * x * y + m.p2 * (r2 + 2.0 * x * x)
    dy = y * radial + m.p1 * (r2 + 2.0 * y * y) + 2.0 * m.p2 * x * y
    return xy + torch.stack([dx, dy], dim=-1)


def _z1(ray):
    """Normalize a projective ray (..., 3) to z = 1 with a safe z clamp."""
    z = ray[..., 2]
    z = torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    return torch.cat([ray[..., :2] / z[..., None], torch.ones_like(z)[..., None]], dim=-1)


class PinholeRadtan(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    p1: float
    p2: float

    @staticmethod
    def from_config(cam) -> "PinholeRadtan":
        return PinholeRadtan(*(float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy,
                                                  cam.k1, cam.k2, cam.p1, cam.p2)))

    def distort(self, xy):
        return _radtan(self, xy)

    def space_to_plane(self, p3):
        z = _clamp_abs(p3[..., 2], 1e-9)
        xyd = self.distort(p3[..., :2] / z[..., None])
        return torch.stack([self.fx * xyd[..., 0] + self.cx,
                            self.fy * xyd[..., 1] + self.cy], dim=-1)

    def lift_projective(self, uv, iters: int = 25):
        pd = torch.stack([(uv[..., 0] - self.cx) / self.fx,
                          (uv[..., 1] - self.cy) / self.fy], dim=-1)
        p = pd
        for _ in range(iters):
            p = pd - (self.distort(p) - p)
        return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)

    @property
    def focal(self):
        return self.fx


class MeiCamera(NamedTuple):
    """Unified catadioptric model (camodocal CataCamera)."""

    xi: float
    gamma1: float
    gamma2: float
    u0: float
    v0: float
    k1: float
    k2: float
    p1: float
    p2: float

    @staticmethod
    def from_config(cam) -> "MeiCamera":
        return MeiCamera(*(float(v) for v in (cam.xi, cam.fx, cam.fy, cam.cx, cam.cy,
                                              cam.k1, cam.k2, cam.p1, cam.p2)))

    def distort(self, xy):
        return _radtan(self, xy)

    def space_to_plane(self, p3):
        z = p3[..., 2] + self.xi * torch.linalg.norm(p3, dim=-1)
        z = _clamp_abs(z, 1e-9)
        xyd = self.distort(p3[..., :2] / z[..., None])
        return torch.stack([self.gamma1 * xyd[..., 0] + self.u0,
                            self.gamma2 * xyd[..., 1] + self.v0], dim=-1)

    def lift_projective(self, uv, iters: int = 8):
        pd = torch.stack([(uv[..., 0] - self.u0) / self.gamma1,
                          (uv[..., 1] - self.v0) / self.gamma2], dim=-1)
        p = pd
        for _ in range(iters):
            p = pd - (self.distort(p) - p)
        rho2 = p[..., 0] ** 2 + p[..., 1] ** 2
        z = 1.0 - self.xi * (rho2 + 1.0) / (
            self.xi + torch.sqrt(1.0 + (1.0 - self.xi ** 2) * rho2))
        return _z1(torch.cat([p, z[..., None]], dim=-1))

    @property
    def focal(self):
        return self.gamma1 / (1.0 + self.xi)


class EquidistantCamera(NamedTuple):
    """Kannala-Brandt fisheye (camodocal EquidistantCamera)."""

    mu: float
    mv: float
    u0: float
    v0: float
    k2: float
    k3: float
    k4: float
    k5: float

    @staticmethod
    def from_config(cam) -> "EquidistantCamera":
        return EquidistantCamera(*(float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy,
                                                      *cam.kb)))

    def _r(self, th):
        th2 = th * th
        return th * (1.0 + th2 * (self.k2 + th2 * (self.k3 + th2 * (self.k4 + th2 * self.k5))))

    def _dr(self, th):
        th2 = th * th
        return 1.0 + th2 * (3.0 * self.k2 + th2 * (5.0 * self.k3 + th2 * (
            7.0 * self.k4 + th2 * 9.0 * self.k5)))

    def space_to_plane(self, p3):
        norm = torch.linalg.norm(p3, dim=-1)
        norm = torch.where(norm > 1e-12, norm, torch.full_like(norm, 1e-12))
        theta = torch.arccos(torch.clamp(p3[..., 2] / norm, -1.0, 1.0))
        rxy = torch.sqrt(p3[..., 0] ** 2 + p3[..., 1] ** 2)
        rxy = torch.where(rxy > 1e-12, rxy, torch.full_like(rxy, 1e-12))
        r = self._r(theta)
        return torch.stack([self.mu * r * p3[..., 0] / rxy + self.u0,
                            self.mv * r * p3[..., 1] / rxy + self.v0], dim=-1)

    def lift_projective(self, uv, iters: int = 10):
        mx = (uv[..., 0] - self.u0) / self.mu
        my = (uv[..., 1] - self.v0) / self.mv
        r = torch.sqrt(mx * mx + my * my)
        theta = r
        for _ in range(iters):
            theta = torch.clamp(theta - (self._r(theta) - r) / self._dr(theta), 0.0, math.pi)
        rs = torch.where(r > 1e-12, r, torch.full_like(r, 1e-12))
        s = torch.sin(theta)
        return _z1(torch.stack([s * mx / rs, s * my / rs, torch.cos(theta)], dim=-1))

    @property
    def focal(self):
        return self.mu


class OcamCamera(NamedTuple):
    """Scaramuzza OCAM polynomial omnidirectional model (camodocal
    ScaramuzzaCamera): `poly` lifts image radius -> -z, `inv_poly` maps the
    incidence angle to image radius, [C D; E 1] is the sensor affine."""

    poly: Tuple[float, ...]
    inv_poly: Tuple[float, ...]
    C: float
    D: float
    E: float
    center_x: float
    center_y: float
    focal_hint: float

    @staticmethod
    def from_config(cam) -> "OcamCamera":
        return OcamCamera(tuple(float(c) for c in cam.ocam_poly),
                          tuple(float(c) for c in cam.ocam_inv_poly),
                          *(float(v) for v in (*cam.ocam_cde, cam.cx, cam.cy, cam.fx)))

    @staticmethod
    def _polyval(coeffs, x):
        """sum_i coeffs[i] * x^i by Horner."""
        acc = torch.zeros_like(x)
        for c in coeffs[::-1]:
            acc = acc * x + c
        return acc

    def space_to_plane(self, p3):
        rho = torch.sqrt(p3[..., 0] ** 2 + p3[..., 1] ** 2)
        r_img = self._polyval(self.inv_poly, torch.atan2(-p3[..., 2], rho))
        rs = torch.where(rho > 1e-12, rho, torch.full_like(rho, 1e-12))
        xn = p3[..., 0] / rs * r_img
        yn = p3[..., 1] / rs * r_img
        return torch.stack([xn * self.C + yn * self.D + self.center_x,
                            xn * self.E + yn + self.center_y], dim=-1)

    def lift_projective(self, uv):
        xc = uv[..., 0] - self.center_x
        yc = uv[..., 1] - self.center_y
        inv_scale = 1.0 / (self.C - self.D * self.E)
        xa = inv_scale * (xc - self.D * yc)
        ya = inv_scale * (-self.E * xc + self.C * yc)
        z = -self._polyval(self.poly, torch.sqrt(xa * xa + ya * ya))
        # the affine-corrected sensor-plane coordinates, as the reference
        return _z1(torch.stack([xa, ya, z], dim=-1))

    @property
    def focal(self):
        return self.focal_hint


def make_camera(cam_cfg):
    """camodocal::CameraFactory::generateCamera, dispatching on
    CameraConfig.model."""
    model = getattr(cam_cfg, "model", "pinhole")
    if model == "pinhole":
        return PinholeRadtan.from_config(cam_cfg)
    if model == "mei":
        return MeiCamera.from_config(cam_cfg)
    if model in ("equidistant", "kannala_brandt", "fisheye"):
        return EquidistantCamera.from_config(cam_cfg)
    if model in ("scaramuzza", "ocam"):
        if len(cam_cfg.ocam_poly) == 0 or len(cam_cfg.ocam_inv_poly) == 0:
            raise ValueError("scaramuzza model requires ocam_poly/ocam_inv_poly")
        return OcamCamera.from_config(cam_cfg)
    raise ValueError(f"unknown camera model: {model!r}")
