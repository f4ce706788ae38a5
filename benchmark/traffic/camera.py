"""The camera models of the port (isvins_tpu_torch/frontend/camera.py, the
camodocal family), frozen in plain float64 PyTorch for the renderer and
for the comparison of the tracker's undistortion.

A camera is the configuration's `camera` group (a dict), read as
CameraConfig's docstring gives it: pinhole (fx, fy, cx, cy, k1, k2, p1,
p2); mei adds xi and reads (gamma1, gamma2, u0, v0) from (fx, fy, cx,
cy); equidistant reads (mu, mv, u0, v0) from (fx, fy, cx, cy) and its
k2..k5 from `kb`; scaramuzza reads the image centre from (cx, cy), the
affine (C, D, E) from `ocam_cde` and its polynomials from `ocam_poly`
(pixel radius -> -z) and `ocam_inv_poly` (incidence angle -> pixel
radius).

- `lift(cam, uv)`: pixels (..., 2) -> ray directions (..., 3), with the
  port's inverses and iteration counts (radtan's fixed point 25 times,
  MEI's 8, the equidistant radius 10 Newton steps clamped to [0, pi];
  Scaramuzza's closed form; where they stop short of convergence, as
  radtan's and MEI's can at a strongly distorted image's edge, a pixel's
  ray projects back a little off it). A direction is not scaled to z = 1:
  a wide lens's pixel may look sideways or behind. Where the model cannot
  lift a pixel (outside MEI's valid disc) the direction is not finite;
- `z1(ray)`: a ray scaled to z = 1 as the port's `_z1` does (z clamped to
  1e-6 from below), what the tracker hands on as a normalized point;
- `space_to_plane(cam, p3)`: camera-frame points -> pixels, the forward
  projection that the lifts invert.

The comparison of the tracker's lift (benchmark/reference/check.py) reads
a gap on the normalized plane in pixels of fx: gamma1 for MEI, mu for
equidistant, the focal hint for Scaramuzza."""

from __future__ import annotations

import math

import torch

MODELS = {"pinhole": "pinhole", "mei": "mei", "equidistant": "equidistant",
          "kannala_brandt": "equidistant", "fisheye": "equidistant", "scaramuzza": "scaramuzza",
          "ocam": "scaramuzza"}


def model_of(cam: dict) -> str:
    """The model family a camera group names (make_camera's aliases)."""
    name = cam.get("model", "pinhole")
    if name not in MODELS:
        raise ValueError(f"unknown camera model: {name!r}")
    return MODELS[name]


def _radtan_delta(cam: dict, xy):
    """The radtan distortion (k1, k2, p1, p2) of xy (..., 2), as (dx, dy)."""
    k1, k2, p1, p2 = (float(cam[k]) for k in ("k1", "k2", "p1", "p2"))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = k1 * r2 + k2 * r2 * r2
    dx = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([dx, dy], dim=-1)


def _undistort(cam: dict, uv, fx, fy, cx, cy, iters: int):
    """Pixels (..., 2) -> undistorted normalized xy (..., 2): the
    fixed-point inverse of the radtan distortion, `iters` steps."""
    pd = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    p = pd
    for _ in range(iters):
        p = pd - _radtan_delta(cam, p)
    return p


def _kb(cam: dict):
    return tuple(float(k) for k in cam["kb"])


def _kb_r(cam: dict, th):
    k2, k3, k4, k5 = _kb(cam)
    th2 = th * th
    return th * (1.0 + th2 * (k2 + th2 * (k3 + th2 * (k4 + th2 * k5))))


def _kb_dr(cam: dict, th):
    k2, k3, k4, k5 = _kb(cam)
    th2 = th * th
    return 1.0 + th2 * (3.0 * k2 + th2 * (5.0 * k3 + th2 * (7.0 * k4 + th2 * 9.0 * k5)))


def _polyval(coeffs, x):
    """sum_i coeffs[i] * x^i by Horner."""
    acc = torch.zeros_like(x)
    for c in list(coeffs)[::-1]:
        acc = acc * x + float(c)
    return acc


def lift(cam: dict, uv: torch.Tensor, iters: int | None = None) -> torch.Tensor:
    """Pixels (..., 2) -> ray directions (..., 3) through the camera's
    model (see the module's docstring); `iters` replaces the port's
    iteration count of an iterative inverse."""
    model = model_of(cam)
    fx, fy, cx, cy = (float(cam[k]) for k in ("fx", "fy", "cx", "cy"))
    if model == "pinhole":
        p = _undistort(cam, uv, fx, fy, cx, cy, iters or 25)
        return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    if model == "mei":
        xi = float(cam["xi"])
        p = _undistort(cam, uv, fx, fy, cx, cy, iters or 8)
        rho2 = p[..., 0] ** 2 + p[..., 1] ** 2
        z = 1.0 - xi * (rho2 + 1.0) / (xi + torch.sqrt(1.0 + (1.0 - xi ** 2) * rho2))
        return torch.cat([p, z[..., None]], dim=-1)
    if model == "equidistant":
        mx, my = (uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy
        r = torch.sqrt(mx * mx + my * my)
        theta = r
        for _ in range(iters or 10):
            theta = torch.clamp(theta - (_kb_r(cam, theta) - r) / _kb_dr(cam, theta), 0.0, math.pi)
        rs = torch.where(r > 1e-12, r, torch.full_like(r, 1e-12))
        s = torch.sin(theta)
        return torch.stack([s * mx / rs, s * my / rs, torch.cos(theta)], dim=-1)
    C, D, E = (float(v) for v in cam["ocam_cde"])
    xc, yc = uv[..., 0] - cx, uv[..., 1] - cy
    inv_scale = 1.0 / (C - D * E)
    xa = inv_scale * (xc - D * yc)
    ya = inv_scale * (-E * xc + C * yc)
    z = -_polyval(cam["ocam_poly"], torch.sqrt(xa * xa + ya * ya))
    return torch.stack([xa, ya, z], dim=-1)


def z1(ray: torch.Tensor) -> torch.Tensor:
    """A ray (..., 3) scaled to z = 1, z clamped to 1e-6 from below (the
    port's `_z1`)."""
    z = ray[..., 2]
    z = torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    return torch.cat([ray[..., :2] / z[..., None], torch.ones_like(z)[..., None]], dim=-1)


def _clamp_abs(z, eps):
    return torch.where(z.abs() > eps, z, torch.full_like(z, eps))


def space_to_plane(cam: dict, p3: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2)."""
    model = model_of(cam)
    fx, fy, cx, cy = (float(cam[k]) for k in ("fx", "fy", "cx", "cy"))
    if model in ("pinhole", "mei"):
        z = p3[..., 2]
        if model == "mei":
            z = z + float(cam["xi"]) * torch.linalg.norm(p3, dim=-1)
        z = _clamp_abs(z, 1e-9)
        xy = p3[..., :2] / z[..., None]
        xyd = xy + _radtan_delta(cam, xy)
        return torch.stack([fx * xyd[..., 0] + cx, fy * xyd[..., 1] + cy], dim=-1)
    if model == "equidistant":
        norm = torch.linalg.norm(p3, dim=-1)
        norm = torch.where(norm > 1e-12, norm, torch.full_like(norm, 1e-12))
        theta = torch.arccos(torch.clamp(p3[..., 2] / norm, -1.0, 1.0))
        rxy = torch.sqrt(p3[..., 0] ** 2 + p3[..., 1] ** 2)
        rxy = torch.where(rxy > 1e-12, rxy, torch.full_like(rxy, 1e-12))
        r = _kb_r(cam, theta)
        return torch.stack([fx * r * p3[..., 0] / rxy + cx, fy * r * p3[..., 1] / rxy + cy], dim=-1)
    C, D, E = (float(v) for v in cam["ocam_cde"])
    rho = torch.sqrt(p3[..., 0] ** 2 + p3[..., 1] ** 2)
    r_img = _polyval(cam["ocam_inv_poly"], torch.atan2(-p3[..., 2], rho))
    rs = torch.where(rho > 1e-12, rho, torch.full_like(rho, 1e-12))
    xn, yn = p3[..., 0] / rs * r_img, p3[..., 1] / rs * r_img
    return torch.stack([xn * C + yn * D + cx, xn * E + yn + cy], dim=-1)
