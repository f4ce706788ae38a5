"""The benchmark's frame renderer: the textured room of
isvins_tpu_torch/utils/synthetic.py's RoomRenderer, rewritten in PyTorch
so that it renders on the card during set-up.

The camera moves inside a convex polygon of textured wall planes; every
pixel ray of the camera, lifted through the configuration's camera model
(benchmark/traffic/camera.py: pinhole-radtan, MEI, equidistant or
Scaramuzza), hits the nearest wall along it, whose texture is sampled
bilinearly. A pixel that the model cannot lift (a direction that is not
finite, or one of MEI's or the equidistant model's iterative lifts that
projects back more than SEEN_PX from its pixel) renders 0, as one whose
ray meets no wall. The pinhole path is the one it always was (the same
operations, the same frames). Each frame gets white sensor noise and is
rounded to 8 bits, as a camera delivers it.

What the seed draws, and what it does not:
- the wall geometry (the polygon's per-wall radius jitter) comes from a
  fixed NumPy seed, as RoomRenderer's does (`seed + 7`), so every seed
  renders the same room;
- the wall textures (three Gaussian-filtered uniform fields per wall, at
  sigma tex_res/16, tex_res/48 and 1.5 texels, as RoomRenderer's) and the
  per-frame noise come from a torch.Generator on the rendering device,
  seeded from the run's seed.

The Gaussian filter is scipy.ndimage.gaussian_filter's (truncate 4, mode
"reflect"), written as one banded matrix per sigma and applied as two
matrix products, which are deterministic on the card."""

from __future__ import annotations

import math

import numpy as np
import torch

from .camera import lift, model_of, space_to_plane

# a lifted pixel whose ray projects back farther than this from it is one
# that the model cannot lift (an iteration that left the model's domain)
SEEN_PX = 1e-2


def gaussian_matrix(n: int, sigma: float, dtype=torch.float64, device=None) -> torch.Tensor:
    """(n, n) G with G @ u = scipy.ndimage.gaussian_filter1d(u, sigma,
    axis=0) (truncate 4.0, mode "reflect": the half-sample symmetric
    extension d c b a | a b c d | d c b a)."""
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 * (x / sigma) ** 2)
    w /= w.sum()
    G = np.zeros((n, n))
    rows = np.arange(n)
    for k, wk in zip(x.astype(np.int64), w):
        j = rows + k
        # half-sample symmetric reflection, repeated until inside [0, n)
        while True:
            lo, hi = j < 0, j >= n
            if not (lo.any() or hi.any()):
                break
            j = np.where(lo, -j - 1, j)
            j = np.where(hi, 2 * n - j - 1, j)
        np.add.at(G, (rows, j), wk)
    return torch.as_tensor(G, dtype=dtype, device=device)


def _q_to_mat(q):
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class RoomRenderer:
    """render(ks) -> (len(ks), H, W) frames of `world` at frame indices ks.

    `room` holds the room's parameters (the traffic file's "room" group):
    n_walls, wall_radius, wall_z, radius_jitter, tex_res, noise_sigma and
    geometry_seed. `textures` (n_walls, T, T), if given, replaces the
    seeded textures (the comparison with the port's renderer passes its
    own)."""

    def __init__(self, world, cam: dict, tic, qic, room: dict, generator: torch.Generator,
                 device, textures: torch.Tensor | None = None):
        self.world, self.cam, self.device = world, cam, device
        self.gen = generator
        self.noise_sigma = float(room["noise_sigma"])
        self.R_bc = _q_to_mat(qic)
        self.tic = np.asarray(tic, dtype=np.float64)
        n, R, J = int(room["n_walls"]), float(room["wall_radius"]), float(room["radius_jitter"])
        g_rng = np.random.default_rng(int(room["geometry_seed"]))
        ang = (np.arange(n) + 0.5) * 2 * np.pi / n
        radii = R + g_rng.uniform(-J, J, n)
        f64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)
        self.centers = f64(np.stack([radii * np.cos(ang), radii * np.sin(ang), np.zeros(n)], 1))
        self.normals = f64(-np.stack([np.cos(ang), np.sin(ang), np.zeros(n)], 1))
        self.u_axes = f64(np.stack([-np.sin(ang), np.cos(ang), np.zeros(n)], 1))
        self.v_axes = f64(np.tile([0.0, 0.0, 1.0], (n, 1)))
        self.half_u = (R + J) * math.tan(math.pi / n) * 1.35
        self.half_v = float(room["wall_z"])
        T = int(room["tex_res"])
        self.T = T
        self.textures = (textures.to(device, torch.float64) if textures is not None
                         else self._textures(n, T))
        H, W = int(cam["height"]), int(cam["width"])
        ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=device) + 0.5,
                                torch.arange(W, dtype=torch.float64, device=device) + 0.5,
                                indexing="ij")
        uv = torch.stack([xs, ys], dim=-1)
        self.rays = lift(cam, uv)  # (H, W, 3)
        self.seen = None  # (H, W) the pixels the model lifts; None: all of them (pinhole)
        if model_of(cam) != "pinhole":
            seen = torch.isfinite(self.rays).all(dim=-1)
            if model_of(cam) in ("mei", "equidistant"):
                back = space_to_plane(cam, torch.where(seen[..., None], self.rays, 1.0))
                seen &= (back - uv).norm(dim=-1) <= SEEN_PX
            self.seen = seen
            self.rays = torch.where(seen[..., None], self.rays, uv.new_tensor([0.0, 0.0, 1.0]))

    def _textures(self, n: int, T: int) -> torch.Tensor:
        """Per wall 110 + s / std(|s|) * 22 with s = 3 coarse + 2 mid + 0.8
        fine, each a mean-removed Gaussian-filtered uniform field (RoomRenderer's
        recipe), from one uniform draw of the generator."""
        U = torch.rand((3, n, T, T), generator=self.gen, dtype=torch.float64,
                       device=self.device)
        parts = []
        for u, sigma in zip(U, (T / 16.0, T / 48.0, 1.5)):
            G = gaussian_matrix(T, sigma, device=self.device)
            f = G @ u @ G.T
            parts.append(f - f.mean(dim=(1, 2), keepdim=True))
        s = 3.0 * parts[0] + 2.0 * parts[1] + 0.8 * parts[2]
        sd = s.abs().flatten(1).std(dim=1, unbiased=False)
        return 110.0 + s / sd[:, None, None] * 22.0

    def clean(self, k: int) -> torch.Tensor:
        """Frame k before noise and rounding, (H, W) float64."""
        w = self.world
        R_wb = _q_to_mat(w.Q[k])
        R_wc = torch.as_tensor(R_wb @ self.R_bc, device=self.device)
        C_w = torch.as_tensor(w.P[k] + R_wb @ self.tic, device=self.device)
        d_w = self.rays @ R_wc.T  # (H, W, 3)
        denom = d_w @ self.normals.T  # (H, W, n)
        num = ((self.centers - C_w) * self.normals).sum(-1)  # (n,)
        t = num / denom
        hit = (denom < -1e-9) & (t > 1e-6)
        rel0 = C_w - self.centers  # (n, 3)
        a = (rel0 * self.u_axes).sum(-1) + t * (d_w @ self.u_axes.T)
        b = (rel0 * self.v_axes).sum(-1) + t * (d_w @ self.v_axes.T)
        inside = hit & (a.abs() <= self.half_u) & (b.abs() <= self.half_v)
        t_in = torch.where(inside, t, torch.full_like(t, math.inf))
        m = t_in.argmin(dim=-1, keepdim=True)  # the nearest wall; the first on a tie
        any_in = torch.gather(inside, -1, m)[..., 0]
        if self.seen is not None:
            any_in = any_in & self.seen
        a, b = torch.gather(a, -1, m)[..., 0], torch.gather(b, -1, m)[..., 0]
        T = self.T
        fx = torch.clamp((a / self.half_u + 1) * 0.5 * (T - 1), 0, T - 1 - 1e-6)
        fy = torch.clamp((b / self.half_v + 1) * 0.5 * (T - 1), 0, T - 1 - 1e-6)
        ix, iy = fx.long(), fy.long()
        wx, wy = fx - ix, fy - iy
        flat = self.textures.reshape(-1)
        base = m[..., 0] * (T * T)
        at = lambda yy, xx: flat[base + yy * T + xx]
        val = (at(iy, ix) * (1 - wx) * (1 - wy) + at(iy, ix + 1) * wx * (1 - wy)
               + at(iy + 1, ix) * (1 - wx) * wy + at(iy + 1, ix + 1) * wx * wy)
        return torch.where(any_in, val, torch.zeros_like(val))

    def render(self, ks) -> torch.Tensor:
        """uint8 frames (len(ks), H, W) on the device: clean(k) plus white
        noise of sigma noise_sigma, clipped to [0, 255] and rounded."""
        out = []
        for k in ks:
            img = self.clean(int(k))
            noise = torch.randn(img.shape, generator=self.gen, dtype=torch.float32,
                                device=self.device)
            img = img + self.noise_sigma * noise.to(torch.float64)
            out.append(torch.round(torch.clamp(img, 0.0, 255.0)).to(torch.uint8))
        return torch.stack(out)
