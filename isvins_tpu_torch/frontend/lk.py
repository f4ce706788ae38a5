"""Pyramidal Lucas-Kanade optical flow, batched over features (torch port
of isvins_tpu/frontend/lk.py; replaces cv::calcOpticalFlowPyrLK, 21x21
window, feature_tracker_simple.cpp:114).

Per level and iteration every feature's integer-aligned window of the
edge-padded image is gathered with ONE index tensor (no loop over
features), and the subpixel bilinear interpolation is four shifted
whole-patch products, in the reference's order of operations. The window's
start follows `jax.lax.dynamic_slice`, which the reference slices with: a
negative start counts from the far end of the padded image, and the start
is then clamped so that the window stays inside it. A feature that wanders
past the padding is sampled from a displaced window, never from outside
the image. The iteration count is fixed and nothing is read on the host.

`pyramidal_lk` takes optional edge-padded pyramids (`padded_pyramid`), so a
caller that tracks frame after frame builds each frame's pyramid once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import shared_const
from .image_ops import build_pyramid


def padded_pyramid(img, levels: int, pad: int):
    """The image's pyramid, each level edge-padded by `pad`."""
    return [F.pad(lv[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
            for lv in build_pyramid(img, levels)]


def _shift_bilinear(q, fx, fy, P: int, dy: int, dx: int):
    """Bilinear sample of the PxP template grid inside the patches q
    (N, S, S) (origin at the integer corner - 1), shifted by the static
    integer (dy, dx); fx, fy (N, 1, 1) are the fractional offsets."""
    a, b = 1 + dy, 1 + dx
    q00 = q[:, a:a + P, b:b + P]
    q01 = q[:, a:a + P, b + 1:b + 1 + P]
    q10 = q[:, a + 1:a + 1 + P, b:b + P]
    q11 = q[:, a + 1:a + 1 + P, b + 1:b + 1 + P]
    return q00 * (1 - fx) * (1 - fy) + q01 * fx * (1 - fy) + q10 * (1 - fx) * fy + q11 * fx * fy


class _Windows:
    """Gathers each feature's (S, S) window of one padded level. The start
    index follows jax.lax.dynamic_slice: a negative start counts from the
    end (start + dim), then the start is clamped to [0, dim - S]. The dims
    are a constant made once per shape and device, so a CUDA graph may
    capture this."""

    def __init__(self, imgp, pad: int, S: int):
        Hp, Wp = imgp.shape
        self.flat, self.Wp, self.pad, self.S = imgp.reshape(-1), Wp, pad, S
        self.dims = shared_const([Wp, Hp], torch.int64, imgp.device)
        self.hi = self.dims - S
        ar = torch.arange(S, device=imgp.device)
        self.grid = ar[:, None] * Wp + ar[None, :]  # (S, S) offsets from the start

    def __call__(self, corner):
        """(N, S, S) windows whose [1, 1] element is each corner's integer
        part, and the fractional parts fx, fy (N, 1, 1)."""
        ixy = torch.floor(corner)
        frac = corner - ixy
        start = ixy.to(torch.int64) - 1 + self.pad
        start = torch.where(start < 0, start + self.dims, start)  # dynamic_slice's wrap
        start = torch.minimum(torch.clamp(start, min=0), self.hi)  # and its clamp
        base = start[:, 1] * self.Wp + start[:, 0]
        q = self.flat[base[:, None, None] + self.grid]
        return q, frac[:, 0, None, None], frac[:, 1, None, None]


def _lk_level(img0p, img1p, pad: int, pts0, guess, valid, half: int, iters: int):
    """One pyramid level. img*p are edge-padded by `pad`; pts0/guess (N, 2)
    in the level's UNPADDED pixel coords. Returns (pts1, ok, err)."""
    P = 2 * half + 1
    S = P + 3
    win0, win1 = _Windows(img0p, pad, S), _Windows(img1p, pad, S)

    q0, fx0, fy0 = win0(pts0 - half)
    t = _shift_bilinear(q0, fx0, fy0, P, 0, 0)
    # template gradients via central differences on the same patch
    dx = 0.5 * (_shift_bilinear(q0, fx0, fy0, P, 0, 1) - _shift_bilinear(q0, fx0, fy0, P, 0, -1))
    dy = 0.5 * (_shift_bilinear(q0, fx0, fy0, P, 1, 0) - _shift_bilinear(q0, fx0, fy0, P, -1, 0))
    gxx = torch.sum(dx * dx, dim=(1, 2))
    gxy = torch.sum(dx * dy, dim=(1, 2))
    gyy = torch.sum(dy * dy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    ok_g = det > 1e-6
    det_safe = torch.where(ok_g, det, torch.ones_like(det))

    cur = guess
    for _ in range(iters):
        q1, fx1, fy1 = win1(cur - half)
        diff = _shift_bilinear(q1, fx1, fy1, P, 0, 0) - t
        bx = torch.sum(diff * dx, dim=(1, 2))
        by = torch.sum(diff * dy, dim=(1, 2))
        du = -(gyy * bx - gxy * by) / det_safe
        dv = -(-gxy * bx + gxx * by) / det_safe
        cur = cur + torch.stack([du, dv], dim=-1)
    # residual check: mean abs diff after convergence
    q1, fx1, fy1 = win1(cur - half)
    err = torch.mean(torch.abs(_shift_bilinear(q1, fx1, fy1, P, 0, 0) - t), dim=(1, 2))
    return cur, valid & ok_g, err


def pyramidal_lk(img0, img1, pts0, valid, levels: int = 3, half: int = 10, iters: int = 10,
                 guess0=None, pyr0=None, pyr1=None):
    """Track pts0 (N, 2) from img0 to img1 (both (H, W) float). Returns
    (pts1 (N, 2), ok (N,), err (N,)). 21x21 window = half 10.

    guess0: optional (N, 2) initial position in img1 (full-res coords),
    cv::OPTFLOW_USE_INITIAL_FLOW semantics; the tracker's
    forward-backward check runs the backward pass single-level with it.
    pyr0, pyr1: the images' `padded_pyramid(img, levels, half + 3)`, when
    the caller has them (img0 and img1 then only give the shape)."""
    pad = half + 3
    pyr0 = padded_pyramid(img0, levels, pad) if pyr0 is None else pyr0
    pyr1 = padded_pyramid(img1, levels, pad) if pyr1 is None else pyr1
    scale = 2.0 ** (levels - 1)
    guess = (pts0 if guess0 is None else guess0) / scale
    ok = valid
    for lv in range(levels - 1, -1, -1):
        p_lv = pts0 / 2.0 ** lv
        guess, ok, err = _lk_level(pyr0[lv], pyr1[lv], pad, p_lv, guess, ok, half, iters)
        if lv > 0:
            guess = guess * 2.0
    H, W = img0.shape
    inb = (guess[:, 0] >= 1) & (guess[:, 0] < W - 1) & (guess[:, 1] >= 1) & (guess[:, 1] < H - 1)
    return guess, ok & inb & (err < 30.0), err
