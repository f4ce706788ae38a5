"""Image kernels of the feature tracker and the pose graph's keyframe step
(torch port of isvins_tpu/frontend/image_ops.py): separable Gaussian blur,
pyramid, CLAHE, Sobel gradients, Shi-Tomasi response, non-maximum
suppression with top-k, the min-distance mask, bilinear sampling. Plain
torch on (H, W) tensors; results keep the input's device and dtype.

The 1D correlations keep the reference's shift-add form (sum of the taps
times shifted copies, in tap order), so the port rounds as the reference
does. Where the reference materializes a large intermediate that XLA fuses
away (CLAHE's one-hot histograms, the min-distance mask's per-point
distance planes), the port computes the same values without it. Nothing
here reads the device on the host; the Sobel taps are copied to a device
once (`shared_const`), on their first call there.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import shared_const


def _gauss_kernel(sigma: float, radius: int, dtype, device=None):
    x = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _conv1d_axis(img, k, axis: int):
    """1D correlation along `axis` with SAME (zero) padding: sum_i k[i] *
    img shifted by i."""
    r = (k.shape[0] - 1) // 2
    H, W = img.shape
    p = F.pad(img, (0, 0, r, r) if axis == 0 else (r, r, 0, 0))
    out = torch.zeros_like(img)
    for i in range(k.shape[0]):
        out = out + k[i] * (p[i:i + H, :] if axis == 0 else p[:, i:i + W])
    return out


def sep_conv2d(img, kx, ky):
    """Separable 2D correlation with SAME padding. img (H, W)."""
    return _conv1d_axis(_conv1d_axis(img, kx, 1), ky, 0)


def gaussian_blur(img, sigma: float = 1.0, radius: int = 2):
    k = _gauss_kernel(sigma, radius, img.dtype, img.device)
    return sep_conv2d(img, k, k)


def pyr_down(img):
    """Gaussian blur + 2x decimation (cv::pyrDown-like)."""
    return gaussian_blur(img, 1.0, 2)[::2, ::2]


def build_pyramid(img, levels: int):
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def sobel(img):
    """(gx, gy), 3x3 Sobel with SAME padding: smooth [1,2,1]/4 across,
    difference [-1,0,1]/2 along. The taps are made once per dtype and
    device, so a CUDA graph may capture this."""
    smooth = shared_const([0.25, 0.5, 0.25], img.dtype, img.device)
    diff = shared_const([-0.5, 0.0, 0.5], img.dtype, img.device)
    gx = _conv1d_axis(_conv1d_axis(img, smooth, 0), diff, 1)
    gy = _conv1d_axis(_conv1d_axis(img, smooth, 1), diff, 0)
    return gx, gy


def shi_tomasi_response(img, window: int = 3):
    """Min-eigenvalue corner response (cv::goodFeaturesToTrack scoring)."""
    gx, gy = sobel(img)
    k = torch.ones((window,), dtype=img.dtype, device=img.device) / window
    xx = sep_conv2d(gx * gx, k, k)
    yy = sep_conv2d(gy * gy, k, k)
    xy = sep_conv2d(gx * gy, k, k)
    det_term = torch.sqrt(torch.clamp((xx - yy) ** 2 + 4.0 * xy * xy, min=0.0))
    return 0.5 * (xx + yy - det_term)


def nms_topk(response, k: int, nms_radius: int, border: int = 8, forbid_mask=None):
    """Local-max test via a separable max-pool (-inf padding), then the k
    best responses. Returns (xy (k, 2) in response's dtype, vals (k,),
    ok (k,)). Ties go to the lower flat index, as jax.lax.top_k breaks
    them: flat regions of a rendered image tie at the local-max test."""
    H, W = response.shape
    r = nms_radius
    x = response[None, None]
    pooled = F.max_pool2d(x, (2 * r + 1, 1), stride=1, padding=(r, 0))
    pooled = F.max_pool2d(pooled, (1, 2 * r + 1), stride=1, padding=(0, r))[0, 0]
    ninf = torch.full_like(response, -float("inf"))
    resp = torch.where(response >= pooled, response, ninf)
    yy = torch.arange(H, device=response.device)[:, None]
    xx = torch.arange(W, device=response.device)[None, :]
    inb = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    resp = torch.where(inb, resp, ninf)
    if forbid_mask is not None:
        resp = torch.where(forbid_mask, ninf, resp)
    vals, idx = torch.sort(resp.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    xy = torch.stack([idx % W, idx // W], dim=-1).to(response.dtype)
    return xy, vals, torch.isfinite(vals)


def min_dist_mask(H: int, W: int, pts, valid, radius: int):
    """Disk mask around existing points (setMask semantics,
    feature_tracker_simple.cpp:37-69). pts (N, 2) xy pixels; (H, W) bool.

    Each point is tested only over its bounding window of pixels, with the
    reference's per-pixel arithmetic (x - px)^2 + (y - py)^2 <= r^2 in
    pts' dtype, so the mask is the same bit for bit without the (N, H, W)
    distance planes; the hits go into the mask with one index_put_."""
    dev = pts.device
    r = int(radius)
    # the integers x with |x - px| <= r lie in [floor(px) - r, floor(px) + r + 1]
    off = torch.arange(-r, r + 2, device=dev)
    base = torch.floor(torch.nan_to_num(pts, nan=-1e6).clamp(-1e6, 1e6)).long()
    xs = base[:, 0, None] + off  # (N, n)
    ys = base[:, 1, None] + off
    dx = xs.to(pts.dtype) - pts[:, 0, None]
    dy = ys.to(pts.dtype) - pts[:, 1, None]
    hit = (dx[:, None, :] ** 2 + dy[:, :, None] ** 2) <= r * r  # (N, n_y, n_x)
    hit = hit & valid[:, None, None]
    hit = hit & ((xs >= 0) & (xs < W))[:, None, :] & ((ys >= 0) & (ys < H))[:, :, None]
    flat = torch.where(hit, ys[:, :, None] * W + xs[:, None, :], H * W)  # misses -> a spare slot
    mask = torch.zeros(H * W + 1, dtype=torch.bool, device=dev)
    mask.index_put_((flat.reshape(-1),), torch.ones(flat.numel(), dtype=torch.bool, device=dev))
    return mask[:H * W].reshape(H, W)


def bilinear_sample(img, xy):
    """Sample img (H, W) at subpixel xy (..., 2) with border clamping."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    wx = x - x0
    wy = y - y0
    return (img[y0, x0] * (1 - wx) * (1 - wy) + img[y0, x0 + 1] * wx * (1 - wy)
            + img[y0 + 1, x0] * (1 - wx) * wy + img[y0 + 1, x0 + 1] * wx * wy)


def clahe(img, clip_limit: float = 3.0, tiles: int = 8, bins: int = 256):
    """Contrast-limited adaptive histogram equalization
    (cv::createCLAHE(3.0, (8,8)), feature_tracker_simple.cpp:86-92).

    Tile histograms are integer counts of tile * bins + value (one
    scatter_add_, exact in any order, where the reference sums a one-hot
    tensor of 64 x 5,640 x 256 floats at 752x480); then, in the
    reference's order and in f32: clip with uniform redistribution, CDF
    LUTs, and bilinear interpolation between the four surrounding tile
    LUTs."""
    H, W = img.shape
    dev = img.device
    th, tw = H // tiles, W // tiles
    Hc, Wc = th * tiles, tw * tiles
    ii = torch.clamp(img[:Hc, :Wc], 0, bins - 1).to(torch.int64)
    ty_of = torch.arange(Hc, device=dev) // th
    tx_of = torch.arange(Wc, device=dev) // tw
    key = (ty_of[:, None] * tiles + tx_of[None, :]) * bins + ii
    counts = torch.zeros(tiles * tiles * bins, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, key.reshape(-1), torch.ones_like(key).reshape(-1))
    hist = counts.reshape(tiles * tiles, bins).to(torch.float32)

    # the reference's limit is f32 arithmetic on the traced clip_limit
    f32 = np.float32
    limit = float(max(f32(f32(clip_limit) * f32(th * tw)) / f32(bins), f32(1.0)))
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / bins

    cdf = torch.cumsum(hist, dim=1)
    cdf = (cdf - cdf[:, :1]) / torch.clamp(cdf[:, -1:] - cdf[:, :1], min=1.0) * (bins - 1)
    luts = cdf.reshape(-1)

    # bilinear interpolation between tile LUTs; the tile coordinates of a
    # row (column) are the same across the image
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    ty = torch.clamp(yy / th - 0.5, 0.0, tiles - 1.001)
    tx = torch.clamp(xx / tw - 0.5, 0.0, tiles - 1.001)
    ty0 = torch.floor(ty).to(torch.int64)
    tx0 = torch.floor(tx).to(torch.int64)
    ty1 = torch.clamp(ty0 + 1, max=tiles - 1)
    tx1 = torch.clamp(tx0 + 1, max=tiles - 1)
    wy = ty - ty0
    wx = tx - tx0

    iv = torch.clamp(img, 0, bins - 1).to(torch.int64)
    lut = lambda a, b: luts[(a * tiles + b) * bins + iv]
    out = (lut(ty0, tx0) * (1 - wy) * (1 - wx) + lut(ty0, tx1) * (1 - wy) * wx
           + lut(ty1, tx0) * wy * (1 - wx) + lut(ty1, tx1) * wy * wx)
    return out.to(img.dtype) if img.is_floating_point() else out
