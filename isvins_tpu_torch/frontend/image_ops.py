"""Image kernels the pose graph's keyframe step needs (torch port of part of
isvins_tpu/frontend/image_ops.py): separable Gaussian blur, Sobel
gradients, Shi-Tomasi response, non-maximum suppression with top-k,
bilinear sampling. Plain torch on (H, W) tensors; results keep the input's
device and dtype.

The 1D correlations keep the reference's shift-add form (sum of the taps
times shifted copies, in tap order), so the port rounds as the reference
does. `pyr_down`, `build_pyramid`, `min_dist_mask` and `clahe` come with
the tracker.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def sobel(img):
    """(gx, gy), 3x3 Sobel with SAME padding: smooth [1,2,1]/4 across,
    difference [-1,0,1]/2 along."""
    smooth = torch.tensor([0.25, 0.5, 0.25], dtype=img.dtype, device=img.device)
    diff = torch.tensor([-0.5, 0.0, 0.5], dtype=img.dtype, device=img.device)
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
