"""BRIEF descriptors and batched Hamming matching (torch port of
isvins_tpu/posegraph/brief.py; reference DVision::BRIEF and DBoW2's
per-descriptor scoring).

Extraction samples a fixed 256-pair pattern on the blurred image: each
keypoint's 28x28 patch times two constant bilinear selection matrices (two
matmuls), bit `a < b`, 32 bits packed per word. Descriptors are (N, 8)
int32 tensors holding the uint32 words' bits (see ops/hamming.py). The
pattern is generated (seeded Gaussian pairs), as in the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..frontend.image_ops import gaussian_blur
from ..ops.hamming import hamming_matrix


def make_brief_pattern(n_bits: int = 256, patch: float = 24.0, seed: int = 7):
    """(n_bits, 4) [ax, ay, bx, by] offsets, N(0, patch/5) clipped to patch/2."""
    rng = np.random.default_rng(seed)
    off = rng.normal(scale=patch / 5.0, size=(n_bits, 4))
    return np.clip(off, -patch / 2, patch / 2)


_PS = 28  # patch side: offsets are clipped to +-12, bilinear needs +1, pad 2


@functools.lru_cache(maxsize=4)
def _selection_matrices(pattern_bytes: bytes, n_bits: int):
    """Constant (n_bits, PS*PS) f32 bilinear-weight matrices of the pattern's
    a and b sample points, evaluated at the patch center (numpy)."""
    pattern = np.frombuffer(pattern_bytes, np.float64).reshape(n_bits, 4)

    def mat(off):
        x = off[:, 0] + _PS // 2
        y = off[:, 1] + _PS // 2
        x0 = np.floor(x).astype(int)
        y0 = np.floor(y).astype(int)
        fx = (x - x0).astype(np.float32)
        fy = (y - y0).astype(np.float32)
        M = np.zeros((n_bits, _PS * _PS), np.float32)
        rows = np.arange(n_bits)
        for dy in (0, 1):
            for dx in (0, 1):
                w = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                np.add.at(M, (rows, (y0 + dy) * _PS + (x0 + dx)), w)
        return M

    return mat(pattern[:, :2]), mat(pattern[:, 2:])


def _pack_bits(bits):
    """(N, 256) bool -> (N, 8) int32 words (bit i of word w = bit 32w+i)."""
    sh = torch.arange(32, device=bits.device)
    words = (bits.reshape(bits.shape[0], -1, 32).long() << sh).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def brief_descriptors(img, pts, valid, pattern):
    """img (H, W) tensor, pts (N, 2) pixel coords, valid (N,) bool, pattern
    (256, 4) numpy. Returns (N, 8) int32 descriptors (zero where invalid),
    on img's device. Points round to the pixel grid; the 28x28 patch origin
    is clipped to the image."""
    pattern = np.asarray(pattern, np.float64)
    Sa, Sb = _selection_matrices(pattern.tobytes(), pattern.shape[0])
    dev = img.device
    H, W = img.shape
    sm = gaussian_blur(img.to(torch.float32), 2.0, 4)
    c = torch.round(pts).to(torch.int64) - _PS // 2
    cx = torch.clamp(c[:, 0], 0, W - _PS)
    cy = torch.clamp(c[:, 1], 0, H - _PS)
    ar = torch.arange(_PS, device=dev)
    P = sm[(cy[:, None] + ar)[:, :, None], (cx[:, None] + ar)[:, None, :]].reshape(len(pts), -1)
    va = P @ torch.as_tensor(Sa, device=dev).T
    vb = P @ torch.as_tensor(Sb, device=dev).T
    desc = _pack_bits(va < vb)
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))


def match_descriptors(desc_a, valid_a, desc_b, valid_b):
    """Best match in b for each a: (best_idx (Na,) int32, best_dist (Na,));
    invalid entries get distance 512."""
    d = hamming_matrix(desc_a, desc_b)
    d = torch.where(valid_b[None, :], d, torch.full_like(d, 512))
    dist, best = torch.min(d, dim=1)
    dist = torch.where(valid_a, dist, torch.full_like(dist, 512))
    return best.to(torch.int32), dist


def match_descriptors_clean(desc_a, valid_a, desc_b, valid_b, ham_thresh=64, ratio=0.9):
    """Best match in b for each a, with the Lowe ratio test and a mutual
    cross-check. Returns (best_idx (Na,) int32, keep (Na,) bool). Ties go
    to the first index (torch.argmin and jnp.argmin agree); the ratio test
    compares in f64, as the reference does under x64."""
    d = hamming_matrix(desc_a, desc_b)
    big = torch.full_like(d, 512)
    d = torch.where(valid_b[None, :], d, big)
    d = torch.where(valid_a[:, None], d, big)
    best = d.argmin(dim=1)
    dist = d.gather(1, best[:, None])[:, 0]
    rows = torch.arange(d.shape[0], device=d.device)
    dist2 = d.index_put((rows, best), big[0, 0]).amin(dim=1)
    keep = valid_a & (dist < ham_thresh) & (dist < ratio * dist2.to(torch.float64))
    keep &= d.argmin(dim=0)[best] == rows  # cross-check: b's nearest query is a
    return best.to(torch.int32), keep


def global_descriptor(desc, valid):
    """(D, 8) int32 packed -> (256,) f32 mean-bit signature, centered and
    normalized."""
    sh = torch.arange(32, device=desc.device)
    bits = ((desc.to(torch.int64)[:, :, None] >> sh) & 1).to(torch.float32)
    bits = bits.reshape(desc.shape[0], 256)
    w = valid.to(torch.float32)
    m = torch.sum(bits * w[:, None], dim=0) / torch.clamp(torch.sum(w), min=1.0)
    c = m - 0.5
    return c / torch.clamp(torch.linalg.norm(c), min=1e-9)
