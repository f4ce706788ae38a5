"""K3: landmark Schur correction (csrc/schur_corr.cu) and K7: the full
Schur reduction (csrc/schur_reduce.cu); both run the tile routine of
csrc/schur_tile.cuh.

K3 replaces isvins_tpu/ops/schur_pallas.py::schur_corr_pallas; its plain
version is schur_corr_ref. K3 is also the first launch of K4 (ops/linstep).
K7 replaces schur_reduce_pallas of the same file; its plain version is
schur_reduce_ref. Nothing in the package calls K7, as nothing in the JAX
package calls its kernel: the solver eliminates landmarks in the reduced
layout (K3/K4, or the batched step's einsum).
"""

from __future__ import annotations

import torch

from ._lib import check, launch


def schur_corr_ref(W, h_safe, b_l):
    """C = W^T diag(1/h) W (Dr, Dr) and c_b = W^T (b_l / h) (Dr,)."""
    Wi = W / h_safe[:, None]
    return W.T @ Wi, W.T @ (b_l / h_safe)


def _launch(W, h, b_l, lam):
    """Launch the kernel; `lam` None means h is already h_safe, else the
    kernel damps and guards h with the device scalar lam."""
    dev = W.device
    F, Dr = W.shape
    check(W, "W", (F, Dr), device=dev)
    check(h, "h", (F,), device=dev)
    check(b_l, "b_l", (F,), device=dev)
    if lam is not None:
        check(lam, "lam", (), device=dev)
    C = torch.empty((Dr, Dr), dtype=torch.float32, device=dev)
    c_b = torch.empty((Dr,), dtype=torch.float32, device=dev)
    launch("isv_schur_corr", W, h, b_l, lam, C, c_b, F, Dr, device=dev)
    schur_corr.launches += 1
    return C, c_b


def schur_corr(W, h_safe, b_l):
    """Kernel wrapper with schur_corr_ref's signature and returns. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if not W.is_cuda:
        return schur_corr_ref(W, h_safe, b_l)
    return _launch(W, h_safe, b_l, None)


schur_corr.launches = 0


def schur_reduce_ref(H, b, W, h, b_l):
    """(H_s (D,D), b_s (D,)) = (H - W^T diag(1/h) W, b - W^T (b_l / h)) with
    W (F, D); h <= 1e-12 (an empty landmark) counts as 1."""
    h_safe = torch.where(h > 1e-12, h, torch.ones_like(h))
    return H - W.T @ (W / h_safe[:, None]), b - W.T @ (b_l / h_safe)


def schur_reduce(H, b, W, h, b_l):
    """Kernel wrapper with schur_reduce_ref's signature and returns. The
    kernel forms H_s; b_s is a matrix-vector product outside it, as in the
    reference. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if not H.is_cuda:
        return schur_reduce_ref(H, b, W, h, b_l)
    dev = H.device
    D = H.shape[0]
    F = W.shape[0]
    check(H, "H", (D, D), device=dev)
    check(b, "b", (D,), device=dev)
    check(W, "W", (F, D), device=dev)
    check(h, "h", (F,), device=dev)
    check(b_l, "b_l", (F,), device=dev)
    H_s = torch.empty((D, D), dtype=torch.float32, device=dev)
    launch("isv_schur_reduce", H, W, h, H_s, F, D, device=dev)
    schur_reduce.launches += 1
    h_safe = torch.where(h > 1e-12, h, torch.ones_like(h))
    return H_s, b - W.T @ (b_l / h_safe)


schur_reduce.launches = 0
