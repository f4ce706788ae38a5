"""K3: landmark Schur correction (csrc/schur_corr.cu).

Replaces isvins_tpu/ops/schur_pallas.py::schur_corr_pallas. The plain
version is schur_corr_ref. K3 is also the first launch of K4 (ops/linstep).
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
