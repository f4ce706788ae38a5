"""K3's plain version (frozen copy of isvins_tpu_torch/ops/schur.py's
schur_corr_ref)."""

from __future__ import annotations


def schur_corr_ref(W, h_safe, b_l):
    """C = W^T diag(1/h) W (Dr, Dr) and c_b = W^T (b_l / h) (Dr,)."""
    Wi = W / h_safe[:, None]
    return W.T @ Wi, W.T @ (b_l / h_safe)
