"""K4: the fused LM linear step (csrc/linstep.cu, first launch
csrc/schur_corr.cu), and the batched linear step of the multi-sequence
solve, whose factorization is K5 (ops/chol_batched).

K4 replaces isvins_tpu/ops/linstep_pallas.py::linstep_pallas. The plain
version linstep_ref is the JAX linstep_ref math (identical to the
unfused solve_window body). linstep_batched is the port of
`_linstep_batched` of the same file: linstep_ref with a leading sequence
axis, the products as batched torch ops and the NB solves in K5. Two
deliberate choices, shared by the kernels, the plain versions and the
batched step:
- the trace jitter is 1e-12 trace(H_d)/D (linstep_ref), not the Pallas
  body's trace of diag(H), nor `_linstep_batched`'s trace of the clipped
  diagonal of H; they differ far below the tolerance;
- a matrix that is not SPD yields NaN (the Pallas body clamps the pivot),
  so the LM accept test rejects the step as it does for jnp.linalg.cholesky.
"""

from __future__ import annotations

import torch

from ..factors.preintegration import cholesky_nan
from . import schur
from ._lib import SMEM_LIMIT, check, launch
from .chol_batched import chol_solve_batched, chol_solve_batched_ref


def linstep_ref(H, b, W, h, b_l, lam, n_pose, D):
    """Returns (dx (D,), dl (F,))."""
    Dr = W.shape[1]
    h_d = h * (1.0 + lam)
    h_safe = torch.where(h_d > 1e-12, h_d, torch.ones_like(h_d))
    C, c_b = schur.schur_corr_ref(W, h_safe, b_l)
    ex0 = D - (Dr - n_pose)
    H_s = H.clone()
    H_s[:n_pose, :n_pose] -= C[:n_pose, :n_pose]
    H_s[:n_pose, ex0:] -= C[:n_pose, n_pose:]
    H_s[ex0:, :n_pose] -= C[n_pose:, :n_pose]
    H_s[ex0:, ex0:] -= C[n_pose:, n_pose:]
    b_s = b.clone()
    b_s[:n_pose] -= c_b[:n_pose]
    b_s[ex0:] -= c_b[n_pose:]
    diagH = torch.clamp(torch.diagonal(H), min=1e-8)
    H_d = H_s + torch.diag(lam * diagH)
    eye = torch.eye(D, dtype=H.dtype, device=H.device)
    L = cholesky_nan(H_d + 1e-12 * torch.trace(H_d) / D * eye)
    dx = torch.cholesky_solve(b_s[:, None], L)[:, 0]
    dx_r = torch.cat([dx[:n_pose], dx[ex0:]])
    dl = (b_l - W @ dx_r) / h_safe
    return dx, dl


def linstep(H, b, W, h, b_l, lam, n_pose: int):
    """Fused LM linear step; returns (dx (D,), dl (F,)). `lam` is a 0-dim
    f32 tensor on the device (never read on the host). CPU tensors take the
    plain version; CUDA tensors launch the kernels or raise."""
    D = H.shape[0]
    if not H.is_cuda:
        return linstep_ref(H, b, W, h, b_l, lam, n_pose, D)
    dev = H.device
    F, Dr = W.shape
    if not isinstance(lam, torch.Tensor):
        raise TypeError("linstep: lam must be a device tensor")
    check(H, "H", (D, D), device=dev)
    check(b, "b", (D,), device=dev)
    check(W, "W", (F, Dr), device=dev)
    check(h, "h", (F,), device=dev)
    check(b_l, "b_l", (F,), device=dev)
    check(lam, "lam", (), device=dev)
    if not 0 < n_pose <= Dr <= D:
        raise ValueError(f"linstep: bad layout n_pose={n_pose} Dr={Dr} D={D}")
    smem = (D * (D + 1) // 2 + 3 * D) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"linstep: D={D} needs {smem} B of shared memory > {SMEM_LIMIT}")
    C, c_b = schur._launch(W, h, b_l, lam)
    dx = torch.empty((D,), dtype=torch.float32, device=dev)
    dl = torch.empty((F,), dtype=torch.float32, device=dev)
    launch("isv_linstep_solve", H, b, C, c_b, W, h, b_l, lam, dx, dl,
           D, F, Dr, n_pose, device=dev)
    linstep.launches += 1
    return dx, dl


linstep.launches = 0


def linstep_batched(H, b, W, h, b_l, lam, n_pose: int):
    """The LM linear step of NB sequences at once: H (NB,D,D), b (NB,D),
    W (NB,F,Dr), h and b_l (NB,F), lam (NB,). Returns (dx (NB,D), dl (NB,F)).
    The NB damped systems go to K5's wrapper in f32 (kernel on CUDA tensors,
    plain version on CPU tensors) and to K5's plain version in f64, as the
    f64 solves keep the plain versions of K1 and K2."""
    chol = chol_solve_batched if H.dtype == torch.float32 else chol_solve_batched_ref
    D, Dr = H.shape[-1], W.shape[-1]
    h_d = h * (1.0 + lam[:, None])
    h_safe = torch.where(h_d > 1e-12, h_d, torch.ones_like(h_d))
    C = W.transpose(1, 2) @ (W / h_safe[..., None])
    c_b = (W.transpose(1, 2) @ (b_l / h_safe)[..., None])[..., 0]
    ex0 = D - (Dr - n_pose)
    H_s = H.clone()
    H_s[:, :n_pose, :n_pose] -= C[:, :n_pose, :n_pose]
    H_s[:, :n_pose, ex0:] -= C[:, :n_pose, n_pose:]
    H_s[:, ex0:, :n_pose] -= C[:, n_pose:, :n_pose]
    H_s[:, ex0:, ex0:] -= C[:, n_pose:, n_pose:]
    b_s = b.clone()
    b_s[:, :n_pose] -= c_b[:, :n_pose]
    b_s[:, ex0:] -= c_b[:, n_pose:]
    diagH = torch.clamp(torch.diagonal(H, dim1=1, dim2=2), min=1e-8)
    d = torch.diagonal(H_s, dim1=1, dim2=2)  # a view: damping and jitter in place
    d += lam[:, None] * diagH
    d += 1e-12 * d.sum(dim=1, keepdim=True) / D
    dx = chol(H_s, b_s)
    dx_r = torch.cat([dx[:, :n_pose], dx[:, ex0:]], dim=1)
    dl = (b_l - (W @ dx_r[..., None])[..., 0]) / h_safe
    return dx, dl
