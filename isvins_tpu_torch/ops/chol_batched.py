"""K5: batched dense SPD solve (csrc/chol_batched.cu).

Replaces isvins_tpu/ops/linstep_pallas.py::chol_solve_batched_pallas, the
factorization and triangular solves of the multi-sequence LM step
(ops/linstep.linstep_batched). The plain version is chol_solve_batched_ref.
A matrix that is not SPD yields a NaN row in both (the Pallas body clamps
the pivot instead), so the LM accept test rejects that sequence's step.
"""

from __future__ import annotations

import torch

from ..factors.preintegration import cholesky_nan
from ._lib import SMEM_LIMIT, check, launch


def chol_solve_batched_ref(H_dd, b_s):
    """x (NB, D) with H_dd[n] x[n] = b_s[n]; H_dd (NB, D, D) SPD."""
    return torch.cholesky_solve(b_s[..., None], cholesky_nan(H_dd))[..., 0]


def chol_solve_batched(H_dd, b_s):
    """Kernel wrapper with chol_solve_batched_ref's signature and return: one
    thread block per problem. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise (f32, contiguous)."""
    if not H_dd.is_cuda:
        return chol_solve_batched_ref(H_dd, b_s)
    dev = H_dd.device
    if H_dd.dim() != 3:
        raise ValueError(f"H_dd: shape {tuple(H_dd.shape)} is not (NB, D, D)")
    NB, D = H_dd.shape[0], H_dd.shape[1]
    check(H_dd, "H_dd", (NB, D, D), device=dev)
    check(b_s, "b_s", (NB, D), device=dev)
    smem = (D * (D + 1) // 2 + 3 * D) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"chol_solve_batched: D={D} needs {smem} B of shared memory "
                         f"> {SMEM_LIMIT}")
    x = torch.empty((NB, D), dtype=torch.float32, device=dev)
    if NB == 0:
        return x
    launch("isv_chol_solve_batched", H_dd, b_s, x, NB, D, device=dev)
    chol_solve_batched.launches += 1
    return x


chol_solve_batched.launches = 0
