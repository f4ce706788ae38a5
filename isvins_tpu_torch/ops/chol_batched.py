"""K5: batched dense SPD solve (csrc/chol_batched.cu), and the layout of the
blocked Cholesky routine (csrc/chol.cuh) that K5 and K4 share: chol_plan.

K5 replaces isvins_tpu/ops/linstep_pallas.py::chol_solve_batched_pallas,
the factorization and triangular solves of the multi-sequence LM step
(ops/linstep.linstep_batched). The plain version is chol_solve_batched_ref.
A matrix that is not SPD yields a NaN row in both (the Pallas body clamps
the pivot instead), so the LM accept test rejects that sequence's step.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from ..factors.preintegration import cholesky_nan
from ._lib import SMEM_LIMIT, check, launch

CHOL_NB = 16  # tile edge of the factorization (CHOL_NB of csrc/chol.cuh)
CHOL_MISC = 64  # floats of shared memory after the tiles and vectors (CHOL_MISC of chol.cuh)


class CholPlan(NamedTuple):
    """The shared-memory layout of one system of D unknowns: the lower
    triangle as `tiles` tiles of nb x nb floats, D padded to Dp with the
    identity, then two Dp-vectors and CHOL_MISC floats."""

    nb: int
    Dp: int
    tiles: int  # T (T + 1) / 2 lower-triangle tiles, T = Dp / nb
    smem_bytes: int


@lru_cache(maxsize=64)
def chol_plan(D: int) -> CholPlan:
    """The layout of csrc/chol.cuh chol_plan, from the same constants."""
    T = -(-D // CHOL_NB)
    tiles = T * (T + 1) // 2
    return CholPlan(CHOL_NB, T * CHOL_NB, tiles,
                    (tiles * CHOL_NB * CHOL_NB + 2 * T * CHOL_NB + CHOL_MISC) * 4)


def chol_max_dim() -> int:
    """The largest D whose layout fits one block's shared memory."""
    D = CHOL_NB
    while chol_plan(D + CHOL_NB).smem_bytes <= SMEM_LIMIT:
        D += CHOL_NB
    return D


def checked_plan(D: int, name: str) -> CholPlan:
    """chol_plan(D); raises where it does not fit one block."""
    plan = chol_plan(D)
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"{name}: D={D} needs {plan.smem_bytes} B of shared memory > "
                         f"{SMEM_LIMIT}; the tiles take D <= {chol_max_dim()}")
    return plan


def chol_solve_batched_ref(H_dd, b_s):
    """x (NB, D) with H_dd[n] x[n] = b_s[n]; H_dd (NB, D, D) SPD."""
    return torch.cholesky_solve(b_s[..., None], cholesky_nan(H_dd))[..., 0]


def chol_solve_batched(H_dd, b_s):
    """Kernel wrapper with chol_solve_batched_ref's signature and return: one
    thread block per problem, the blocked routine of csrc/chol.cuh in the
    layout of chol_plan. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise (f32, contiguous)."""
    if not H_dd.is_cuda:
        return chol_solve_batched_ref(H_dd, b_s)
    dev = H_dd.device
    if H_dd.dim() != 3:
        raise ValueError(f"H_dd: shape {tuple(H_dd.shape)} is not (NB, D, D)")
    NB, D = H_dd.shape[0], H_dd.shape[1]
    check(H_dd, "H_dd", (NB, D, D), device=dev)
    check(b_s, "b_s", (NB, D), device=dev)
    checked_plan(D, "chol_solve_batched")
    x = torch.empty((NB, D), dtype=torch.float32, device=dev)
    if NB == 0:
        return x
    launch("isv_chol_solve_batched", H_dd, b_s, x, NB, D, device=dev)
    chol_solve_batched.launches += 1
    return x


chol_solve_batched.launches = 0
