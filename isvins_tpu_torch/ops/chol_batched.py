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
    """The layout of one system of D unknowns: the lower triangle as
    `tiles` tiles of nb x nb floats, D padded to Dp with the identity, then
    two Dp-vectors and CHOL_MISC floats. On the shared route
    (`scratch_floats` 0) all of it lives in one block's shared memory,
    `smem_bytes`; on the global route the tiles live in a device-memory
    scratch of `scratch_floats` floats per problem and shared memory holds
    the vectors alone."""

    nb: int
    Dp: int
    tiles: int  # T (T + 1) / 2 lower-triangle tiles, T = Dp / nb
    smem_bytes: int
    scratch_floats: int

    @property
    def route(self) -> str:
        return "global" if self.scratch_floats else "shared"


@lru_cache(maxsize=64)
def chol_plan(D: int) -> CholPlan:
    """The layout of csrc/chol.cuh chol_plan, from the same constants."""
    T = -(-D // CHOL_NB)
    tiles = T * (T + 1) // 2
    vectors = (2 * T * CHOL_NB + CHOL_MISC) * 4
    tile_bytes = tiles * CHOL_NB * CHOL_NB * 4
    if tile_bytes + vectors <= SMEM_LIMIT:
        return CholPlan(CHOL_NB, T * CHOL_NB, tiles, tile_bytes + vectors, 0)
    return CholPlan(CHOL_NB, T * CHOL_NB, tiles, vectors, tiles * CHOL_NB * CHOL_NB)


def chol_max_dim() -> int:
    """The largest D whose tiles fit one block's shared memory (the shared
    route); every D above takes the global route."""
    D = CHOL_NB
    while chol_plan(D + CHOL_NB).route == "shared":
        D += CHOL_NB
    return D


def checked_plan(D: int, name: str) -> CholPlan:
    """chol_plan(D); raises only where even the global route cannot run:
    its vectors must fit shared memory (D up to 29,024), and its scratch
    (`scratch_floats` floats per problem) is allocated by the caller."""
    plan = chol_plan(D)
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"{name}: D={D} needs {plan.scratch_floats * 4} B of device-memory "
                         f"scratch per problem and {plan.smem_bytes} B of shared memory for its "
                         f"vectors > {SMEM_LIMIT}")
    return plan


def chol_scratch(plan: CholPlan, NB: int, device):
    """The device-memory scratch of NB problems on the global route; None on
    the shared route (nothing to allocate)."""
    if plan.route == "shared":
        return None
    return torch.empty((NB, plan.scratch_floats), dtype=torch.float32, device=device)


def chol_solve_batched_ref(H_dd, b_s):
    """x (NB, D) with H_dd[n] x[n] = b_s[n]; H_dd (NB, D, D) SPD."""
    return torch.cholesky_solve(b_s[..., None], cholesky_nan(H_dd))[..., 0]


def chol_solve_batched(H_dd, b_s):
    """Kernel wrapper with chol_solve_batched_ref's signature and return: one
    thread block per problem, the blocked routine of csrc/chol.cuh in the
    layout of chol_plan (its tiles in shared memory up to D = 320, in a
    scratch allocated here above). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise (f32, contiguous)."""
    if not H_dd.is_cuda:
        return chol_solve_batched_ref(H_dd, b_s)
    dev = H_dd.device
    if H_dd.dim() != 3:
        raise ValueError(f"H_dd: shape {tuple(H_dd.shape)} is not (NB, D, D)")
    NB, D = H_dd.shape[0], H_dd.shape[1]
    check(H_dd, "H_dd", (NB, D, D), device=dev)
    check(b_s, "b_s", (NB, D), device=dev)
    plan = checked_plan(D, "chol_solve_batched")
    x = torch.empty((NB, D), dtype=torch.float32, device=dev)
    if NB == 0:
        return x
    launch("isv_chol_solve_batched", H_dd, b_s, x, chol_scratch(plan, NB, dev), NB, D,
           device=dev)
    chol_solve_batched.launches += 1
    return x


chol_solve_batched.launches = 0
