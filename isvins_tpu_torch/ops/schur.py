"""K3: landmark Schur correction (csrc/schur_corr.cu) and K7: the full
Schur reduction (csrc/schur_reduce.cu); both run the tile routine of
csrc/schur_tile.cuh on the decomposition that schur_plan chooses here.

K3 replaces isvins_tpu/ops/schur_pallas.py::schur_corr_pallas; its plain
version is schur_corr_ref. K3 is also the first launch of K4 (ops/linstep).
K7 replaces schur_reduce_pallas of the same file; its plain version is
schur_reduce_ref. Nothing in the package calls K7, as nothing in the JAX
package calls its kernel: the solver eliminates landmarks in the reduced
layout (K3/K4, or the batched step's einsum).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from ._lib import check, launch

CHUNK_ROWS = 32  # rows of W per staged chunk (SCHUR_FK of csrc/schur_tile.cuh)
MAX_SPLITS = 16  # the largest thread block cluster of an H100 (8 is the portable size)
SM_COUNT = 132  # H100
BLOCKS_PER_SM = 3  # blocks of a launch per SM beyond which F is split no further


class SchurPlan(NamedTuple):
    """How W^T diag(1/h) [W | b_l] with W (F, n) is cut into thread blocks.

    The n x n product is covered by square tiles on or below the diagonal
    (the epilogue mirrors them), numbered row by row, followed by one tile
    per row tile for the extra column where there is one. The F rows of
    every tile are split over `splits` blocks, which form one cluster and
    sum their partial tiles in rank order."""

    tile: int  # tile edge: 32 or 64
    splits: int  # blocks per tile = cluster size: a power of two <= 16
    rows_per_split: int  # rows of F per block (the last may have fewer)
    n_row_tiles: int
    n_tiles: int  # lower-triangle tiles + extra-column tiles
    grid: int  # blocks in the launch: n_tiles * splits
    copy_bytes: int  # width of one cp.async from a row of W: 4, 8 or 16

    def tile_at(self, t: int):
        """(ti, tj) of tile number t; tj is None for an extra-column tile."""
        n_lower = self.n_row_tiles * (self.n_row_tiles + 1) // 2
        if t >= n_lower:
            return t - n_lower, None
        ti = 0
        while (ti + 1) * (ti + 2) // 2 <= t:
            ti += 1
        return ti, t - ti * (ti + 1) // 2

    def rows(self, rank: int, F: int):
        """The rows [lo, hi) of F that block `rank` of a cluster sums."""
        lo = min(rank * self.rows_per_split, F)
        return lo, min(lo + self.rows_per_split, F)


@lru_cache(maxsize=64)  # a few shapes per process; the plan is an immutable tuple
def schur_plan(F: int, n: int, extra_col: bool, align: int = 16) -> SchurPlan:
    """The decomposition for W (F, n), from the shapes and the alignment of
    W's first element in bytes, never from the data.

    A row of W is n * 4 bytes, so a 16-byte copy is legal only when n is a
    multiple of 4 and W is 16-byte aligned, an 8-byte copy when n is even:
    n = 276 takes 16, n = 114 (456-byte rows) takes 8, an odd n takes 4.
    The split count is the largest power of two that leaves every block at
    least one chunk of rows and the launch within BLOCKS_PER_SM blocks per SM
    (a block takes up to 64.5 KB of shared memory and 256 threads: three fit)."""
    if F < 1 or n < 1:
        raise ValueError(f"schur_plan: F={F}, n={n} must be positive")
    tile = 64 if n > 128 else 32
    n_row_tiles = -(-n // tile)
    n_tiles = n_row_tiles * (n_row_tiles + 1) // 2 + (n_row_tiles if extra_col else 0)
    splits = 1
    while (splits < MAX_SPLITS and 2 * splits * CHUNK_ROWS <= F
           and 2 * splits * n_tiles <= BLOCKS_PER_SM * SM_COUNT):
        splits *= 2
    copy_bytes = 4
    for width in (16, 8):
        if (n * 4) % width == 0 and align % width == 0:
            copy_bytes = width
            break
    return SchurPlan(tile, splits, -(-F // splits), n_row_tiles, n_tiles, n_tiles * splits,
                     copy_bytes)


def _alignment(t: torch.Tensor) -> int:
    """The largest of 16, 8, 4 bytes that divides t's address."""
    return next(a for a in (16, 8, 4) if t.data_ptr() % a == 0)


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
    plan = schur_plan(F, Dr, True, _alignment(W))
    C = torch.empty((Dr, Dr), dtype=torch.float32, device=dev)
    c_b = torch.empty((Dr,), dtype=torch.float32, device=dev)
    launch("isv_schur_corr", W, h, b_l, lam, C, c_b, F, Dr, plan.tile, plan.splits,
           plan.n_tiles, plan.copy_bytes, device=dev)
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
    """Kernel wrapper with schur_reduce_ref's signature and returns: one
    launch forms H_s and, as the product's extra column, b_s. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
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
    plan = schur_plan(F, D, True, _alignment(W))
    H_s = torch.empty((D, D), dtype=torch.float32, device=dev)
    b_s = torch.empty((D,), dtype=torch.float32, device=dev)
    launch("isv_schur_reduce", H, b, W, h, b_l, H_s, b_s, F, D, plan.tile, plan.splits,
           plan.n_tiles, plan.copy_bytes, device=dev)
    schur_reduce.launches += 1
    return H_s, b_s


schur_reduce.launches = 0
