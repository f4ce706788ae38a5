"""K1's plain version (frozen copy of isvins_tpu_torch/ops/proj.py's
proj_rows_ref); `proj_rows` is it."""

from __future__ import annotations

from ..solver.proj_fast import eval_proj_rows
from . import seq_rows


def proj_rows_ref(pts_i, pts_j, Pi, Qi, Pj, Qj, tic, qic, dep, valid):
    if tic.dim() == 2:
        rows = seq_rows(pts_i.shape[0], tic, "tic")
        tic, qic = tic.repeat_interleave(rows, 0), qic.repeat_interleave(rows, 0)
    return eval_proj_rows(pts_i, pts_j, Pi, Qi, Pj, Qj, tic, qic, dep, valid)


proj_rows = proj_rows_ref
