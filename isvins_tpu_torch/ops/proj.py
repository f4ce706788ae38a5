"""K1: fused projection-factor evaluation (csrc/proj_rows.cu).

Replaces isvins_tpu/ops/proj_pallas.py::proj_rows_pallas. The plain version
proj_rows_ref is solver/proj_fast.eval_proj_rows with one extrinsic per
sequence of rows.
"""

from __future__ import annotations

import torch

from ..solver.proj_fast import eval_proj_rows
from ._lib import check, launch, seq_rows


def proj_rows_ref(pts_i, pts_j, Pi, Qi, Pj, Qj, tic, qic, dep, valid):
    """proj_rows' plain version, with its signature and returns."""
    if tic.dim() == 2:
        rows = seq_rows(pts_i.shape[0], tic, "tic")
        tic, qic = tic.repeat_interleave(rows, 0), qic.repeat_interleave(rows, 0)
    return eval_proj_rows(pts_i, pts_j, Pi, Qi, Pj, Qj, tic, qic, dep, valid)


def proj_rows(pts_i, pts_j, Pi, Qi, Pj, Qj, tic, qic, dep, valid):
    """(r (N,2), J_pi (N,2,6), J_pj (N,2,6), J_dep (N,2)), unweighted, f32.
    tic (3,) and qic (4,) serve all rows; (S,3) and (S,4) serve S sequences
    of N/S rows each, laid end to end (the batched solve).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise (f32 only, contiguous, one device)."""
    if not pts_i.is_cuda:
        return proj_rows_ref(pts_i, pts_j, Pi, Qi, Pj, Qj, tic, qic, dep, valid)
    N = pts_i.shape[0]
    rows = seq_rows(N, tic, "tic")
    dev = pts_i.device
    for t, name, shape in ((pts_i, "pts_i", (N, 3)), (pts_j, "pts_j", (N, 3)),
                           (Pi, "Pi", (N, 3)), (Qi, "Qi", (N, 4)), (Pj, "Pj", (N, 3)),
                           (Qj, "Qj", (N, 4)), (tic, "tic", tic.shape[:-1] + (3,)),
                           (qic, "qic", tic.shape[:-1] + (4,)), (dep, "dep", (N,))):
        check(t, name, shape, device=dev)
    check(valid, "valid", (N,), torch.bool, dev)
    kw = dict(dtype=torch.float32, device=dev)
    r = torch.empty((N, 2), **kw)
    J_pi = torch.empty((N, 2, 6), **kw)
    J_pj = torch.empty((N, 2, 6), **kw)
    J_dep = torch.empty((N, 2), **kw)
    if N == 0:
        return r, J_pi, J_pj, J_dep
    launch("isv_proj_rows", pts_i, pts_j, Pi, Qi, Pj, Qj, tic, qic, dep, valid,
           r, J_pi, J_pj, J_dep, N, rows, device=dev)
    proj_rows.launches += 1
    return r, J_pi, J_pj, J_dep


proj_rows.launches = 0
