"""K2: fused IMU-factor evaluation (csrc/imu_rows.cu).

Replaces isvins_tpu/ops/imu_pallas.py::imu_rows_pallas. The plain version
imu_rows_ref is factors.preintegration.imu_residual_jacobians batched over
the factors (the JAX package's `_imu_rows_ref`).
"""

from __future__ import annotations

import torch

from ..factors.preintegration import Preintegration, imu_residual_jacobians
from ._lib import check, launch, seq_rows


def imu_rows_ref(Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj,
                 dP, dQ, dV, sum_dt, ba0, bg0, jac, G):
    """(r (n,15), Jcat (n,15,30)) unweighted; Jcat columns
    [pose_i | vb_i | pose_j | vb_j]. G (3,) serves all factors; (S,3)
    serves S sequences of n/S factors each, laid end to end."""
    if G.dim() == 2:
        G = G.repeat_interleave(seq_rows(Pi.shape[0], G, "G"), 0)
    pre = Preintegration(dP, dQ, dV, jac, torch.zeros_like(jac), sum_dt, ba0, bg0)
    r, J_pi, J_vbi, J_pj, J_vbj = imu_residual_jacobians(
        pre, G, Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj)
    return r, torch.cat([J_pi, J_vbi, J_pj, J_vbj], dim=-1)


def imu_rows(Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj,
             dP, dQ, dV, sum_dt, ba0, bg0, jac, G):
    """Kernel wrapper with imu_rows_ref's signature and returns. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if not Pi.is_cuda:
        return imu_rows_ref(Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj,
                            dP, dQ, dV, sum_dt, ba0, bg0, jac, G)
    dev = Pi.device
    n = Pi.shape[0]
    rows = seq_rows(n, G, "G")
    for t, name, shape in ((Pi, "Pi", (n, 3)), (Qi, "Qi", (n, 4)), (Vi, "Vi", (n, 3)),
                           (Bai, "Bai", (n, 3)), (Bgi, "Bgi", (n, 3)), (Pj, "Pj", (n, 3)),
                           (Qj, "Qj", (n, 4)), (Vj, "Vj", (n, 3)), (Baj, "Baj", (n, 3)),
                           (Bgj, "Bgj", (n, 3)), (dP, "dP", (n, 3)), (dQ, "dQ", (n, 4)),
                           (dV, "dV", (n, 3)), (sum_dt, "sum_dt", (n,)),
                           (ba0, "ba0", (n, 3)), (bg0, "bg0", (n, 3)),
                           (jac, "jac", (n, 15, 15)), (G, "G", G.shape[:-1] + (3,))):
        check(t, name, shape, device=dev)
    r = torch.empty((n, 15), dtype=torch.float32, device=dev)
    Jcat = torch.empty((n, 15, 30), dtype=torch.float32, device=dev)
    if n == 0:
        return r, Jcat
    launch("isv_imu_rows", Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj,
           dP, dQ, dV, sum_dt, ba0, bg0, jac, G, r, Jcat, n, rows, device=dev)
    imu_rows.launches += 1
    return r, Jcat


imu_rows.launches = 0
