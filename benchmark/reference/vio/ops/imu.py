"""K2's plain version (frozen copy of isvins_tpu_torch/ops/imu.py's
imu_rows_ref); `imu_rows` is it."""

from __future__ import annotations

import torch

from ..factors.preintegration import Preintegration, imu_residual_jacobians
from . import seq_rows


def imu_rows_ref(Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj,
                 dP, dQ, dV, sum_dt, ba0, bg0, jac, G):
    if G.dim() == 2:
        G = G.repeat_interleave(seq_rows(Pi.shape[0], G, "G"), 0)
    pre = Preintegration(dP, dQ, dV, jac, torch.zeros_like(jac), sum_dt, ba0, bg0)
    r, J_pi, J_vbi, J_pj, J_vbj = imu_residual_jacobians(
        pre, G, Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj)
    return r, torch.cat([J_pi, J_vbi, J_pj, J_vbj], dim=-1)


imu_rows = imu_rows_ref
