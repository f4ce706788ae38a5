"""IMU preintegration with the 15x15 error-state bias Jacobian and covariance
propagation (torch port of isvins_tpu/factors/preintegration.py).

Math contract: the reference's midpoint scheme (integration_base.h:54–128),
error state [p(0:3), theta(3:6), v(6:9), ba(9:12), bg(12:15)], 18-dim noise
[na0, ng0, na1, ng1, nba, nbg], exact quaternion exponential per step.

Padding convention: steps with dt == 0 are exact no-ops (F = I, V = 0), so a
zero-padded sample buffer integrates exactly its valid prefix.

Batching: every function takes any number of leading batch dims, so one
call integrates all B-1 window segments at once. The JAX `lax.scan` becomes
a split of the recursion into its sequential and its parallel parts:
- the rotation chain dq_k (sequential: one quaternion product per sample);
- everything that depends only on (dq_k, dq_{k+1}) — rotated accelerations,
  the per-step F_k and V_k N V_k^T — computed for all C samples at once;
- dv/dp as cumulative sums of their per-step increments;
- the J <- F J and P <- F P F^T + V N V^T recursions (sequential matmuls).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import (
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_mat,
    right_jacobian_so3,
    skew,
    so3_exp_quat,
)


class ImuNoise(NamedTuple):
    """Continuous-time noise sigmas (python floats)."""

    acc_n: float
    gyr_n: float
    acc_w: float
    gyr_w: float

    @staticmethod
    def from_config(noise_cfg) -> "ImuNoise":
        return ImuNoise(float(noise_cfg.acc_n), float(noise_cfg.gyr_n),
                        float(noise_cfg.acc_w), float(noise_cfg.gyr_w))

    def block_diag18(self, dtype, device=None) -> torch.Tensor:
        d = torch.tensor(
            [self.acc_n ** 2] * 3 + [self.gyr_n ** 2] * 3
            + [self.acc_n ** 2] * 3 + [self.gyr_n ** 2] * 3
            + [self.acc_w ** 2] * 3 + [self.gyr_w ** 2] * 3,
            dtype=dtype, device=device,
        )
        return torch.diag(d)


class Preintegration(NamedTuple):
    """One inter-frame IMU segment integrated at a fixed bias linearization
    point (leading batch dims allowed on every field)."""

    delta_p: torch.Tensor  # (...,3)
    delta_q: torch.Tensor  # (...,4) wxyz
    delta_v: torch.Tensor  # (...,3)
    jac: torch.Tensor  # (...,15,15)
    cov: torch.Tensor  # (...,15,15)
    sum_dt: torch.Tensor  # (...)
    ba: torch.Tensor  # (...,3)
    bg: torch.Tensor  # (...,3)


def integrate_segment(dts, accs, gyrs, acc0, gyr0, ba, bg, noise: ImuNoise) -> Preintegration:
    """dts (...,M) zero-padded tail; accs/gyrs (...,M,3) samples at the END
    of each dt; acc0/gyr0 (...,3) sample at segment start; ba/bg (...,3)
    linearization point."""
    dtype, dev = dts.dtype, dts.device
    M = dts.shape[-1]
    accs, gyrs = accs.to(dtype), gyrs.to(dtype)
    acc0, gyr0 = acc0.to(dtype), gyr0.to(dtype)
    ba, bg = ba.to(dtype), bg.to(dtype)
    batch = dts.shape[:-1]
    N18 = noise.block_diag18(dtype, dev)

    acc_prev = torch.cat([acc0[..., None, :], accs[..., :-1, :]], dim=-2)
    gyr_prev = torch.cat([gyr0[..., None, :], gyrs[..., :-1, :]], dim=-2)
    dt = dts[..., None]  # (...,M,1)
    un_gyr = 0.5 * (gyr_prev + gyrs) - bg[..., None, :]  # (...,M,3)
    step_q = so3_exp_quat(un_gyr * dt)

    # rotation chain: dq[k] before step k, dq[k+1] after it
    qs = [torch.zeros(batch + (4,), dtype=dtype, device=dev)]
    qs[0][..., 0] = 1.0
    for k in range(M):
        qs.append(quat_normalize(quat_mul(qs[-1], step_q[..., k, :])))
    dq_all = torch.stack(qs, dim=-2)  # (...,M+1,4)
    q0, q1 = dq_all[..., :-1, :], dq_all[..., 1:, :]

    a0b = acc_prev - ba[..., None, :]
    a1b = accs - ba[..., None, :]
    un_acc = 0.5 * (quat_rotate(q0, a0b) + quat_rotate(q1, a1b))
    dv_inc = un_acc * dt
    dv_after = torch.cumsum(dv_inc, dim=-2)
    dv_before = dv_after - dv_inc
    dp = torch.sum(dv_before * dt + 0.5 * un_acc * dt * dt, dim=-2)
    dv = dv_after[..., -1, :]

    # per-step F_k (15x15) and V_k (15x18), all samples at once
    R0 = quat_to_mat(q0)
    R1 = quat_to_mat(q1)
    Wx = skew(un_gyr)
    A0x = skew(a0b)
    A1x = skew(a1b)
    I3 = torch.eye(3, dtype=dtype, device=dev).expand(R0.shape)
    d1 = dt[..., None]  # (...,M,1,1)
    d2 = d1 * d1
    R1A1 = R1 @ A1x
    ImW = I3 - Wx * d1
    R0A0 = R0 @ A0x
    R1A1ImW = R1A1 @ ImW

    F = torch.zeros(batch + (M, 15, 15), dtype=dtype, device=dev)
    F[..., 0:3, 0:3] = I3
    F[..., 0:3, 3:6] = -0.25 * R0A0 * d2 - 0.25 * R1A1ImW * d2
    F[..., 0:3, 6:9] = I3 * d1
    F[..., 0:3, 9:12] = -0.25 * (R0 + R1) * d2
    F[..., 0:3, 12:15] = 0.25 * R1A1 * d2 * d1
    F[..., 3:6, 3:6] = ImW
    F[..., 3:6, 12:15] = -I3 * d1
    F[..., 6:9, 3:6] = -0.5 * R0A0 * d1 - 0.5 * R1A1ImW * d1
    F[..., 6:9, 6:9] = I3
    F[..., 6:9, 9:12] = -0.5 * (R0 + R1) * d1
    F[..., 6:9, 12:15] = 0.5 * R1A1 * d2
    F[..., 9:12, 9:12] = I3
    F[..., 12:15, 12:15] = I3

    V = torch.zeros(batch + (M, 15, 18), dtype=dtype, device=dev)
    V[..., 0:3, 0:3] = 0.25 * R0 * d2
    v03 = -0.125 * R1A1 * d2 * d1
    V[..., 0:3, 3:6] = v03
    V[..., 0:3, 6:9] = 0.25 * R1 * d2
    V[..., 0:3, 9:12] = v03
    V[..., 3:6, 3:6] = 0.5 * I3 * d1
    V[..., 3:6, 9:12] = 0.5 * I3 * d1
    V[..., 6:9, 0:3] = 0.5 * R0 * d1
    v63 = -0.25 * R1A1 * d2
    V[..., 6:9, 3:6] = v63
    V[..., 6:9, 6:9] = 0.5 * R1 * d1
    V[..., 6:9, 9:12] = v63
    V[..., 9:12, 12:15] = I3 * d1
    V[..., 12:15, 15:18] = I3 * d1
    VNV = V @ N18 @ V.transpose(-1, -2)

    J = torch.eye(15, dtype=dtype, device=dev).expand(batch + (15, 15))
    P = torch.zeros(batch + (15, 15), dtype=dtype, device=dev)
    for k in range(M):
        Fk = F[..., k, :, :]
        J = Fk @ J
        P = Fk @ P @ Fk.transpose(-1, -2) + VNV[..., k, :, :]
    return Preintegration(dp, dq_all[..., -1, :].contiguous(), dv, J, P,
                          torch.sum(dts, dim=-1), ba, bg)


def bias_corrected_delta(pre: Preintegration, Bai, Bgi):
    """First-order bias correction of (dp, dq, dv) (integration_base.h:173–178)."""
    dba = (Bai - pre.ba)[..., None]
    dbg = (Bgi - pre.bg)[..., None]
    J = pre.jac
    dp = pre.delta_p + (J[..., 0:3, 9:12] @ dba + J[..., 0:3, 12:15] @ dbg)[..., 0]
    dq = quat_normalize(quat_mul(pre.delta_q, so3_exp_quat((J[..., 3:6, 12:15] @ dbg)[..., 0])))
    dv = pre.delta_v + (J[..., 6:9, 9:12] @ dba + J[..., 6:9, 12:15] @ dbg)[..., 0]
    return dp, dq, dv


def imu_residual(pre: Preintegration, G, Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj):
    """Unweighted 15-residual (integration_base.h:160–186)."""
    dp, dq, dv = bias_corrected_delta(pre, Bai, Bgi)
    dt = pre.sum_dt[..., None]
    Qi_inv = quat_conj(Qi)
    r_p = quat_rotate(Qi_inv, 0.5 * G * dt * dt + Pj - Pi - Vi * dt) - dp
    r_q = 2.0 * quat_mul(quat_conj(dq), quat_mul(Qi_inv, Qj))[..., 1:4]
    r_v = quat_rotate(Qi_inv, G * dt + Vj - Vi) - dv
    return torch.cat([r_p, r_q, r_v, Baj - Bai, Bgj - Bgi], dim=-1)


def _qleft(q):
    """Utility::Qleft — (...,4,4) left-multiplication matrix (wxyz)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([w, -x, -y, -z], -1),
        torch.stack([x, w, -z, y], -1),
        torch.stack([y, z, w, -x], -1),
        torch.stack([z, -y, x, w], -1),
    ], -2)


def _qright(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([w, -x, -y, -z], -1),
        torch.stack([x, w, z, -y], -1),
        torch.stack([y, -z, w, x], -1),
        torch.stack([z, y, -x, w], -1),
    ], -2)


def imu_residual_jacobians(pre: Preintegration, G, Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj):
    """Residual + minimal-coordinate Jacobians wrt (pose_i[6], vb_i[9],
    pose_j[6], vb_j[9]); right-perturbation q -> q*Exp(dtheta)
    (imu_factor.h:161–265, unweighted). Batched over leading dims."""
    r = imu_residual(pre, G, Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj)
    dt = pre.sum_dt[..., None, None]
    dtv = pre.sum_dt[..., None]
    Ri_T = quat_to_mat(Qi).transpose(-1, -2)
    J = pre.jac
    dq_dbg = J[..., 3:6, 12:15]
    dp_dba = J[..., 0:3, 9:12]
    dp_dbg = J[..., 0:3, 12:15]
    dv_dba = J[..., 6:9, 9:12]
    dv_dbg = J[..., 6:9, 12:15]

    a_corr = (dq_dbg @ (Bgi - pre.bg)[..., None])[..., 0]
    corr_dq = quat_normalize(quat_mul(pre.delta_q, so3_exp_quat(a_corr)))
    Qj_inv_Qi = quat_mul(quat_conj(Qj), Qi)
    Qi_inv = quat_conj(Qi)
    I3 = torch.eye(3, dtype=Pi.dtype, device=Pi.device).expand(Ri_T.shape)
    shape = r.shape[:-1]
    z = lambda c: torch.zeros(shape + (15, c), dtype=Pi.dtype, device=Pi.device)

    J_pi = z(6)
    J_pi[..., 0:3, 0:3] = -Ri_T
    J_pi[..., 0:3, 3:6] = skew(quat_rotate(Qi_inv, 0.5 * G * dtv * dtv + Pj - Pi - Vi * dtv))
    J_pi[..., 3:6, 3:6] = -(_qleft(Qj_inv_Qi) @ _qright(corr_dq))[..., 1:4, 1:4]
    J_pi[..., 6:9, 3:6] = skew(quat_rotate(Qi_inv, G * dtv + Vj - Vi))

    # exact bias-correction block (see the JAX reference's note)
    J_q_bg = -_qleft(quat_mul(Qj_inv_Qi, corr_dq))[..., 1:4, 1:4] @ right_jacobian_so3(a_corr) @ dq_dbg
    J_vbi = z(9)
    J_vbi[..., 0:3, 0:3] = -Ri_T * dt
    J_vbi[..., 0:3, 3:6] = -dp_dba
    J_vbi[..., 0:3, 6:9] = -dp_dbg
    J_vbi[..., 3:6, 6:9] = J_q_bg
    J_vbi[..., 6:9, 0:3] = -Ri_T
    J_vbi[..., 6:9, 3:6] = -dv_dba
    J_vbi[..., 6:9, 6:9] = -dv_dbg
    J_vbi[..., 9:12, 3:6] = -I3
    J_vbi[..., 12:15, 6:9] = -I3

    J_pj = z(6)
    J_pj[..., 0:3, 0:3] = Ri_T
    J_pj[..., 3:6, 3:6] = _qleft(quat_mul(quat_conj(corr_dq), quat_mul(Qi_inv, Qj)))[..., 1:4, 1:4]

    J_vbj = z(9)
    J_vbj[..., 6:9, 0:3] = Ri_T
    J_vbj[..., 9:12, 3:6] = I3
    J_vbj[..., 12:15, 6:9] = I3
    return r, J_pi, J_vbi, J_pj, J_vbj


def cholesky_nan(A):
    """Lower Cholesky factor that is NaN (not an exception) where A is not
    positive definite — the semantics of jnp.linalg.cholesky, and free of
    the host sync that torch.linalg.cholesky's error check costs on CUDA."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info > 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def sqrt_info_from_cov(cov, rel_jitter: float = 0.0):
    """S with S^T S = cov^{-1}, S = chol(cov)^{-1}; batched over leading
    dims. rel_jitter is relative to mean(diag(cov))."""
    n = cov.shape[-1]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    covs = 0.5 * (cov + cov.transpose(-1, -2))
    scale = torch.diagonal(covs, dim1=-2, dim2=-1).sum(-1)[..., None, None] / n
    covr = covs + (rel_jitter * scale + torch.finfo(cov.dtype).tiny) * eye
    C = cholesky_nan(covr)
    return torch.linalg.solve_triangular(C, eye.expand(covr.shape), upper=False)
