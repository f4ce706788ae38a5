// K2 imu_rows: fused IMU-factor evaluation.
//
// Replaces isvins_tpu/ops/imu_pallas.py::imu_rows_pallas (Pallas body
// _imu_kernel). Plain version: isvins_tpu_torch/ops/imu.py imu_rows_ref
// (factors/preintegration.imu_residual_jacobians batched over factors).
//
// Per factor k (frames k -> k+1): the bias-corrected preintegrated deltas,
// the unweighted 15-residual and the 15x30 Jacobian, columns
// [pose_i(6) | vb_i(9) | pose_j(6) | vb_j(9)]. Whitening stays outside.
//
// What bounds it on the H100: launch latency. The window has n = B-1 = 17
// factors (S * 17 when S sequences are evaluated in one launch), ~1.5k
// flops and 2 KB of output each, so the whole call is a few microseconds.
// Design: one thread per factor, a warp per block so that a batch spreads
// over the SMs, nothing shared between threads. The 465
// outputs of a factor are written straight to global memory as they are
// formed (the 15x30 block is zero-filled first, then its non-zero 3x3
// blocks are stored) so the thread never holds them in registers; the
// quaternion and 3x3 algebra of the reference's component form stays in
// registers. The small-angle branches of _qnorm, so3 exp and the right
// Jacobian follow imu_pallas.py:137-160.
#include "common.cuh"

__device__ __forceinline__ void m33mul(const float* a, const float* b, float* o) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      o[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}

__device__ __forceinline__ V3 m33vec(const float* M, V3 v) {
  return V3{M[0] * v.x + M[1] * v.y + M[2] * v.z, M[3] * v.x + M[4] * v.y + M[5] * v.z,
            M[6] * v.x + M[7] * v.y + M[8] * v.z};
}

__device__ __forceinline__ void skew3(V3 v, float* o) {
  o[0] = 0.0f; o[1] = -v.z; o[2] = v.y;
  o[3] = v.z; o[4] = 0.0f; o[5] = -v.x;
  o[6] = -v.y; o[7] = v.x; o[8] = 0.0f;
}

__device__ __forceinline__ Q4 qnorm(Q4 q) {
  float n = sqrtf(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  n = fmaxf(n, 1e-12f);
  float s = (q.w < 0.0f ? -1.0f : 1.0f) / n;
  return Q4{q.w * s, q.x * s, q.y * s, q.z * s};
}

__device__ __forceinline__ Q4 so3_exp_quat(V3 p) {
  float t2 = p.x * p.x + p.y * p.y + p.z * p.z;
  bool small = t2 < 1e-8f;
  float t = sqrtf(fmaxf(t2, 1e-24f));
  float k = small ? 0.5f - t2 / 48.0f : sinf(t * 0.5f) / t;
  float w = small ? 1.0f - t2 / 8.0f : cosf(t * 0.5f);
  return Q4{w, k * p.x, k * p.y, k * p.z};
}

__device__ __forceinline__ void right_jacobian(V3 p, float* o) {
  float t2 = p.x * p.x + p.y * p.y + p.z * p.z;
  bool small = t2 < 1e-8f;
  float t2s = fmaxf(t2, 1e-24f);
  float t = sqrtf(t2s);
  float c1 = small ? 0.5f - t2 / 24.0f : (1.0f - cosf(t)) / t2s;
  float c2 = small ? 1.0f / 6.0f - t2 / 120.0f : (t - sinf(t)) / (t2s * t);
  float W[9], W2[9];
  skew3(p, W);
  m33mul(W, W, W2);
  for (int k = 0; k < 9; ++k) o[k] = ((k % 4) == 0 ? 1.0f : 0.0f) - c1 * W[k] + c2 * W2[k];
}

// (Qleft(a) Qright(b))[1:4, 1:4]
__device__ __forceinline__ void qlqr3(Q4 a, Q4 b, float* o) {
  const float QL[3][4] = {{a.x, a.w, -a.z, a.y}, {a.y, a.z, a.w, -a.x}, {a.z, -a.y, a.x, a.w}};
  const float QR[3][4] = {{-b.x, b.w, -b.z, b.y}, {-b.y, b.z, b.w, -b.x}, {-b.z, -b.y, b.x, b.w}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      o[3 * i + j] = QL[i][0] * QR[j][0] + QL[i][1] * QR[j][1] + QL[i][2] * QR[j][2] +
                     QL[i][3] * QR[j][3];
}

// Qleft(q)[1:4, 1:4] = w I + skew(v)
__device__ __forceinline__ void ql3(Q4 q, float* o) {
  o[0] = q.w; o[1] = -q.z; o[2] = q.y;
  o[3] = q.z; o[4] = q.w; o[5] = -q.x;
  o[6] = -q.y; o[7] = q.x; o[8] = q.w;
}

__device__ __forceinline__ V3 ld3(const float* p, int k) {
  return V3{p[3 * k], p[3 * k + 1], p[3 * k + 2]};
}

__device__ __forceinline__ Q4 ld4(const float* p, int k) {
  return Q4{p[4 * k], p[4 * k + 1], p[4 * k + 2], p[4 * k + 3]};
}

// jac[k, r0:r0+3, c0:c0+3] row-major
__device__ __forceinline__ void jblk(const float* jac, int k, int r0, int c0, float* o) {
  const float* J = jac + 225 * k;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) o[3 * i + j] = J[(r0 + i) * 15 + c0 + j];
}

// out[r0:r0+3, c0:c0+3] = sign * scale * M in the (15, 30) row-major block
__device__ __forceinline__ void put33(float* out, int r0, int c0, const float* M, float scale) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[(r0 + i) * 30 + c0 + j] = scale * M[3 * i + j];
}

__global__ void imu_rows_kernel(const float* __restrict__ Pi_, const float* __restrict__ Qi_,
                                const float* __restrict__ Vi_, const float* __restrict__ Bai_,
                                const float* __restrict__ Bgi_, const float* __restrict__ Pj_,
                                const float* __restrict__ Qj_, const float* __restrict__ Vj_,
                                const float* __restrict__ Baj_, const float* __restrict__ Bgj_,
                                const float* __restrict__ dP_, const float* __restrict__ dQ_,
                                const float* __restrict__ dV_, const float* __restrict__ sdt_,
                                const float* __restrict__ ba0_, const float* __restrict__ bg0_,
                                const float* __restrict__ jac, const float* __restrict__ G_,
                                float* __restrict__ r, float* __restrict__ Jcat, int n,
                                int rows_per_seq) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  // the factors are S = n / rows_per_seq sequences laid end to end, each
  // with its own gravity vector (S = 1: one window)
  G_ += 3 * (k / rows_per_seq);
  V3 Pi = ld3(Pi_, k), Vi = ld3(Vi_, k), Bai = ld3(Bai_, k), Bgi = ld3(Bgi_, k);
  V3 Pj = ld3(Pj_, k), Vj = ld3(Vj_, k), Baj = ld3(Baj_, k), Bgj = ld3(Bgj_, k);
  Q4 Qi = ld4(Qi_, k), Qj = ld4(Qj_, k), dQ = ld4(dQ_, k);
  V3 dP = ld3(dP_, k), dV = ld3(dV_, k), ba0 = ld3(ba0_, k), bg0 = ld3(bg0_, k);
  V3 G = V3{G_[0], G_[1], G_[2]};
  float dt = sdt_[k];
  float Jqbg[9], Jpba[9], Jpbg[9], Jvba[9], Jvbg[9];
  jblk(jac, k, 3, 12, Jqbg);
  jblk(jac, k, 0, 9, Jpba);
  jblk(jac, k, 0, 12, Jpbg);
  jblk(jac, k, 6, 9, Jvba);
  jblk(jac, k, 6, 12, Jvbg);

  // bias_corrected_delta (integration_base.h:173-178)
  V3 dba = V3{Bai.x - ba0.x, Bai.y - ba0.y, Bai.z - ba0.z};
  V3 dbg = V3{Bgi.x - bg0.x, Bgi.y - bg0.y, Bgi.z - bg0.z};
  V3 pba = m33vec(Jpba, dba), pbg = m33vec(Jpbg, dbg);
  V3 vba = m33vec(Jvba, dba), vbg = m33vec(Jvbg, dbg);
  V3 dp = V3{dP.x + pba.x + pbg.x, dP.y + pba.y + pbg.y, dP.z + pba.z + pbg.z};
  V3 dv = V3{dV.x + vba.x + vbg.x, dV.y + vba.y + vbg.y, dV.z + vba.z + vbg.z};
  V3 a_corr = m33vec(Jqbg, dbg);
  Q4 corr_dq = qnorm(qmul(dQ, so3_exp_quat(a_corr)));

  Q4 Qi_inv = qconj(Qi);
  V3 a1w = V3{0.5f * G.x * dt * dt + Pj.x - Pi.x - Vi.x * dt,
              0.5f * G.y * dt * dt + Pj.y - Pi.y - Vi.y * dt,
              0.5f * G.z * dt * dt + Pj.z - Pi.z - Vi.z * dt};
  V3 a2w = V3{G.x * dt + Vj.x - Vi.x, G.y * dt + Vj.y - Vi.y, G.z * dt + Vj.z - Vi.z};
  V3 a1 = qrot(Qi_inv, a1w);
  V3 a2 = qrot(Qi_inv, a2w);
  Q4 QiQj = qmul(Qi_inv, Qj);
  Q4 rq = qmul(qconj(corr_dq), QiQj);

  float* rr = r + 15 * k;
  rr[0] = a1.x - dp.x; rr[1] = a1.y - dp.y; rr[2] = a1.z - dp.z;
  rr[3] = 2.0f * rq.x; rr[4] = 2.0f * rq.y; rr[5] = 2.0f * rq.z;
  rr[6] = a2.x - dv.x; rr[7] = a2.y - dv.y; rr[8] = a2.z - dv.z;
  rr[9] = Baj.x - Bai.x; rr[10] = Baj.y - Bai.y; rr[11] = Baj.z - Bai.z;
  rr[12] = Bgj.x - Bgi.x; rr[13] = Bgj.y - Bgi.y; rr[14] = Bgj.z - Bgi.z;

  float* J = Jcat + 450 * k;
  for (int i = 0; i < 450; ++i) J[i] = 0.0f;

  float M[9], T[9], U[9];
  qmat(Qi_inv, M);  // Ri^T
  put33(J, 0, 0, M, -1.0f);
  put33(J, 0, 6, M, -dt);
  put33(J, 6, 6, M, -1.0f);
  put33(J, 0, 15, M, 1.0f);
  put33(J, 6, 21, M, 1.0f);

  skew3(a1, T);
  put33(J, 0, 3, T, 1.0f);
  skew3(a2, T);
  put33(J, 6, 3, T, 1.0f);

  Q4 Qj_inv_Qi = qmul(qconj(Qj), Qi);
  qlqr3(Qj_inv_Qi, corr_dq, T);
  put33(J, 3, 3, T, -1.0f);

  put33(J, 0, 9, Jpba, -1.0f);
  put33(J, 0, 12, Jpbg, -1.0f);
  put33(J, 6, 9, Jvba, -1.0f);
  put33(J, 6, 12, Jvbg, -1.0f);

  // J_q_bg = -Qleft(Qj^-1 Qi corr_dq)[1:4,1:4] Jr(a_corr) dq_dbg
  right_jacobian(a_corr, T);
  m33mul(T, Jqbg, U);
  ql3(qmul(Qj_inv_Qi, corr_dq), T);
  m33mul(T, U, M);
  put33(J, 3, 12, M, -1.0f);

  ql3(rq, T);  // Qleft(corr_dq^-1 Qi^-1 Qj)[1:4,1:4]
  put33(J, 3, 18, T, 1.0f);

  for (int i = 0; i < 3; ++i) {
    J[(9 + i) * 30 + 9 + i] = -1.0f;
    J[(12 + i) * 30 + 12 + i] = -1.0f;
    J[(9 + i) * 30 + 24 + i] = 1.0f;
    J[(12 + i) * 30 + 27 + i] = 1.0f;
  }
}

ISV_EXPORT int isv_imu_rows(const float* Pi, const float* Qi, const float* Vi, const float* Bai,
                            const float* Bgi, const float* Pj, const float* Qj, const float* Vj,
                            const float* Baj, const float* Bgj, const float* dP, const float* dQ,
                            const float* dV, const float* sum_dt, const float* ba0,
                            const float* bg0, const float* jac, const float* G, float* r,
                            float* Jcat, int n, int rows_per_seq, void* stream) {
  const int threads = 32;
  const int blocks = (n + threads - 1) / threads;
  imu_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj, dP, dQ, dV, sum_dt, ba0, bg0, jac, G, r, Jcat,
      n, rows_per_seq);
  return (int)cudaGetLastError();
}
