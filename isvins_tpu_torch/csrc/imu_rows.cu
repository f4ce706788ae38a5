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
// What bounds it on the H100: latency. The window has n = B-1 = 17 factors
// (S * 17 when S sequences are evaluated in one launch), ~1.5k flops and
// 1,860 B of output each: the bytes are 0.015 us of HBM time, so the call
// costs a launch, one round of loads, the chain of one factor's math and
// one round of stores. The design shortens each of these:
// - One warp per factor, IMU_WARPS factors per block, so that 17 factors
//   run on 9 SMs and 272 on most of the card.
// - The factor's 15x30 block is staged in shared memory: zero-filled while
//   the loads are in flight, filled, then written out by all 32 lanes with
//   8-byte stores (a factor's 1,800 B row starts on an 8-byte boundary for
//   every k; 16 bytes would hold only for even k): 8 store instructions of
//   256 contiguous bytes each, where one thread per factor paid ~600
//   scattered 4-byte stores.
// - The chain that every output depends on (bias correction, so3 exp,
//   normalization, the quaternion products) is computed by every lane of
//   the warp alike, so it costs one lane's latency and no exchange. The
//   3x3 blocks are then formed entry-wise, lane e < 9 holding entry
//   (e / 3, e % 3) of all 14 placed blocks: the longest path,
//   J_q_bg = -Qleft(Qj^-1 Qi corr_dq)[1:4,1:4] Jr(a_corr) dq_dbg, costs each
//   lane one column of Jr dq_dbg and one dot product instead of two full
//   3x3 products. Lanes 9-11 place the identity entries, lanes 0-14 store
//   the residual.
// The math stays IEEE: sinf/cosf (the intrinsics' absolute error is a
// percent of sin(t/2)/t at t ~ 1e-4), separately rounded products and
// sums (-fmad=false), and each entry is formed in the operation order of
// the one-thread kernel this replaces (a product entry is the same dot
// product of the same row and column). The small-angle branches of _qnorm,
// so3 exp and the right Jacobian follow imu_pallas.py:137-160.
#include <cstdint>

#include "common.cuh"

constexpr int IMU_WARPS = 2;    // factors per block, one warp each
constexpr int IMU_JCAT = 450;   // 15 x 30 floats per factor

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

// Qleft(q)[1:4, 1:4] = w I + skew(v)
__device__ __forceinline__ void ql3(Q4 q, float* o) {
  o[0] = q.w; o[1] = -q.z; o[2] = q.y;
  o[3] = q.z; o[4] = q.w; o[5] = -q.x;
  o[6] = -q.y; o[7] = q.x; o[8] = q.w;
}

// entry e of a 3x3 held in registers (selects: no local memory)
__device__ __forceinline__ float pick9(const float* m, int e) {
  float v = m[0];
#pragma unroll
  for (int q = 1; q < 9; ++q) v = (e == q) ? m[q] : v;
  return v;
}

// component c (0, 1, 2) of v
__device__ __forceinline__ float pick3(V3 v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : v.z);
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

__global__ void __launch_bounds__(32 * IMU_WARPS)
    imu_rows_kernel(const float* __restrict__ Pi_, const float* __restrict__ Qi_,
                    const float* __restrict__ Vi_, const float* __restrict__ Bai_,
                    const float* __restrict__ Bgi_, const float* __restrict__ Pj_,
                    const float* __restrict__ Qj_, const float* __restrict__ Vj_,
                    const float* __restrict__ Baj_, const float* __restrict__ Bgj_,
                    const float* __restrict__ dP_, const float* __restrict__ dQ_,
                    const float* __restrict__ dV_, const float* __restrict__ sdt_,
                    const float* __restrict__ ba0_, const float* __restrict__ bg0_,
                    const float* __restrict__ jac, const float* __restrict__ G_,
                    float* __restrict__ r, float* __restrict__ Jcat, int n, int rows_per_seq) {
  __shared__ __align__(16) float stage[IMU_WARPS][IMU_JCAT];
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * IMU_WARPS + (threadIdx.x >> 5);
  if (k >= n) return;  // the whole warp: nothing below synchronizes the block
  float* Js = stage[threadIdx.x >> 5];
  float2* Js2 = reinterpret_cast<float2*>(Js);
  for (int q = lane; q < IMU_JCAT / 2; q += 32) Js2[q] = make_float2(0.0f, 0.0f);

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

  // ---- the shared chain, on every lane ----
  // bias_corrected_delta (integration_base.h:173-178)
  V3 dba = V3{Bai.x - ba0.x, Bai.y - ba0.y, Bai.z - ba0.z};
  V3 dbg = V3{Bgi.x - bg0.x, Bgi.y - bg0.y, Bgi.z - bg0.z};
  V3 a_corr = m33vec(Jqbg, dbg);
  Q4 corr_dq = qnorm(qmul(dQ, so3_exp_quat(a_corr)));
  float Jr[9];
  right_jacobian(a_corr, Jr);

  Q4 Qi_inv = qconj(Qi);
  V3 a1w = V3{0.5f * G.x * dt * dt + Pj.x - Pi.x - Vi.x * dt,
              0.5f * G.y * dt * dt + Pj.y - Pi.y - Vi.y * dt,
              0.5f * G.z * dt * dt + Pj.z - Pi.z - Vi.z * dt};
  V3 a2w = V3{G.x * dt + Vj.x - Vi.x, G.y * dt + Vj.y - Vi.y, G.z * dt + Vj.z - Vi.z};
  V3 a1 = qrot(Qi_inv, a1w);
  V3 a2 = qrot(Qi_inv, a2w);
  Q4 rq = qmul(qconj(corr_dq), qmul(Qi_inv, Qj));
  Q4 Qj_inv_Qi = qmul(qconj(Qj), Qi);
  Q4 Qc = qmul(Qj_inv_Qi, corr_dq);

  // ---- the residual: lane l < 15 stores r[l] ----
  if (lane < 15) {
    V3 pba = m33vec(Jpba, dba), pbg = m33vec(Jpbg, dbg);
    V3 vba = m33vec(Jvba, dba), vbg = m33vec(Jvbg, dbg);
    int c = lane % 3;
    float v;
    switch (lane / 3) {  // five cases, each a row of three lanes
      case 0: v = pick3(a1, c) - (pick3(dP, c) + pick3(pba, c) + pick3(pbg, c)); break;
      case 1: v = 2.0f * (c == 0 ? rq.x : (c == 1 ? rq.y : rq.z)); break;
      case 2: v = pick3(a2, c) - (pick3(dV, c) + pick3(vba, c) + pick3(vbg, c)); break;
      case 3: v = pick3(Baj, c) - pick3(Bai, c); break;
      default: v = pick3(Bgj, c) - pick3(Bgi, c); break;
    }
    r[15 * k + lane] = v;
  }
  __syncwarp();  // the zero fill is in place

  // ---- the 3x3 blocks, entry (i, j) on lane e = 3 i + j ----
  if (lane < 9) {
    const int e = lane, i = lane / 3, j = lane % 3;
    float M[9];
    qmat(Qi_inv, M);  // Ri^T
    float rit = pick9(M, e);
    skew3(a1, M);
    float sk1 = pick9(M, e);
    skew3(a2, M);
    float sk2 = pick9(M, e);
    // (Qleft(Qj^-1 Qi) Qright(corr_dq))[1:4, 1:4]: row i of the one, row j of the other
    const Q4 a = Qj_inv_Qi, b = corr_dq;
    float L0 = i == 0 ? a.x : (i == 1 ? a.y : a.z);
    float L1 = i == 0 ? a.w : (i == 1 ? a.z : -a.y);
    float L2 = i == 0 ? -a.z : (i == 1 ? a.w : a.x);
    float L3 = i == 0 ? a.y : (i == 1 ? -a.x : a.w);
    float R0 = j == 0 ? -b.x : (j == 1 ? -b.y : -b.z);
    float R1 = j == 0 ? b.w : (j == 1 ? b.z : -b.y);
    float R2 = j == 0 ? -b.z : (j == 1 ? b.w : b.x);
    float R3 = j == 0 ? b.y : (j == 1 ? -b.x : b.w);
    float qlqr = L0 * R0 + L1 * R1 + L2 * R2 + L3 * R3;
    // J_q_bg entry: row i of Qleft(Qc)[1:4,1:4] times column j of Jr dq_dbg
    const float B0 = pick9(Jqbg, j), B1 = pick9(Jqbg, 3 + j), B2 = pick9(Jqbg, 6 + j);
    float U0 = Jr[0] * B0 + Jr[1] * B1 + Jr[2] * B2;
    float U1 = Jr[3] * B0 + Jr[4] * B1 + Jr[5] * B2;
    float U2 = Jr[6] * B0 + Jr[7] * B1 + Jr[8] * B2;
    ql3(Qc, M);
    float jqbg = pick9(M, 3 * i) * U0 + pick9(M, 3 * i + 1) * U1 + pick9(M, 3 * i + 2) * U2;
    ql3(rq, M);  // Qleft(corr_dq^-1 Qi^-1 Qj)[1:4,1:4]
    float qlrq = pick9(M, e);

    float* o = Js + i * 30 + j;  // row i, column j of each block below
    o[0] = -rit;                 // (0, 0)   dr_p / dp_i
    o[3] = sk1;                  // (0, 3)   dr_p / dtheta_i
    o[6] = -dt * rit;            // (0, 6)   dr_p / dv_i
    o[9] = -pick9(Jpba, e);      // (0, 9)
    o[12] = -pick9(Jpbg, e);     // (0, 12)
    o[15] = rit;                 // (0, 15)  dr_p / dp_j
    o[90 + 3] = -qlqr;           // (3, 3)
    o[90 + 12] = -jqbg;          // (3, 12)
    o[90 + 18] = qlrq;           // (3, 18)
    o[180 + 3] = sk2;            // (6, 3)
    o[180 + 6] = -rit;           // (6, 6)
    o[180 + 9] = -pick9(Jvba, e);   // (6, 9)
    o[180 + 12] = -pick9(Jvbg, e);  // (6, 12)
    o[180 + 21] = rit;              // (6, 21)
  } else if (lane < 12) {
    const int d = lane - 9;
    Js[(9 + d) * 30 + 9 + d] = -1.0f;
    Js[(12 + d) * 30 + 12 + d] = -1.0f;
    Js[(9 + d) * 30 + 24 + d] = 1.0f;
    Js[(12 + d) * 30 + 27 + d] = 1.0f;
  }
  __syncwarp();

  // ---- out: 225 8-byte stores, 256 contiguous bytes per instruction; all
  // shared-memory reads first, so the warp waits for them once ----
  float2 out[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (lane + 32 * i < IMU_JCAT / 2) out[i] = Js2[lane + 32 * i];
  float2* dst = reinterpret_cast<float2*>(Jcat + (size_t)IMU_JCAT * k);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (lane + 32 * i < IMU_JCAT / 2) dst[lane + 32 * i] = out[i];
}

ISV_EXPORT int isv_imu_rows(const float* Pi, const float* Qi, const float* Vi, const float* Bai,
                            const float* Bgi, const float* Pj, const float* Qj, const float* Vj,
                            const float* Baj, const float* Bgj, const float* dP, const float* dQ,
                            const float* dV, const float* sum_dt, const float* ba0,
                            const float* bg0, const float* jac, const float* G, float* r,
                            float* Jcat, int n, int rows_per_seq, void* stream) {
  if (reinterpret_cast<uintptr_t>(Jcat) % 8) return (int)cudaErrorMisalignedAddress;
  const int blocks = (n + IMU_WARPS - 1) / IMU_WARPS;
  imu_rows_kernel<<<blocks, 32 * IMU_WARPS, 0, (cudaStream_t)stream>>>(
      Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj, dP, dQ, dV, sum_dt, ba0, bg0, jac, G, r, Jcat,
      n, rows_per_seq);
  return (int)cudaGetLastError();
}
