// K1 proj_rows: fused projection-factor evaluation.
//
// Replaces isvins_tpu/ops/proj_pallas.py::proj_rows_pallas (Pallas body
// _proj_kernel). Plain version: isvins_tpu_torch/solver/proj_fast.py
// eval_proj_rows, whose operation order this kernel follows.
//
// What bounds it on the H100: memory and launch latency, not arithmetic.
// Per observation it reads 22 floats + 1 byte and writes 28 floats
// (~200 B); at N = 3072 that is ~0.6 MB, about 0.2 us of HBM time, and the
// ~250 flops per observation are nothing for 132 SMs. So the design is the
// simplest one that keeps every byte moving once: one thread per
// observation, no shared memory, no reductions, every intermediate in
// registers. Inputs and outputs keep the solver's row-major (N, k) layout
// (k <= 12 floats): a warp's 32 rows are one contiguous span, so each load
// and store instruction is served by whole 32-byte sectors.
//
// Sanitizing as in the reference (proj_pallas.py:113,123-127): an invalid
// or near-zero depth becomes 1 and z is clamped to +-1e-6, so masked rows
// come out finite (the solver multiplies them by 0, and NaN * 0 = NaN).
#include "common.cuh"

__global__ void proj_rows_kernel(const float* __restrict__ pts_i,
                                 const float* __restrict__ pts_j,
                                 const float* __restrict__ Pi,
                                 const float* __restrict__ Qi,
                                 const float* __restrict__ Pj,
                                 const float* __restrict__ Qj,
                                 const float* __restrict__ tic,
                                 const float* __restrict__ qic,
                                 const float* __restrict__ dep,
                                 const unsigned char* __restrict__ valid,
                                 float* __restrict__ r, float* __restrict__ J_pi,
                                 float* __restrict__ J_pj, float* __restrict__ J_dep,
                                 int n, int rows_per_seq) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  // the rows are S = n / rows_per_seq sequences laid end to end, each with
  // its own extrinsic (S = 1: one window)
  tic += 3 * (t / rows_per_seq);
  qic += 4 * (t / rows_per_seq);

  float dv = dep[t];
  float d = (valid[t] != 0 && fabsf(dv) > 1e-8f) ? dv : 1.0f;
  V3 pti = V3{pts_i[3 * t], pts_i[3 * t + 1], pts_i[3 * t + 2]};
  Q4 qi = Q4{Qi[4 * t], Qi[4 * t + 1], Qi[4 * t + 2], Qi[4 * t + 3]};
  Q4 qj = Q4{Qj[4 * t], Qj[4 * t + 1], Qj[4 * t + 2], Qj[4 * t + 3]};
  Q4 qc = Q4{qic[0], qic[1], qic[2], qic[3]};
  V3 tc = V3{tic[0], tic[1], tic[2]};

  // camera i -> body i -> world -> body j -> camera j
  V3 pc = V3{pti.x / d, pti.y / d, pti.z / d};
  V3 bi = qrot(qc, pc);
  bi = V3{bi.x + tc.x, bi.y + tc.y, bi.z + tc.z};
  V3 w = qrot(qi, bi);
  w = V3{w.x + Pi[3 * t], w.y + Pi[3 * t + 1], w.z + Pi[3 * t + 2]};
  V3 bj = qrot(qconj(qj), V3{w.x - Pj[3 * t], w.y - Pj[3 * t + 1], w.z - Pj[3 * t + 2]});
  V3 cj = qrot(qconj(qc), V3{bj.x - tc.x, bj.y - tc.y, bj.z - tc.z});

  float z = cj.z;
  z = fabsf(z) > 1e-6f ? z : (z >= 0.0f ? 1e-6f : -1e-6f);
  float inv_z = 1.0f / z;
  float u = cj.x * inv_z;
  float v = cj.y * inv_z;
  r[2 * t] = u - pts_j[3 * t];
  r[2 * t + 1] = v - pts_j[3 * t + 1];

  // rotation compositions as quaternion products
  Q4 q_a = qconj(qmul(qj, qc));  // Ric^T Rj^T
  Q4 q_b = qmul(q_a, qi);        // Ric^T Rj^T Ri
  Q4 q_c = qmul(q_b, qc);        // Ric^T Rj^T Ri Ric
  float A[9], B[9], Cm[9], RC[9];
  qmat(q_a, A);
  qmat(q_b, B);
  qmat(q_c, Cm);
  qmat(qconj(qc), RC);

  // reduce @ M, rows r0 = (M0 - u M2)/z, r1 = (M1 - v M2)/z
  float RA0[3], RA1[3], RB0[3], RB1[3], RC0[3], RC1[3];
  for (int k = 0; k < 3; ++k) {
    RA0[k] = (A[k] - u * A[6 + k]) * inv_z;
    RA1[k] = (A[3 + k] - v * A[6 + k]) * inv_z;
    RB0[k] = (B[k] - u * B[6 + k]) * inv_z;
    RB1[k] = (B[3 + k] - v * B[6 + k]) * inv_z;
    RC0[k] = (RC[k] - u * RC[6 + k]) * inv_z;
    RC1[k] = (RC[3 + k] - v * RC[6 + k]) * inv_z;
  }
  V3 jpi0 = cross3(bi, V3{RB0[0], RB0[1], RB0[2]});
  V3 jpi1 = cross3(bi, V3{RB1[0], RB1[1], RB1[2]});
  V3 jpj0 = cross3(bj, V3{RC0[0], RC0[1], RC0[2]});
  V3 jpj1 = cross3(bj, V3{RC1[0], RC1[1], RC1[2]});

  float* o = J_pi + 12 * t;
  o[0] = RA0[0]; o[1] = RA0[1]; o[2] = RA0[2];
  o[3] = jpi0.x; o[4] = jpi0.y; o[5] = jpi0.z;
  o[6] = RA1[0]; o[7] = RA1[1]; o[8] = RA1[2];
  o[9] = jpi1.x; o[10] = jpi1.y; o[11] = jpi1.z;
  o = J_pj + 12 * t;
  o[0] = -RA0[0]; o[1] = -RA0[1]; o[2] = -RA0[2];
  o[3] = -jpj0.x; o[4] = -jpj0.y; o[5] = -jpj0.z;
  o[6] = -RA1[0]; o[7] = -RA1[1]; o[8] = -RA1[2];
  o[9] = -jpj1.x; o[10] = -jpj1.y; o[11] = -jpj1.z;

  // J_dep = reduce @ (C @ pts_i) * (-1/d^2)
  float w0 = Cm[0] * pti.x + Cm[1] * pti.y + Cm[2] * pti.z;
  float w1 = Cm[3] * pti.x + Cm[4] * pti.y + Cm[5] * pti.z;
  float w2 = Cm[6] * pti.x + Cm[7] * pti.y + Cm[8] * pti.z;
  float s = -1.0f / (d * d);
  J_dep[2 * t] = (w0 - u * w2) * inv_z * s;
  J_dep[2 * t + 1] = (w1 - v * w2) * inv_z * s;
}

ISV_EXPORT int isv_proj_rows(const float* pts_i, const float* pts_j, const float* Pi,
                             const float* Qi, const float* Pj, const float* Qj,
                             const float* tic, const float* qic, const float* dep,
                             const unsigned char* valid, float* r, float* J_pi,
                             float* J_pj, float* J_dep, int n, int rows_per_seq,
                             void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  proj_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      pts_i, pts_j, Pi, Qi, Pj, Qj, tic, qic, dep, valid, r, J_pi, J_pj, J_dep, n,
      rows_per_seq);
  return (int)cudaGetLastError();
}
