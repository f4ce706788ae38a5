// K1 proj_rows: fused projection-factor evaluation.
//
// Replaces isvins_tpu/ops/proj_pallas.py::proj_rows_pallas (Pallas body
// _proj_kernel). Plain version: isvins_tpu_torch/solver/proj_fast.py
// eval_proj_rows, whose operation order this kernel follows entry by entry
// (with -fmad=false it gives the plain version's bits).
//
// What bounds it on the H100: latency, not bytes or arithmetic. Per
// observation it reads 22 floats + 1 byte and writes 28 floats (~200 B);
// at N = 3072 that is ~0.6 MB, 0.18 us of HBM time, and ~600 operations per
// row are nothing for 132 SMs. The call costs a launch, one round of
// loads, the chain of one row's math (four quaternion rotations and five
// IEEE divisions, then the Jacobian rows) and one round of stores. The
// design shortens each:
// - A block is PROJ_ROWS = 32 rows and three warps, so 3072 rows are 96
//   blocks, each on an SM of its own.
// - The chain is split after the point transport (camera i -> world ->
//   camera j, u, v, 1/z), which every warp computes for the block's rows:
//   warp 0 then forms r and J_pi (from A = Ric^T Rj^T and B = A Ri), warp 1
//   J_pj (from A and Ric^T), warp 2 J_dep (from C = B Ric), so each warp's
//   chain is the transport plus a third of the rest.
// - Loads are coalesced and take one round trip: the four 12-byte-row
//   inputs of the block (pts_i, pts_j, Pi, Pj: 384 B each, 96 16-byte
//   chunks) come in as one 16-byte load per thread, Qi and Qj as one per
//   row, and every load of the thread is issued before the first is
//   waited for (a loop of load-then-store-to-shared would wait once per
//   input); then the chunks go to shared memory. (cp.async would overlap
//   these loads with nothing: the block has no work before they arrive.)
// - Stores are coalesced: the outputs are staged in shared memory and
//   leave as 16-byte stores, one span per output (J_pi and J_pj are 1,536 B
//   per block, r and J_dep 256 B), where one thread per row wrote 28 scalar
//   stores spread over 1.5 KB per warp instruction.
// A block with fewer than 32 rows, or an input off a 16-byte boundary,
// loads and stores 4 bytes at a time instead (still one round each); the
// math is the same.
//
// Sanitizing as in the reference (proj_pallas.py:113,123-127): an invalid
// or near-zero depth becomes 1 and z is clamped to +-1e-6, so masked rows
// come out finite (the solver multiplies them by 0, and NaN * 0 = NaN).
// Every division stays an IEEE division in the plain version's order:
// near the clamp, 1/z multiplies a last-bit change by ~1e5.
#include <cstdint>

#include "common.cuh"

constexpr int PROJ_ROWS = 32;               // rows per block
constexpr int PROJ_THREADS = 3 * PROJ_ROWS;  // three warps

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(PROJ_THREADS)
    proj_rows_kernel(const float* __restrict__ pts_i, const float* __restrict__ pts_j,
                     const float* __restrict__ Pi, const float* __restrict__ Qi,
                     const float* __restrict__ Pj, const float* __restrict__ Qj,
                     const float* __restrict__ tic, const float* __restrict__ qic,
                     const float* __restrict__ dep, const unsigned char* __restrict__ valid,
                     float* __restrict__ r, float* __restrict__ J_pi, float* __restrict__ J_pj,
                     float* __restrict__ J_dep, int n, int rows_per_seq) {
  __shared__ __align__(16) float s_in[4][3 * PROJ_ROWS];  // pts_i, pts_j, Pi, Pj
  __shared__ __align__(16) float s_r[2 * PROJ_ROWS];
  __shared__ __align__(16) float s_pi[12 * PROJ_ROWS];
  __shared__ __align__(16) float s_pj[12 * PROJ_ROWS];
  __shared__ __align__(16) float s_dep[2 * PROJ_ROWS];
  const int base = blockIdx.x * PROJ_ROWS;
  const int rows = min(PROJ_ROWS, n - base);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a whole block's spans start on 16-byte boundaries when the arrays do
  const bool vec = aligned16(pts_i) && aligned16(pts_j) && aligned16(Pi) && aligned16(Pj) &&
                   aligned16(Qi) && aligned16(Qj) && aligned16(r) && aligned16(J_pi) &&
                   aligned16(J_pj) && aligned16(J_dep);

  // one round of loads: in a full block, thread k brings 16-byte chunk k % 24
  // of input k / 24 (each input's 32 rows are 24 chunks), else float k of
  // each input; the per-row loads below are issued before any of them is
  // waited for
  const bool full = vec && rows == PROJ_ROWS;
  const int k = threadIdx.x;
  const float* in = k < 24 ? pts_i : (k < 48 ? pts_j : (k < 72 ? Pi : Pj));
  float4 chunk = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (full) {
    chunk = reinterpret_cast<const float4*>(in + 3 * base)[k % 24];
  } else if (k < 3 * rows) {
    chunk = make_float4(pts_i[3 * base + k], pts_j[3 * base + k], Pi[3 * base + k],
                        Pj[3 * base + k]);
  }
  const int t = base + lane;
  Q4 qi{}, qj{}, qc{};
  V3 tc{};
  float dv = 0.0f;
  bool ok = false;
  if (lane < rows) {
    if (vec) {
      float4 a = reinterpret_cast<const float4*>(Qi)[t], b = reinterpret_cast<const float4*>(Qj)[t];
      qi = Q4{a.x, a.y, a.z, a.w};
      qj = Q4{b.x, b.y, b.z, b.w};
    } else {
      qi = Q4{Qi[4 * t], Qi[4 * t + 1], Qi[4 * t + 2], Qi[4 * t + 3]};
      qj = Q4{Qj[4 * t], Qj[4 * t + 1], Qj[4 * t + 2], Qj[4 * t + 3]};
    }
    // the rows are S = n / rows_per_seq sequences laid end to end, each
    // with its own extrinsic (S = 1: one window)
    const int s = t / rows_per_seq;
    qc = Q4{qic[4 * s], qic[4 * s + 1], qic[4 * s + 2], qic[4 * s + 3]};
    tc = V3{tic[3 * s], tic[3 * s + 1], tic[3 * s + 2]};
    dv = dep[t];
    ok = valid[t] != 0;
  }
  if (full) {
    reinterpret_cast<float4*>(&s_in[0][0])[k] = chunk;  // = s_in[k / 24], chunk k % 24
  } else {
    s_in[0][k] = chunk.x;
    s_in[1][k] = chunk.y;
    s_in[2][k] = chunk.z;
    s_in[3][k] = chunk.w;
  }
  __syncthreads();

  if (lane < rows) {
    const float* row_i = s_in[0] + 3 * lane;
    const float* row_Pi = s_in[2] + 3 * lane;
    const float* row_Pj = s_in[3] + 3 * lane;
    // ---- the point transport, on every warp ----
    float d = (ok && fabsf(dv) > 1e-8f) ? dv : 1.0f;
    V3 pti = V3{row_i[0], row_i[1], row_i[2]};
    // camera i -> body i -> world -> body j -> camera j
    V3 pc = V3{pti.x / d, pti.y / d, pti.z / d};
    V3 bi = qrot(qc, pc);
    bi = V3{bi.x + tc.x, bi.y + tc.y, bi.z + tc.z};
    V3 w = qrot(qi, bi);
    w = V3{w.x + row_Pi[0], w.y + row_Pi[1], w.z + row_Pi[2]};
    V3 bj = qrot(qconj(qj), V3{w.x - row_Pj[0], w.y - row_Pj[1], w.z - row_Pj[2]});
    V3 cj = qrot(qconj(qc), V3{bj.x - tc.x, bj.y - tc.y, bj.z - tc.z});

    float z = cj.z;
    z = fabsf(z) > 1e-6f ? z : (z >= 0.0f ? 1e-6f : -1e-6f);
    float inv_z = 1.0f / z;
    float u = cj.x * inv_z;
    float v = cj.y * inv_z;

    // rotation compositions as quaternion products
    Q4 q_a = qconj(qmul(qj, qc));  // Ric^T Rj^T
    float A[9];
    qmat(q_a, A);
    // reduce @ M, rows r0 = (M0 - u M2)/z, r1 = (M1 - v M2)/z
    float RA0[3], RA1[3];
    for (int c = 0; c < 3; ++c) {
      RA0[c] = (A[c] - u * A[6 + c]) * inv_z;
      RA1[c] = (A[3 + c] - v * A[6 + c]) * inv_z;
    }
    if (warp == 0) {  // r and J_pi
      s_r[2 * lane] = u - s_in[1][3 * lane];
      s_r[2 * lane + 1] = v - s_in[1][3 * lane + 1];
      Q4 q_b = qmul(q_a, qi);  // Ric^T Rj^T Ri
      float B[9], RB0[3], RB1[3];
      qmat(q_b, B);
      for (int c = 0; c < 3; ++c) {
        RB0[c] = (B[c] - u * B[6 + c]) * inv_z;
        RB1[c] = (B[3 + c] - v * B[6 + c]) * inv_z;
      }
      V3 j0 = cross3(bi, V3{RB0[0], RB0[1], RB0[2]});
      V3 j1 = cross3(bi, V3{RB1[0], RB1[1], RB1[2]});
      float* o = s_pi + 12 * lane;
      o[0] = RA0[0]; o[1] = RA0[1]; o[2] = RA0[2];
      o[3] = j0.x; o[4] = j0.y; o[5] = j0.z;
      o[6] = RA1[0]; o[7] = RA1[1]; o[8] = RA1[2];
      o[9] = j1.x; o[10] = j1.y; o[11] = j1.z;
    } else if (warp == 1) {  // J_pj
      float RC[9], RC0[3], RC1[3];
      qmat(qconj(qc), RC);
      for (int c = 0; c < 3; ++c) {
        RC0[c] = (RC[c] - u * RC[6 + c]) * inv_z;
        RC1[c] = (RC[3 + c] - v * RC[6 + c]) * inv_z;
      }
      V3 j0 = cross3(bj, V3{RC0[0], RC0[1], RC0[2]});
      V3 j1 = cross3(bj, V3{RC1[0], RC1[1], RC1[2]});
      float* o = s_pj + 12 * lane;
      o[0] = -RA0[0]; o[1] = -RA0[1]; o[2] = -RA0[2];
      o[3] = -j0.x; o[4] = -j0.y; o[5] = -j0.z;
      o[6] = -RA1[0]; o[7] = -RA1[1]; o[8] = -RA1[2];
      o[9] = -j1.x; o[10] = -j1.y; o[11] = -j1.z;
    } else {  // J_dep = reduce @ (C @ pts_i) * (-1/d^2)
      Q4 q_c = qmul(qmul(q_a, qi), qc);  // Ric^T Rj^T Ri Ric
      float Cm[9];
      qmat(q_c, Cm);
      float w0 = Cm[0] * pti.x + Cm[1] * pti.y + Cm[2] * pti.z;
      float w1 = Cm[3] * pti.x + Cm[4] * pti.y + Cm[5] * pti.z;
      float w2 = Cm[6] * pti.x + Cm[7] * pti.y + Cm[8] * pti.z;
      float s = -1.0f / (d * d);
      s_dep[2 * lane] = (w0 - u * w2) * inv_z * s;
      s_dep[2 * lane + 1] = (w1 - v * w2) * inv_z * s;
    }
  }
  __syncthreads();

  if (full) {  // J_pi and J_pj: 96 chunks each; r and J_dep: 16 each
    const float4 pi = reinterpret_cast<const float4*>(s_pi)[k];
    const float4 pj = reinterpret_cast<const float4*>(s_pj)[k];
    const float4 rd = reinterpret_cast<const float4*>(k < 16 ? s_r : s_dep)[k % 16];
    reinterpret_cast<float4*>(J_pi + 12 * base)[k] = pi;
    reinterpret_cast<float4*>(J_pj + 12 * base)[k] = pj;
    if (k < 32) reinterpret_cast<float4*>(k < 16 ? r + 2 * base : J_dep + 2 * base)[k % 16] = rd;
  } else {  // 4 bytes at a time: J_pi and J_pj 4 floats a thread, r and J_dep 1
    float pi[4], pj[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pi[i] = s_pi[k + PROJ_THREADS * i];
      pj[i] = s_pj[k + PROJ_THREADS * i];
    }
    const float r_k = s_r[k % 64], dep_k = s_dep[k % 64];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (k + PROJ_THREADS * i < 12 * rows) {
        J_pi[12 * base + k + PROJ_THREADS * i] = pi[i];
        J_pj[12 * base + k + PROJ_THREADS * i] = pj[i];
      }
    }
    if (k < 2 * rows) {
      r[2 * base + k] = r_k;
      J_dep[2 * base + k] = dep_k;
    }
  }
}

ISV_EXPORT int isv_proj_rows(const float* pts_i, const float* pts_j, const float* Pi,
                             const float* Qi, const float* Pj, const float* Qj,
                             const float* tic, const float* qic, const float* dep,
                             const unsigned char* valid, float* r, float* J_pi,
                             float* J_pj, float* J_dep, int n, int rows_per_seq,
                             void* stream) {
  const int blocks = (n + PROJ_ROWS - 1) / PROJ_ROWS;
  proj_rows_kernel<<<blocks, PROJ_THREADS, 0, (cudaStream_t)stream>>>(
      pts_i, pts_j, Pi, Qi, Pj, Qj, tic, qic, dep, valid, r, J_pi, J_pj, J_dep, n,
      rows_per_seq);
  return (int)cudaGetLastError();
}
