// Dense Cholesky on the packed lower triangle in shared memory, shared by
// K4 (linstep.cu, one problem) and K5 (chol_batched.cu, one problem per
// thread block).
//
// A 276x276 f32 matrix (304,704 B) does not fit a block's 232,448 B of
// shared memory, so a block keeps the PACKED LOWER TRIANGLE
// (276*277/2*4 = 152,904 B) beside three D-vectors; every step of the
// right-looking factorization then touches only shared memory: per column
// one scaling pass and one rank-1 trailing update spread over the block's
// warps (a warp per row, lanes along the row, which is contiguous in packed
// storage), two block barriers per column. The triangular solves run in one
// warp: forward substitution as a row dot product with a shuffle reduction,
// back substitution right-looking along the rows of L, so both read
// contiguous packed rows.
#pragma once

#include <math.h>

#include "common.cuh"

__device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

__host__ __device__ __forceinline__ int chol_smem_bytes(int D) {
  return (D * (D + 1) / 2 + 3 * D) * (int)sizeof(float);
}

// Factors A = L L^T in place (all threads of the block call it; A holds the
// lower triangle on entry, published by a barrier). `col` is D floats of
// scratch, `ldiag` receives diag(L). A pivot that is not > 0 sets *bad and
// stops: the matrix is not SPD. *bad must be 0 on entry. Ends on a barrier.
__device__ __forceinline__ void chol_factor_packed(float* A, float* col, float* ldiag, int* bad,
                                                   int D) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  for (int j = 0; j < D; ++j) {
    const float d = A[tri(j) + j];
    if (!(d > 0.0f)) {  // every thread reads the same value: uniform exit
      if (tid == 0) *bad = 1;
      break;
    }
    const float ljj = sqrtf(d);
    for (int i = j + 1 + tid; i < D; i += nt) {
      const float l = A[tri(i) + j] / ljj;
      A[tri(i) + j] = l;
      col[i] = l;
    }
    if (tid == 0) ldiag[j] = ljj;
    __syncthreads();
    for (int i = j + 1 + warp; i < D; i += nw) {
      const float ci = col[i];
      float* Ai = A + tri(i);
      for (int k = j + 1 + lane; k <= i; k += 32) Ai[k] -= ci * col[k];
    }
    __syncthreads();
  }
  __syncthreads();
}

// Solves L L^T x = vec in place (vec: rhs -> y -> x). One warp calls it,
// after chol_factor_packed left *bad == 0.
__device__ __forceinline__ void chol_solve_packed(const float* A, const float* ldiag, float* vec,
                                                  int D) {
  const int lane = threadIdx.x & 31;
  // forward: L y = b, one row dot product per step
  for (int j = 0; j < D; ++j) {
    const float* Lj = A + tri(j);
    float s = 0.0f;
    for (int k = lane; k < j; k += 32) s += Lj[k] * vec[k];
    s = warp_sum(s);
    if (lane == 0) vec[j] = (vec[j] - s) / ldiag[j];
    __syncwarp();
  }
  // back: L^T x = y, right-looking along the rows of L
  for (int j = D - 1; j >= 0; --j) {
    const float xj = vec[j] / ldiag[j];
    __syncwarp();
    if (lane == 0) vec[j] = xj;
    const float* Lj = A + tri(j);
    for (int k = lane; k < j; k += 32) vec[k] -= Lj[k] * xj;
    __syncwarp();
  }
}
