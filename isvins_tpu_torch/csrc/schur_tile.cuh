// The tile routine of the landmark Schur products W^T diag(1/h) W, shared by
// K3 (schur_corr.cu, width Dr = 114) and K7 (schur_reduce.cu, width
// D = 276): a plain shared-memory tiled f32 product with the 1/h scaling
// fused into the second operand as it is staged. 16x16 output tiles, F
// streamed in chunks of 32 rows. Each thread owns one output entry and sums
// over F in a fixed order: no atomics, so results repeat run to run.
#pragma once

#include "common.cuh"

#define TS 16
#define TF 32

// h as the product divides by it. `lam` (device scalar, may be null): h is
// the undamped landmark Hessian and h (1 + lam) is formed here. `guard`:
// values that are not > 1e-12 count as 1 (an empty landmark). With lam null
// and guard false, h is used as given.
__device__ __forceinline__ float h_safe_at(const float* h, const float* lam, bool guard, int f) {
  float v = h[f];
  if (lam != nullptr) v = v * (1.0f + *lam);
  if (lam != nullptr || guard) v = v > 1e-12f ? v : 1.0f;
  return v;
}

// For the calling 16x16 thread block: sum_f W[f, a0 + ty] * X[f, b0 + tx] /
// h_safe(f), where X = [W | bl] (column n of X is bl; pass bl = nullptr for
// no extra column) and W is (F, n) row-major. Out-of-range entries
// contribute 0. All 256 threads must call it.
__device__ __forceinline__ float schur_tile(const float* __restrict__ W,
                                            const float* __restrict__ bl,
                                            const float* __restrict__ h,
                                            const float* __restrict__ lam, bool guard, int F,
                                            int n, int a0, int b0) {
  __shared__ float Wa[TF][TS + 1];
  __shared__ float Wb[TF][TS + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TS + tx;
  const int nb = bl != nullptr ? n + 1 : n;  // columns of X
  float acc = 0.0f;
  for (int f0 = 0; f0 < F; f0 += TF) {
    for (int idx = tid; idx < TF * TS; idx += TS * TS) {
      const int ff = idx / TS, cc = idx % TS;
      const int f = f0 + ff;
      const int ca = a0 + cc, cbi = b0 + cc;
      float va = 0.0f, vb = 0.0f;
      if (f < F) {
        if (ca < n) va = W[(size_t)f * n + ca];
        if (cbi < nb) {
          const float num = cbi < n ? W[(size_t)f * n + cbi] : bl[f];
          vb = num / h_safe_at(h, lam, guard, f);
        }
      }
      Wa[ff][cc] = va;
      Wb[ff][cc] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int ff = 0; ff < TF; ++ff) acc += Wa[ff][ty] * Wb[ff][tx];
    __syncthreads();
  }
  return acc;
}
