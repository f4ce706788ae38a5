// K7 schur_reduce: the full landmark Schur reduction of the window system.
//
// Replaces isvins_tpu/ops/schur_pallas.py::schur_reduce_pallas (Pallas body
// _kernel). Plain version: isvins_tpu_torch/ops/schur.py schur_reduce_ref.
//
//   H_s = H - W^T diag(1/h) W        (D, D),  W (F, D) = (1000, 276)
//
// Landmarks with h <= 1e-12 (empty slots) count as h = 1. The right-hand
// side b - W^T (b_l / h) is formed outside the kernel, as in the reference.
// The product is K3's at full width: the same tile routine
// (schur_tile.cuh), with H subtracted in the epilogue; 18 x 18 = 324 blocks
// at D = 276.
//
// What bounds it on the H100: ~152 MFLOP of f32 FMA work against 1.7 MB,
// so arithmetic, but at this size mostly launch latency and the 16x16
// tile's shared-memory traffic.
#include "schur_tile.cuh"

__global__ void schur_reduce_kernel(const float* __restrict__ H, const float* __restrict__ W,
                                    const float* __restrict__ h, float* __restrict__ out, int F,
                                    int D) {
  const int a0 = blockIdx.y * TS, b0 = blockIdx.x * TS;
  const float acc = schur_tile(W, nullptr, h, nullptr, true, F, D, a0, b0);
  const int a = a0 + threadIdx.y, b = b0 + threadIdx.x;
  if (a < D && b < D) out[(size_t)a * D + b] = H[(size_t)a * D + b] - acc;
}

ISV_EXPORT int isv_schur_reduce(const float* H, const float* W, const float* h, float* out,
                                int F, int D, void* stream) {
  dim3 block(TS, TS);
  dim3 grid((D + TS - 1) / TS, (D + TS - 1) / TS);
  schur_reduce_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(H, W, h, out, F, D);
  return (int)cudaGetLastError();
}
