// K3 schur_corr: landmark Schur correction of the reduced camera system.
//
// Replaces isvins_tpu/ops/schur_pallas.py::schur_corr_pallas (Pallas body
// _corr_kernel). Plain version: isvins_tpu_torch/ops/schur.py
// schur_corr_ref.
//
//   C   = W^T diag(1/h) W        (Dr, Dr)
//   c_b = W^T (b_l / h)          (Dr,)
//
// with W (F, Dr) = (1000, 114) at the product window. As in the Pallas
// kernel, one product against [W | b_l] yields both: output column Dr is
// c_b. When `lam` is given (the fused LM step, K4's first launch) h is the
// undamped landmark Hessian and h_safe = guard(h (1 + lam)) is formed here,
// reading lam from device memory (no host sync); otherwise h is h_safe.
//
// What bounds it on the H100: latency. It is a skinny product (~13 MFLOP,
// 0.46 MB of W that stays in L2), far below either roofline, so the design
// is the plain shared-memory tiled product of schur_tile.cuh (shared with
// K7): 16x16 output tiles, F streamed in chunks of 32 rows through shared
// memory (W / h_safe formed once per staged element), 8x8 = 64 blocks.
#include "schur_tile.cuh"

__global__ void schur_corr_kernel(const float* __restrict__ W, const float* __restrict__ h,
                                  const float* __restrict__ bl, const float* __restrict__ lam,
                                  float* __restrict__ C, float* __restrict__ cb, int F, int Dr) {
  const int a0 = blockIdx.y * TS, b0 = blockIdx.x * TS;
  const float acc = schur_tile(W, bl, h, lam, false, F, Dr, a0, b0);
  const int a = a0 + threadIdx.y, b = b0 + threadIdx.x;
  if (a < Dr) {
    if (b < Dr)
      C[a * Dr + b] = acc;
    else if (b == Dr)
      cb[a] = acc;
  }
}

ISV_EXPORT int isv_schur_corr(const float* W, const float* h, const float* bl, const float* lam,
                              float* C, float* cb, int F, int Dr, void* stream) {
  dim3 block(TS, TS);
  dim3 grid((Dr + 1 + TS - 1) / TS, (Dr + TS - 1) / TS);
  schur_corr_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(W, h, bl, lam, C, cb, F, Dr);
  return (int)cudaGetLastError();
}
