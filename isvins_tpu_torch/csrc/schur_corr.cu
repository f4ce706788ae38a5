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
// c_b, and 1/h is multiplied in, not divided by. When `lam` is given (the
// fused LM step, K4's first launch) h is the undamped landmark Hessian and
// h_safe = guard(h (1 + lam)) is formed here, reading lam from device memory
// (no host sync); otherwise h is h_safe.
//
// What bounds it on the H100: latency. It is a skinny product (~26 MFLOP,
// 0.46 MB of W that stays in L2), far below either roofline: 0.4 us of FP32
// work beside an empty kernel's 0.9 us. So the design (schur_tile.cuh, shared
// with K7) spends SMs to shorten the chain: the 10 lower-triangle 32x32
// tiles and 4 tiles for the c_b column, each split over F into a cluster of
// 16 blocks of 63 rows (224 blocks), whose cp.async chunks are all in flight
// at once (8-byte copies: the rows are 456 bytes), one ordered sum through
// distributed shared memory, and the epilogue below, which mirrors each entry
// so that C is exactly symmetric.
#include "schur_tile.cuh"

struct CorrEpilogue {
  float* C;
  float* cb;
  int Dr;
  __device__ __forceinline__ void operator()(int a, int b, float s) const {
    if (b == Dr) {
      cb[a] = s;
    } else {
      C[(size_t)a * Dr + b] = s;
      if (b != a) C[(size_t)b * Dr + a] = s;
    }
  }
};

template <int TILE, int VEC>
__global__ void __launch_bounds__(SCHUR_THREADS)
    schur_corr_kernel(const float* __restrict__ W, const float* __restrict__ h,
                      const float* __restrict__ bl, const float* __restrict__ lam,
                      float* __restrict__ C, float* __restrict__ cb, int F, int Dr, int splits) {
  schur_tile<TILE, VEC>(W, bl, h, lam, false, F, Dr, splits, CorrEpilogue{C, cb, Dr});
}

// tile, splits, n_tiles, copy_bytes: schur_plan(F, Dr, extra column) of
// isvins_tpu_torch/ops/schur.py.
ISV_EXPORT int isv_schur_corr(const float* W, const float* h, const float* bl, const float* lam,
                              float* C, float* cb, int F, int Dr, int tile, int splits,
                              int n_tiles, int copy_bytes, void* stream) {
  if (!schur_plan_ok(W, F, Dr, tile, splits, n_tiles, copy_bytes))
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const float*, const float*, const float*, const float*, float*, float*, int,
                 int, int) = nullptr;
  SCHUR_PICK(kernel, schur_corr_kernel, tile, copy_bytes);
  return (int)schur_launch(kernel, tile, n_tiles * splits, splits, (cudaStream_t)stream, W, h,
                           bl, lam, C, cb, F, Dr, splits);
}
