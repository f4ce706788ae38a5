// K7 schur_reduce: the full landmark Schur reduction of the window system.
//
// Replaces isvins_tpu/ops/schur_pallas.py::schur_reduce_pallas (Pallas body
// _kernel). Plain version: isvins_tpu_torch/ops/schur.py schur_reduce_ref.
//
//   H_s = H - W^T diag(1/h) W        (D, D),  W (F, D) = (1000, 276)
//   b_s = b - W^T (b_l / h)          (D,)
//
// Landmarks with h <= 1e-12 (empty slots) count as h = 1. The reference
// forms b_s outside its kernel; here it is the extra column of the same
// product, as in K3, so the whole reduction is one launch.
//
// What bounds it on the H100: ~153 MFLOP of f32 FMA work (2.3 us at the
// card's peak) against 1.7 MB, so arithmetic by the roofline, and at this size
// the launch and the chain of dependent steps in each block. The product is
// K3's at full width, through the same tile routine (schur_tile.cuh): the 15
// lower-triangle 64x64 tiles and 5 tiles for the b_s column, each split over
// F into a cluster of 16 blocks of 63 rows (320 blocks of 64.5 KB, three to
// an SM), 4x4 outputs per thread, 16-byte cp.async copies (1,104-byte rows).
// The epilogue subtracts from H: (a, b) from H[a, b] and its mirror from
// H[b, a], so H need not be symmetric, and H_s is as symmetric as H is.
#include "schur_tile.cuh"

struct ReduceEpilogue {
  const float* H;
  const float* b;
  float* Hs;
  float* bs;
  int D;
  __device__ __forceinline__ void operator()(int a, int c, float s) const {
    if (c == D) {
      bs[a] = b[a] - s;
    } else {
      Hs[(size_t)a * D + c] = H[(size_t)a * D + c] - s;
      if (c != a) Hs[(size_t)c * D + a] = H[(size_t)c * D + a] - s;
    }
  }
};

template <int TILE, int VEC>
__global__ void __launch_bounds__(SCHUR_THREADS)
    schur_reduce_kernel(const float* __restrict__ H, const float* __restrict__ b,
                        const float* __restrict__ W, const float* __restrict__ h,
                        const float* __restrict__ bl, float* __restrict__ Hs,
                        float* __restrict__ bs, int F, int D, int splits) {
  schur_tile<TILE, VEC>(W, bl, h, nullptr, true, F, D, splits, ReduceEpilogue{H, b, Hs, bs, D});
}

// tile, splits, n_tiles, copy_bytes: schur_plan(F, D, extra column) of
// isvins_tpu_torch/ops/schur.py.
ISV_EXPORT int isv_schur_reduce(const float* H, const float* b, const float* W, const float* h,
                                const float* bl, float* Hs, float* bs, int F, int D, int tile,
                                int splits, int n_tiles, int copy_bytes, void* stream) {
  if (!schur_plan_ok(W, F, D, tile, splits, n_tiles, copy_bytes))
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const float*, const float*, const float*, const float*, const float*, float*,
                 float*, int, int, int) = nullptr;
  SCHUR_PICK(kernel, schur_reduce_kernel, tile, copy_bytes);
  return (int)schur_launch(kernel, tile, n_tiles * splits, splits, (cudaStream_t)stream, H, b,
                           W, h, bl, Hs, bs, F, D, splits);
}
