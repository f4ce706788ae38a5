// K5 chol_solve_batched: NB independent dense SPD solves x[n] = H[n]^-1 b[n].
//
// Replaces isvins_tpu/ops/linstep_pallas.py::chol_solve_batched_pallas
// (Pallas body _make_chol_kernel): the factorization and both triangular
// solves of the multi-sequence LM step. Plain version:
// isvins_tpu_torch/ops/chol_batched.py chol_solve_batched_ref.
//
// It computes what the TPU body computes, per problem, not its layout. The
// TPU kernel advances all NB problems in one program, the batch riding the
// sublanes; a GPU has 132 SMs, so here every problem gets its own thread
// block and the NB factorizations run side by side on NB SMs (one block per
// SM: 177,664 B of dynamic shared memory at D = 276 in tiles of 16; above
// D = 320 the tiles live in a device-memory scratch, a region per problem).
// Each block copies its H into the tiles of chol.cuh (shared with K4) with
// identity padding, factors and solves, and writes its x.
//
// A pivot that is not > 0 (H[n] not SPD, or NaN) makes x[n] all NaN, as the
// plain version does, so the LM accept test rejects that sequence's step;
// the other problems of the batch are untouched.
//
// What bounds it on the H100: per block the chain of D / nb panel steps
// (the panel and the trailing update spread over the warps, the next
// diagonal tile factored by one warp beside them, two barriers each) and
// the SM's shared-memory bandwidth beside ~D^3/6 FMAs; not flops
// (NB (D^3/3 + 2 D^2)) or device memory.
#include "chol.cuh"

template <bool GLOBAL>
__global__ void __launch_bounds__(CHOL_THREADS)
    chol_solve_batched_kernel(const float* __restrict__ H, const float* __restrict__ b,
                              float* __restrict__ x, float* scratch, int D) {
  extern __shared__ __align__(16) float sm[];
  const CholPlan plan = chol_plan(D);
  float* tiles = chol_tiles_of<GLOBAL>(sm, scratch, plan, blockIdx.x);
  float* vec = chol_vectors_of<GLOBAL>(sm, plan);        // b -> y -> x, Dp
  int* bad = reinterpret_cast<int*>(vec + 2 * plan.Dp);  // after the unused aux vector

  const int tid = threadIdx.x, nt = blockDim.x;
  const float* Hn = H + (size_t)blockIdx.x * D * D;
  const float* bn = b + (size_t)blockIdx.x * D;
  float* xn = x + (size_t)blockIdx.x * D;

  chol_fill(tiles, plan.T, D, [&](int a, int k) { return Hn[(size_t)a * D + k]; });
  for (int i = tid; i < plan.Dp; i += nt) vec[i] = i < D ? bn[i] : 0.0f;
  if (tid == 0) *bad = 0;
  __syncthreads();

  chol_factor_tiles(tiles, plan.T, bad);
  if (!*bad) chol_solve_tiles(tiles, vec, plan.T);
  for (int i = tid; i < D; i += nt) xn[i] = *bad ? nanf("") : vec[i];
}

template <bool GLOBAL>
static cudaError_t launch_chol_batched(const float* H, const float* b, float* x, float* scratch,
                                      int NB, int D, int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_batched_kernel<GLOBAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  chol_solve_batched_kernel<GLOBAL><<<NB, CHOL_THREADS, smem, st>>>(H, b, x, scratch, D);
  return cudaGetLastError();
}

// `scratch`: NB * chol_plan(D).scratch_floats floats of device memory where
// the plan takes the global route, else unused (may be null).
ISV_EXPORT int isv_chol_solve_batched(const float* H, const float* b, float* x, float* scratch,
                                      int NB, int D, void* stream) {
  const CholPlan plan = chol_plan(D);
  if (plan.scratch_floats > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(plan.scratch_floats > 0
                   ? launch_chol_batched<true>(H, b, x, scratch, NB, D, plan.smem_bytes, st)
                   : launch_chol_batched<false>(H, b, x, scratch, NB, D, plan.smem_bytes, st));
}

// The layout chol_plan gives D, as five ints (nb, Dp, tiles, smem_bytes,
// scratch_floats) into `out` (host memory), for the check that the Python
// plan is the same. Launches nothing; the stream argument, which every
// entry point takes, is unused.
ISV_EXPORT int isv_chol_plan(int D, int* out, void* stream) {
  (void)stream;
  const CholPlan p = chol_plan(D);
  out[0] = p.nb, out[1] = p.Dp, out[2] = p.tiles, out[3] = p.smem_bytes;
  out[4] = p.scratch_floats;
  return 0;
}
