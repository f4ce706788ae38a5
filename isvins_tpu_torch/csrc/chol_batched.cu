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
// SM: 156,216 B of dynamic shared memory at D = 276). Each block copies the
// lower triangle of its H into packed shared memory, runs the routines of
// chol.cuh (shared with K4) and writes its x.
//
// A pivot that is not > 0 (H[n] not SPD, or NaN) makes x[n] all NaN, as the
// plain version does, so the LM accept test rejects that sequence's step;
// the other problems of the batch are untouched.
//
// What bounds it on the H100: per block the chain of D dependent column
// steps (two barriers each), not flops (NB (D^3/3 + 2 D^2)) or bytes.
#include "chol.cuh"

__global__ void __launch_bounds__(1024)
    chol_solve_batched_kernel(const float* __restrict__ H, const float* __restrict__ b,
                              float* __restrict__ x, int D) {
  extern __shared__ float sm[];
  float* A = sm;            // packed lower triangle, D(D+1)/2
  float* col = A + tri(D);  // scratch column, D
  float* vec = col + D;     // b -> y -> x, D
  float* ldiag = vec + D;   // diag of L, D
  __shared__ int bad;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const float* Hn = H + (size_t)blockIdx.x * D * D;
  const float* bn = b + (size_t)blockIdx.x * D;
  float* xn = x + (size_t)blockIdx.x * D;

  for (int i = warp; i < D; i += nw) {
    float* Ai = A + tri(i);
    for (int k = lane; k <= i; k += 32) Ai[k] = Hn[(size_t)i * D + k];
  }
  for (int i = tid; i < D; i += nt) vec[i] = bn[i];
  if (tid == 0) bad = 0;
  __syncthreads();

  chol_factor_packed(A, col, ldiag, &bad, D);
  if (!bad && warp == 0) chol_solve_packed(A, ldiag, vec, D);
  __syncthreads();
  for (int i = tid; i < D; i += nt) xn[i] = bad ? nanf("") : vec[i];
}

ISV_EXPORT int isv_chol_solve_batched(const float* H, const float* b, float* x, int NB, int D,
                                      void* stream) {
  const int smem = chol_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  chol_solve_batched_kernel<<<NB, 1024, smem, (cudaStream_t)stream>>>(H, b, x, D);
  return (int)cudaGetLastError();
}
