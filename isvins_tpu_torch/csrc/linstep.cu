// K4 linstep: the whole Levenberg-Marquardt linear step of the window solve.
//
// Replaces isvins_tpu/ops/linstep_pallas.py::linstep_pallas (Pallas body
// _make_kernel, wrapper _linstep_impl). Plain version:
// isvins_tpu_torch/ops/linstep.py linstep_ref (the JAX linstep_ref math).
//
// Three launches on the caller's stream, no host sync (lam is read from
// device memory):
//   (i)   K3 schur_corr (csrc/schur_corr.cu) with lam: C, c_b at h_safe;
//   (ii)  linstep_chol_kernel, ONE block: forms H_dd, factors it, solves;
//   (iii) linstep_dl_kernel: dl = (b_l - W dx_r) / h_safe, a warp per
//         landmark.
//
// (ii) in detail, D = 15B + 6 = 276, reduced layout Dr = 6B + 6:
//   H_s  = H - insert(C),  b_s = b - insert(c_b)   (index arithmetic:
//          reduced [0, n_pose) -> full [0, n_pose), reduced [n_pose, Dr)
//          -> full [D-6, D); no scatter matrix)
//   H_d  = H_s + diag(lam * max(diag H, 1e-8))
//   H_dd = H_d + 1e-12 trace(H_d) / D * I         (linstep_ref's jitter)
//   L L^T = H_dd;  L y = b_s;  L^T dx = y
// A pivot that is not > 0 (H_dd not SPD) makes dx all NaN, as
// jnp.linalg.cholesky does, so the LM accept test rejects the step.
//
// What bounds it on the H100: the factorization's chain of dependent steps,
// not flops or bytes (~7 MFLOP, 0.3 MB of H). The block writes H_dd
// straight into the tiles of chol.cuh (blocked Cholesky: 18 panels of 16 at
// D = 276, two barriers each, register-tiled trailing updates, the next
// diagonal tile factored ahead; solves by tile rows in one warp), the
// routine K5 (chol_batched.cu) shares: in shared memory up to D = 320, in
// a device-memory scratch from the wrapper above (chol_plan's route).
#include "chol.cuh"

__device__ __forceinline__ int reduced_index(int i, int n_pose, int ex0) {
  if (i < n_pose) return i;
  if (i >= ex0) return n_pose + (i - ex0);
  return -1;
}

template <bool GLOBAL>
__global__ void __launch_bounds__(CHOL_THREADS)
    linstep_chol_kernel(const float* __restrict__ H, const float* __restrict__ b,
                        const float* __restrict__ C, const float* __restrict__ cb,
                        const float* __restrict__ lam, float* __restrict__ dx,
                        float* scratch, int D, int n_pose, int Dr) {
  extern __shared__ __align__(16) float sm[];
  const CholPlan plan = chol_plan(D);
  float* tiles = chol_tiles_of<GLOBAL>(sm, scratch, plan, 0);
  float* vec = chol_vectors_of<GLOBAL>(sm, plan);  // b_s -> y -> dx, Dp
  float* aux = vec + plan.Dp;                           // damped diagonal, Dp
  float* red = aux + plan.Dp;                           // 32 warp sums
  float* s_tr = red + 32;
  int* bad = reinterpret_cast<int*>(s_tr + 1);

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const float lamv = *lam;
  const int ex0 = D - (Dr - n_pose);

  // damped diagonal of H_s and b_s (zero in the padding); trace of H_d
  float part = 0.0f;
  for (int i = tid; i < plan.Dp; i += nt) {
    if (i >= D) {
      vec[i] = 0.0f;
      continue;
    }
    const int ri = reduced_index(i, n_pose, ex0);
    const float hii = H[i * D + i];
    const float hs = hii - (ri >= 0 ? C[ri * Dr + ri] : 0.0f);
    const float dd = hs + lamv * fmaxf(hii, 1e-8f);
    aux[i] = dd;
    part += dd;
    vec[i] = b[i] - (ri >= 0 ? cb[ri] : 0.0f);
  }
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  if (tid == 0) *bad = 0;
  __syncthreads();
  if (warp == 0) {
    float s = lane < nw ? red[lane] : 0.0f;
    s = warp_sum(s);
    if (lane == 0) *s_tr = s;
  }
  __syncthreads();
  const float jit = 1e-12f * *s_tr / (float)D;

  // H_dd into the tiles
  chol_fill(tiles, plan.T, D, [&](int a, int k) {
    if (a == k) return aux[a] + jit;
    const int ra = reduced_index(a, n_pose, ex0), rk = reduced_index(k, n_pose, ex0);
    return H[a * D + k] - ((ra >= 0 && rk >= 0) ? C[ra * Dr + rk] : 0.0f);
  });
  __syncthreads();

  chol_factor_tiles(tiles, plan.T, bad);
  if (!*bad) chol_solve_tiles(tiles, vec, plan.T);
  for (int i = tid; i < D; i += nt) dx[i] = *bad ? nanf("") : vec[i];
}

__global__ void linstep_dl_kernel(const float* __restrict__ W, const float* __restrict__ h,
                                  const float* __restrict__ bl, const float* __restrict__ lam,
                                  const float* __restrict__ dx, float* __restrict__ dl, int F,
                                  int Dr, int n_pose, int D) {
  const int gw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= F) return;  // uniform per warp
  const int ex0 = D - (Dr - n_pose);
  const float* Wf = W + (size_t)gw * Dr;
  float s = 0.0f;
  for (int a = lane; a < Dr; a += 32) {
    const float x = a < n_pose ? dx[a] : dx[ex0 + a - n_pose];
    s += Wf[a] * x;
  }
  s = warp_sum(s);
  if (lane == 0) {
    float hd = h[gw] * (1.0f + *lam);
    hd = hd > 1e-12f ? hd : 1.0f;
    dl[gw] = (bl[gw] - s) / hd;
  }
}

template <bool GLOBAL>
static cudaError_t launch_linstep_chol(const float* H, const float* b, const float* C,
                                      const float* cb, const float* lam, float* dx,
                                      float* scratch, int D, int n_pose, int Dr, int smem,
                                      cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(linstep_chol_kernel<GLOBAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  linstep_chol_kernel<GLOBAL><<<1, CHOL_THREADS, smem, st>>>(H, b, C, cb, lam, dx, scratch, D,
                                                            n_pose, Dr);
  return cudaGetLastError();
}

// (ii) + (iii); the caller launches (i) K3 first on the same stream.
// `scratch`: chol_plan(D).scratch_floats floats of device memory where the
// plan takes the global route, else unused (may be null).
ISV_EXPORT int isv_linstep_solve(const float* H, const float* b, const float* C, const float* cb,
                                 const float* W, const float* h, const float* bl,
                                 const float* lam, float* dx, float* dl, float* scratch, int D,
                                 int F, int Dr, int n_pose, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const CholPlan plan = chol_plan(D);
  if (plan.scratch_floats > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      plan.scratch_floats > 0
          ? launch_linstep_chol<true>(H, b, C, cb, lam, dx, scratch, D, n_pose, Dr,
                                      plan.smem_bytes, st)
          : launch_linstep_chol<false>(H, b, C, cb, lam, dx, scratch, D, n_pose, Dr,
                                       plan.smem_bytes, st);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int blocks = (F * 32 + threads - 1) / threads;
  linstep_dl_kernel<<<blocks, threads, 0, st>>>(W, h, bl, lam, dx, dl, F, Dr, n_pose, D);
  return (int)cudaGetLastError();
}
