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
// What bounds it on the H100: the factorization's sequential chain, not
// flops or bytes (~7 MFLOP, 0.3 MB of H). The block keeps the packed lower
// triangle in dynamic shared memory and runs the factorization and the two
// triangular solves of chol.cuh, which K5 (chol_batched.cu) shares.
#include "chol.cuh"

__device__ __forceinline__ int reduced_index(int i, int n_pose, int ex0) {
  if (i < n_pose) return i;
  if (i >= ex0) return n_pose + (i - ex0);
  return -1;
}

__global__ void __launch_bounds__(1024)
    linstep_chol_kernel(const float* __restrict__ H, const float* __restrict__ b,
                        const float* __restrict__ C, const float* __restrict__ cb,
                        const float* __restrict__ lam, float* __restrict__ dx, int D,
                        int n_pose, int Dr) {
  extern __shared__ float sm[];
  float* A = sm;              // packed lower triangle, D(D+1)/2
  float* col = A + tri(D);    // current scaled column / scratch, D
  float* vec = col + D;       // b_s -> y -> dx, D
  float* ldiag = vec + D;     // diag of L, D
  __shared__ float red[32];
  __shared__ float s_tr;
  __shared__ int bad;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const float lamv = *lam;
  const int ex0 = D - (Dr - n_pose);

  // damped diagonal of H_s and b_s; trace of H_d
  float part = 0.0f;
  for (int i = tid; i < D; i += nt) {
    const int ri = reduced_index(i, n_pose, ex0);
    const float hii = H[i * D + i];
    const float hs = hii - (ri >= 0 ? C[ri * Dr + ri] : 0.0f);
    const float dd = hs + lamv * fmaxf(hii, 1e-8f);
    col[i] = dd;
    part += dd;
    vec[i] = b[i] - (ri >= 0 ? cb[ri] : 0.0f);
  }
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  if (tid == 0) bad = 0;
  __syncthreads();
  if (warp == 0) {
    float s = lane < nw ? red[lane] : 0.0f;
    s = warp_sum(s);
    if (lane == 0) s_tr = s;
  }
  __syncthreads();
  const float jit = 1e-12f * s_tr / (float)D;

  // H_dd lower triangle into shared memory
  for (int i = warp; i < D; i += nw) {
    const int ri = reduced_index(i, n_pose, ex0);
    float* Ai = A + tri(i);
    for (int k = lane; k <= i; k += 32) {
      float v;
      if (k == i) {
        v = col[i] + jit;
      } else {
        const int rk = reduced_index(k, n_pose, ex0);
        v = H[i * D + k] - ((ri >= 0 && rk >= 0) ? C[ri * Dr + rk] : 0.0f);
      }
      Ai[k] = v;
    }
  }
  __syncthreads();

  chol_factor_packed(A, col, ldiag, &bad, D);
  if (!bad && warp == 0) chol_solve_packed(A, ldiag, vec, D);
  __syncthreads();
  for (int i = tid; i < D; i += nt) dx[i] = bad ? nanf("") : vec[i];
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

// (ii) + (iii); the caller launches (i) K3 first on the same stream.
ISV_EXPORT int isv_linstep_solve(const float* H, const float* b, const float* C, const float* cb,
                                 const float* W, const float* h, const float* bl,
                                 const float* lam, float* dx, float* dl, int D, int F, int Dr,
                                 int n_pose, void* stream) {
  const int smem = chol_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      linstep_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  linstep_chol_kernel<<<1, 1024, smem, (cudaStream_t)stream>>>(H, b, C, cb, lam, dx, D, n_pose,
                                                              Dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int blocks = (F * 32 + threads - 1) / threads;
  linstep_dl_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(W, h, bl, lam, dx, dl, F, Dr,
                                                                  n_pose, D);
  return (int)cudaGetLastError();
}
