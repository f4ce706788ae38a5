// The tile routine of the landmark Schur products
//
//   W^T diag(1/h) [W | b_l]      W (F, n) row-major, h and b_l (F,)
//
// shared by K3 (schur_corr.cu, n = Dr = 114) and K7 (schur_reduce.cu,
// n = D = 276). The outputs are few (n x (n + 1)) and F = 1000 is long, so
// on the H100 the product is bound by latency, not by the FP32 pipes or by
// memory: what counts is how many SMs take part and how short the chain of
// dependent steps in each of them is. The design, with the shapes and the
// decomposition chosen in Python (isvins_tpu_torch/ops/schur.py schur_plan):
//
// - Symmetry: only the tiles on or below the diagonal are computed; the
//   epilogue writes each entry (a, b), a > b, to both places, so the result
//   is exactly symmetric. Column n of [W | b_l] lies above the diagonal for
//   every row, so it has tiles of its own (one per row tile, after the lower
//   triangle), in the same launch.
// - Split over F: the `splits` blocks of one tile form a thread block
//   cluster (up to 16, the H100's largest; launched with
//   cudaLaunchKernelEx); block `rank` sums rows [rank * rps, (rank + 1) * rps)
//   of F. Each leaves its partial tile in shared memory; after the cluster's
//   barrier every rank sums a slice of the tile over the partials of ranks 0,
//   1, ... in that order, reading them through distributed shared memory
//   with all reads of one entry in flight together. One launch, no workspace
//   in device memory, no atomics: results repeat bit for bit. (A second
//   pass over partials in device memory gave the same bits and took longer
//   at both widths on the H100: a second launch and a round trip through L2.)
// - Register tiling: 256 threads, each owning (TILE/16)^2 outputs (4 x 4 at
//   TILE = 64), so one vector load per operand from shared memory feeds
//   TILE/16 squared FMAs, written as __fmaf_rn whatever -fmad says.
// - Loads in flight: the F rows are streamed in chunks of SCHUR_FK rows
//   through a ring of SCHUR_STAGES stages filled with cp.async, so the rows
//   of a block at F = 1000 (63 in a cluster of 16) are all requested at once
//   and the block pays one round trip to memory, not one per chunk. The
//   copy width (VEC floats) is chosen at launch from n and the alignment of
//   W (n = 114 has 456-byte rows: 8 bytes at most), so W is never padded or
//   copied.
// - 1/h once: one thread per row forms r_f = 1 / h_safe(f) (lam read once
//   per block); each thread then scales the elements of the second operand
//   that it staged itself, so the product loop is FMAs only.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define SCHUR_FK 32         // rows of W per staged chunk
#define SCHUR_STAGES 4      // chunks in flight per operand
#define SCHUR_THREADS 256   // 16 x 16 threads
#define SCHUR_MAX_SPLITS 16  // the H100's largest cluster (beyond 8: not portable)

// Dynamic shared memory of one block: both operands' stages and 1 / h_safe.
constexpr int schur_smem_bytes(int tile) {
  return (2 * SCHUR_STAGES * SCHUR_FK * tile + SCHUR_STAGES * SCHUR_FK) * 4;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int TM>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (TM == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x, dst[1] = v.y;
  }
}

// The staging loops below all walk the chunk's vectors in one order, so the
// thread that stages an element is the thread that scales it.
//
// Rows [f0, f0 + SCHUR_FK) x columns [c0, c0 + TILE) of W into
// dst[SCHUR_FK][TILE]; rows >= f_end and columns >= n are zero. VEC divides
// n, so a vector that starts inside a row ends inside it.
template <int TILE, int VEC>
__device__ __forceinline__ void stage_w(float* dst, const float* __restrict__ W, int n, int f0,
                                        int f_end, int c0, int tid) {
  constexpr int VPR = TILE / VEC;  // vectors per row
  for (int v = tid; v < SCHUR_FK * VPR; v += SCHUR_THREADS) {
    const int ff = v / VPR, cc = (v % VPR) * VEC;
    const int f = f0 + ff, c = c0 + cc;
    float* d = dst + ff * TILE + cc;
    if (f < f_end && c < n) {
      cp_async<4 * VEC>(d, W + (size_t)f * n + c);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) d[e] = 0.0f;
    }
  }
}

// The extra column: b_l in column 0 of dst, zeros elsewhere.
template <int TILE, int VEC>
__device__ __forceinline__ void stage_bl(float* dst, const float* __restrict__ bl, int f0,
                                         int f_end, int tid) {
  constexpr int VPR = TILE / VEC;
  for (int v = tid; v < SCHUR_FK * VPR; v += SCHUR_THREADS) {
    const int ff = v / VPR, cc = (v % VPR) * VEC;
    const int f = f0 + ff;
    float* d = dst + ff * TILE + cc;
#pragma unroll
    for (int e = 0; e < VEC; ++e) d[e] = (cc + e == 0 && f < f_end) ? bl[f] : 0.0f;
  }
}

template <int TILE, int VEC>
__device__ __forceinline__ void scale_own(float* dst, const float* r, int tid) {
  constexpr int VPR = TILE / VEC;
  for (int v = tid; v < SCHUR_FK * VPR; v += SCHUR_THREADS) {
    const int ff = v / VPR, cc = (v % VPR) * VEC;
    float* d = dst + ff * TILE + cc;
    const float rf = r[ff];
#pragma unroll
    for (int e = 0; e < VEC; ++e) d[e] *= rf;
  }
}

// For the calling block of a cluster of `splits` blocks (blockIdx.x =
// tile * splits + rank): the block's share of tile `tile` of
// W^T diag(1/h_safe) [W | bl], then the cluster's ordered sum, then
// ep(a, b, value) for every entry the block is left to write: a the row,
// b the column of [W | bl] (b == n is the bl column), called only for
// b <= a or b == n; the epilogue mirrors (a, b) to (b, a) itself.
//
// h_safe: `lam` (device scalar, may be null) means h is the undamped landmark
// Hessian and h (1 + lam) is formed here; `guard` (or lam): values that are
// not > 1e-12 count as 1 (an empty landmark). With lam null and guard false,
// h is used as given.
// All SCHUR_THREADS threads of all blocks must call it.
template <int TILE, int VEC, class Epilogue>
__device__ __forceinline__ void schur_tile(const float* __restrict__ W,
                                           const float* __restrict__ bl,
                                           const float* __restrict__ h,
                                           const float* __restrict__ lam, bool guard, int F, int n,
                                           int splits, Epilogue ep) {
  constexpr int TM = TILE / 16;  // outputs per thread: TM x TM
  constexpr int STAGE = SCHUR_FK * TILE;  // floats of one staged operand chunk
  static_assert(TILE == 32 || TILE == 64, "TILE");
  static_assert(SCHUR_STAGES * SCHUR_FK >= TILE, "the partial tile reuses the first operand");
  static_assert(SCHUR_STAGES * SCHUR_FK <= SCHUR_THREADS, "one thread per row of the prologue");
  extern __shared__ __align__(16) float schur_smem[];  // schur_smem_bytes(TILE)
  float* sA = schur_smem;                   // [SCHUR_STAGES][STAGE]
  float* sB = sA + SCHUR_STAGES * STAGE;    // [SCHUR_STAGES][STAGE]
  float* sR = sB + SCHUR_STAGES * STAGE;    // [SCHUR_STAGES][SCHUR_FK]: 1 / h_safe

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / splits;

  // tile -> (ti, tj): the lower triangle row by row, then the bl column
  const int nrt = (n + TILE - 1) / TILE;
  const int n_lower = nrt * (nrt + 1) / 2;
  const bool is_bl = tile >= n_lower;
  int ti = 0, tj = 0;
  if (is_bl) {
    ti = tile - n_lower;
  } else {
    while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
    tj = tile - ti * (ti + 1) / 2;
  }
  const int a0 = ti * TILE, b0 = tj * TILE;

  const int rps = (F + splits - 1) / splits;
  const int f_lo = min(rank * rps, F), f_hi = min(f_lo + rps, F);
  const int nchunks = (f_hi - f_lo + SCHUR_FK - 1) / SCHUR_FK;
  const bool damp = lam != nullptr;
  const float scale = damp ? 1.0f + *lam : 1.0f;

  // chunk k of the block's rows into stage k % SCHUR_STAGES (the caller commits)
  auto stage_chunk = [&](int k) {
    const int s = k % SCHUR_STAGES, f0 = f_lo + k * SCHUR_FK;
    stage_w<TILE, VEC>(sA + s * STAGE, W, n, f0, f_hi, a0, tid);
    if (is_bl)
      stage_bl<TILE, VEC>(sB + s * STAGE, bl, f0, f_hi, tid);
    else
      stage_w<TILE, VEC>(sB + s * STAGE, W, n, f0, f_hi, b0, tid);
  };
  // 1 / h_safe of row `row` of chunk k (0 past the block's rows)
  auto recip = [&](int k, int row) {
    const int f = f_lo + k * SCHUR_FK + row;
    float r = 0.0f;
    if (f < f_hi) {
      float v = h[f];
      if (damp) v = v * scale;
      if (damp || guard) v = v > 1e-12f ? v : 1.0f;
      r = 1.0f / v;
    }
    sR[(k % SCHUR_STAGES) * SCHUR_FK + row] = r;
  };

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;

  // Every stage is free at the start: put the first SCHUR_STAGES chunks in
  // flight together, then one thread per row forms their 1 / h_safe. One
  // group is committed per chunk slot, filled or not, so that "chunk k has
  // landed" is always "at most SCHUR_STAGES - 1 groups pending".
#pragma unroll
  for (int k = 0; k < SCHUR_STAGES; ++k) {
    if (k < nchunks) stage_chunk(k);
    cp_async_commit();
  }
  if (tid < SCHUR_STAGES * SCHUR_FK && tid / SCHUR_FK < nchunks)
    recip(tid / SCHUR_FK, tid % SCHUR_FK);
  __syncthreads();  // sR is visible
  for (int k = 0; k < nchunks; ++k) {
    if (k > 0) {  // the stage of chunk k - 1 is free since the barrier that ended it
      const int kn = k + SCHUR_STAGES - 1;
      if (kn < nchunks) {
        stage_chunk(kn);
        if (tid < SCHUR_FK) recip(kn, tid);  // read at chunk kn, barriers away
      }
      cp_async_commit();
    }
    cp_async_wait<SCHUR_STAGES - 1>();
    const int s = k % SCHUR_STAGES;
    scale_own<TILE, VEC>(sB + s * STAGE, sR + s * SCHUR_FK, tid);
    __syncthreads();
    const float* A = sA + s * STAGE + ty * TM;
    const float* B = sB + s * STAGE + tx * TM;
#pragma unroll 8
    for (int ff = 0; ff < SCHUR_FK; ++ff) {
      float a[TM], b[TM];
      load_vec<TM>(a, A + ff * TILE);
      load_vec<TM>(b, B + ff * TILE);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // before a later load overwrites this stage
  }

  // the partial tile, row-major, where the first operand was staged
  float* part = sA;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) part[(ty * TM + i) * TILE + tx * TM + j] = acc[i][j];
  cluster.sync();
  // Rank r sums entries [r * per, (r + 1) * per) of the tile over the ranks
  // in order; the remote reads of one entry are in flight together.
  const int per = TILE * TILE / splits;  // splits is a power of two
  for (int idx = rank * per + tid; idx < (rank + 1) * per; idx += SCHUR_THREADS) {
    float v[SCHUR_MAX_SPLITS];
#pragma unroll
    for (int q = 0; q < SCHUR_MAX_SPLITS; ++q)
      v[q] = q < splits ? cluster.map_shared_rank(part, q)[idx] : 0.0f;
    float s = v[0];
#pragma unroll
    for (int q = 1; q < SCHUR_MAX_SPLITS; ++q)
      if (q < splits) s = __fadd_rn(s, v[q]);
    const int a = a0 + idx / TILE, col = idx % TILE;
    if (a >= n) continue;
    if (is_bl) {
      if (col == 0) ep(a, n, s);
    } else if (b0 + col <= a) {
      ep(a, b0 + col, s);
    }
  }
  cluster.sync();  // no block leaves while its partial may still be read
}

// Launch `kernel` (an instantiation for `tile`) on blocks of SCHUR_THREADS
// threads in clusters of `splits`.
template <class... Params, class... Args>
inline cudaError_t schur_launch(void (*kernel)(Params...), int tile, int blocks, int splits,
                                cudaStream_t stream, Args... args) {
  const int smem = schur_smem_bytes(tile);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(SCHUR_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// What schur_plan chose must be what the kernel can run: a tile of 32 or
// 64, a power-of-two split count up to the largest cluster, a copy
// width that divides the rows and matches W's alignment, and the tile count
// of this n.
inline bool schur_plan_ok(const float* W, int F, int n, int tile, int splits, int n_tiles,
                          int copy_bytes) {
  if (F < 1 || n < 1) return false;
  if (tile != 32 && tile != 64) return false;
  if (splits < 1 || splits > SCHUR_MAX_SPLITS || (splits & (splits - 1))) return false;
  if (copy_bytes != 4 && copy_bytes != 8 && copy_bytes != 16) return false;
  if ((n * 4) % copy_bytes || (size_t)W % copy_bytes) return false;
  const int nrt = (n + tile - 1) / tile;
  return n_tiles == nrt * (nrt + 1) / 2 + nrt;  // the lower triangle and the extra column
}

// fn = the instantiation of KERNEL<TILE, VEC> for a tile and a copy width.
#define SCHUR_PICK(fn, KERNEL, tile, copy_bytes) \
  do {                                           \
    if ((tile) == 64) {                          \
      if ((copy_bytes) == 16)                    \
        fn = KERNEL<64, 4>;                      \
      else if ((copy_bytes) == 8)                \
        fn = KERNEL<64, 2>;                      \
      else                                       \
        fn = KERNEL<64, 1>;                      \
    } else {                                     \
      if ((copy_bytes) == 16)                    \
        fn = KERNEL<32, 4>;                      \
      else if ((copy_bytes) == 8)                \
        fn = KERNEL<32, 2>;                      \
      else                                       \
        fn = KERNEL<32, 1>;                      \
    }                                            \
  } while (0)
