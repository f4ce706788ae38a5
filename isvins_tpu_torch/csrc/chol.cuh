// Blocked dense Cholesky and blocked triangular solves of one SPD system in
// one thread block, shared by K4 (linstep.cu, one problem) and K5
// (chol_batched.cu, one problem per block). It computes what the TPU bodies
// compute (isvins_tpu/ops/linstep_pallas.py, _make_kernel :156-218 and
// _make_chol_kernel :345-405: a right-looking Cholesky by panels, then
// substitution by panels), laid out for an SM rather than for (8, 128) tiles.
//
// What bounds it on the H100: the chain of dependent steps and the SM's
// shared-memory bandwidth (128 bytes a cycle), not flops (~D^3/6 = 3.5 M
// FMAs at D = 276, 16 us of one SM's FP32 lanes) or device memory. The design:
//
// - Storage: the lower triangle as 16 x 16 tiles, tile (I, J), I >= J, at
//   number I(I+1)/2 + J, 256 floats each, in dynamic shared memory where
//   they fit one block's 232,448 B (D <= 320, the shared route), else in a
//   scratch of device memory that the wrapper allocates, one region per
//   problem (the global route: 0.47 MB at D = 486, resident in the 50 MB
//   L2); the vectors stay in shared memory either way. Every routine below
//   takes the tiles through a plain pointer, so one code serves both
//   routes, and each kernel is instantiated for each (the shared one as
//   before, with shared-memory loads). D is
//   padded to Dp = 16 T with the identity (diagonal 1, 0 elsewhere), so
//   padded pivots stay 1 and padded x stays 0. Within a tile, the four
//   16-byte chunks of row r are stored in the order chunk ^ ((r / 4) % 4)
//   (chol_at), so that every 16-byte load and store of the tile products
//   below meets no bank conflict. The geometry is chol_plan, mirrored in
//   isvins_tpu_torch/ops/chol_batched.py chol_plan.
// - Per panel p, two block barriers: (1) every warp turns tile rows of the
//   panel into L_ip = A_ip Linv_pp^T; (2) every warp but the first updates
//   lower trailing tiles, A_ij -= L_ip L_jp^T for p < j <= i, while warp 0
//   updates the next diagonal tile and factors it (look-ahead): the pivot
//   goes round by shuffle, 1 / sqrt is one rsqrtf, a pivot that is not > 0
//   sets the flag, and the tile is replaced by the inverse of its factor,
//   Linv. A tile product is one half-warp's: each lane owns 4 rows x 4
//   contiguous columns, so one 16-byte load of each operand feeds 16
//   explicit FMAs (__fmaf_rn, whatever -fmad says) and the output tile is
//   read and written with 16-byte accesses. At D = 276: 18 panels, 36
//   barriers (the unblocked column sweep took 552).
// - Solves by tile rows with the stored Linv, one barrier per panel each
//   way: forward y_p = Linv_pp r_p (a 16-term dot product per lane), then
//   r_i -= L_ip y_p for every row below, a thread per row, while the warp
//   that owns the next block's rows goes on to solve it; backward the same
//   with Linv_pp^T and the tile columns.
#pragma once

#include <math.h>

#include "common.cuh"

#define CHOL_NB 16        // tile edge
#define CHOL_THREADS 512  // threads of a block running the routine
#define CHOL_MISC 64      // floats after the tiles and vectors: block sums and the flag
#define CHOL_SMEM_LIMIT 232448  // bytes of shared memory one block may use (H100)

// The layout for D unknowns in tiles of nb: the same numbers as
// ops/chol_batched.chol_plan (chip_smoke.py holds the two against each other).
// smem_bytes is the dynamic shared memory a block is launched with;
// scratch_floats the device-memory scratch of one problem (0: the shared
// route, the tiles in shared memory).
struct CholPlan {
  int nb, Dp, T, tiles, smem_bytes, scratch_floats;
};

__host__ __device__ inline CholPlan chol_plan(int D) {
  CholPlan p;
  p.nb = CHOL_NB;
  p.T = (D + CHOL_NB - 1) / CHOL_NB;
  p.Dp = p.T * CHOL_NB;
  p.tiles = p.T * (p.T + 1) / 2;
  // [tiles], then vec (rhs -> y -> x) and aux (Dp each), then CHOL_MISC
  const int vectors = (2 * p.Dp + CHOL_MISC) * (int)sizeof(float);
  const int tiles = p.tiles * CHOL_NB * CHOL_NB * (int)sizeof(float);
  const bool shared = tiles + vectors <= CHOL_SMEM_LIMIT;
  p.smem_bytes = shared ? tiles + vectors : vectors;
  p.scratch_floats = shared ? 0 : p.tiles * CHOL_NB * CHOL_NB;
  return p;
}

// The tiles of problem n: the start of dynamic shared memory on the shared
// route, its region of the scratch on the global route (GLOBAL is a
// template argument of the kernels, so the shared route keeps shared-memory
// addressing); the vectors follow the tiles in shared memory, or start it.
template <bool GLOBAL>
__device__ __forceinline__ float* chol_tiles_of(float* sm, float* scratch, const CholPlan& plan,
                                                int n) {
  return GLOBAL ? scratch + (size_t)n * plan.scratch_floats : sm;
}

template <bool GLOBAL>
__device__ __forceinline__ float* chol_vectors_of(float* sm, const CholPlan& plan) {
  return GLOBAL ? sm : sm + plan.tiles * CHOL_NB * CHOL_NB;
}

__device__ __forceinline__ float* chol_tile(float* tiles, int I, int J) {
  return tiles + (I * (I + 1) / 2 + J) * CHOL_NB * CHOL_NB;
}

// Offset of entry (r, k) in a tile: 16-byte chunk k / 4 of row r is stored
// at chunk position (k / 4) ^ ((r / 4) % 4).
__device__ __forceinline__ int chol_at(int r, int k) {
  return r * CHOL_NB + ((((k >> 2) ^ (r >> 2)) & 3) << 2) + (k & 3);
}

__device__ __forceinline__ float4 chol_ld4(const float* A, int r, int chunk) {
  return *reinterpret_cast<const float4*>(A + chol_at(r, 4 * chunk));
}

__device__ __forceinline__ void chol_st4(float* A, int r, int chunk, float4 v) {
  *reinterpret_cast<float4*>(A + chol_at(r, 4 * chunk)) = v;
}

// (I, J) of lower-triangle number t = I(I+1)/2 + J.
__device__ __forceinline__ void chol_tile_ij(int t, int& I, int& J) {
  I = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while ((I + 1) * (I + 2) / 2 <= t) ++I;
  while (I * (I + 1) / 2 > t) --I;
  J = t - I * (I + 1) / 2;
}

// Fill the tiles from value(a, k), the matrix entry at row a, column k < D,
// with identity padding; a warp per tile, CHOL_FILL_TILES tiles a warp at
// a time, all of a lane's loads in flight before its first store. Entries
// above the diagonal of a diagonal tile are filled too and never read.
#define CHOL_FILL_TILES 4
template <class Value>
__device__ __forceinline__ void chol_fill(float* tiles, int T, int D, Value value) {
  constexpr int PER = CHOL_NB * CHOL_NB / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int n = T * (T + 1) / 2;
  for (int t0 = warp; t0 < n; t0 += CHOL_FILL_TILES * nw) {
    float v[CHOL_FILL_TILES][PER];
#pragma unroll
    for (int f = 0; f < CHOL_FILL_TILES; ++f) {
      const int t = t0 + f * nw;
      if (t >= n) break;
      int I, J;
      chol_tile_ij(t, I, J);
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int w = lane + 32 * e, a = I * CHOL_NB + w / CHOL_NB, k = J * CHOL_NB + w % CHOL_NB;
        v[f][e] = (a < D && k < D) ? value(a, k) : (a == k ? 1.0f : 0.0f);
      }
    }
#pragma unroll
    for (int f = 0; f < CHOL_FILL_TILES; ++f) {
      const int t = t0 + f * nw;
      if (t >= n) break;
      float* A = tiles + t * CHOL_NB * CHOL_NB;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int w = lane + 32 * e;
        A[chol_at(w / CHOL_NB, w % CHOL_NB)] = v[f][e];
      }
    }
  }
}

// One half-warp (hl = lane % 16): C -= X Y^T (SUB) or C = X Y^T. Lane hl owns
// rows hl / 4 + 4 i and columns 4 (hl % 4) + q. C may be X itself: the caller
// then passes INPLACE, and both half-warps of the warp must call it (C null
// for a half-warp without a tile).
template <bool SUB, bool INPLACE>
__device__ __forceinline__ void chol_tile_product(float* C, const float* X, const float* Y,
                                                  int hl) {
  const int rg = hl >> 2, cg = hl & 3;
  float acc[4][4];
  if (C != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 c = SUB ? chol_ld4(C, rg + 4 * i, cg) : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[i][0] = c.x, acc[i][1] = c.y, acc[i][2] = c.z, acc[i][3] = c.w;
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      float4 x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = chol_ld4(X, rg + 4 * i, kc);
        if (SUB) x[i] = make_float4(-x[i].x, -x[i].y, -x[i].z, -x[i].w);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 y = chol_ld4(Y, 4 * cg + q, kc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][q] = __fmaf_rn(x[i].x, y.x, acc[i][q]);
          acc[i][q] = __fmaf_rn(x[i].y, y.y, acc[i][q]);
          acc[i][q] = __fmaf_rn(x[i].z, y.z, acc[i][q]);
          acc[i][q] = __fmaf_rn(x[i].w, y.w, acc[i][q]);
        }
      }
    }
  }
  if (INPLACE) __syncwarp();  // every lane has read X before any lane overwrites it
  if (C != nullptr)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      chol_st4(C, rg + 4 * i, cg, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
}

// One warp: factor the diagonal tile A = L L^T in registers, then overwrite
// the tile with L^-1 (lower, zeros above). Returns false, leaving the tile
// unspecified, at a pivot that is not > 0 (or NaN). Lanes 16-31 compute
// what lanes 0-15 compute; only those write.
__device__ __forceinline__ bool chol_diag(float* A, int lane) {
  const unsigned full = 0xffffffffu;
  const int r = lane & 15;
  const bool writer = lane < 16;
  float a[CHOL_NB];  // row r of the tile, then of L with 1 / L_rr on the diagonal
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const float4 v = chol_ld4(A, r, kc);
    a[4 * kc] = v.x, a[4 * kc + 1] = v.y, a[4 * kc + 2] = v.z, a[4 * kc + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < CHOL_NB; ++j) {
    const float d = __shfl_sync(full, a[j], j, 16);  // the pivot, from row j
    if (!(d > 0.0f)) return false;                   // the same d in every lane: uniform
    const float rs = rsqrtf(d);
    a[j] = r == j ? rs : (r > j ? a[j] * rs : a[j]);
#pragma unroll
    for (int k = j + 1; k < CHOL_NB; ++k) {  // rank-1 update of the rows below j
      const float lkj = __shfl_sync(full, a[j], k, 16);
      if (r > j && k <= r) a[k] = __fmaf_rn(-a[j], lkj, a[k]);
    }
  }
  if (writer)
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      chol_st4(A, r, kc, make_float4(a[4 * kc], a[4 * kc + 1], a[4 * kc + 2], a[4 * kc + 3]));
  __syncwarp();
  // lane c: column c of L^-1 by right-looking substitution of L z = e_c,
  // reading L's columns from the tile (every lane the same address)
  const int c = r;
  float s[CHOL_NB];
#pragma unroll
  for (int k = 0; k < CHOL_NB; ++k) s[k] = k == c ? 1.0f : 0.0f;
#pragma unroll
  for (int j = 0; j < CHOL_NB; ++j) {
    s[j] = s[j] * A[chol_at(j, j)];
#pragma unroll
    for (int k = j + 1; k < CHOL_NB; ++k) s[k] = __fmaf_rn(-A[chol_at(k, j)], s[j], s[k]);
  }
  __syncwarp();  // every lane has read L before any lane overwrites it
  if (writer)
#pragma unroll
    for (int j = 0; j < CHOL_NB; ++j) A[chol_at(j, c)] = j >= c ? s[j] : 0.0f;
  return true;
}

// Factor the tiles in place (all threads of the block call it, the tiles
// published by a barrier): afterwards every off-diagonal tile holds L_ij and
// every diagonal tile L_ii^-1. A pivot that is not > 0 sets *bad (0 on
// entry) and stops. Ends on a barrier.
__device__ __forceinline__ void chol_factor_tiles(float* tiles, int T, int* bad) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int hl = lane & 15, half = lane >> 4;
  if (warp == 0 && !chol_diag(chol_tile(tiles, 0, 0), lane) && lane == 0) *bad = 1;
  __syncthreads();
  for (int p = 0; p < T - 1 && !*bad; ++p) {  // *bad: uniform after a barrier
    const float* Li = chol_tile(tiles, p, p);
    // (1) the panel, a tile per half-warp: L_ip = A_ip Linv^T
    for (int i0 = p + 1 + 2 * warp; i0 < T; i0 += 2 * nw) {
      float* C = i0 + half < T ? chol_tile(tiles, i0 + half, p) : nullptr;
      chol_tile_product<false, true>(C, C, Li, hl);
    }
    __syncthreads();
    // (2) warp 0: the next diagonal tile, updated and factored; the other
    // warps: the rest of the lower trailing tiles, numbered u = ii(ii+1)/2 +
    // jj from (p+1, p+1) (u = 0, warp 0's), a tile per half-warp
    const int m = T - p - 1;
    if (warp == 0) {
      float* Dn = chol_tile(tiles, p + 1, p + 1);
      const float* Ln = chol_tile(tiles, p + 1, p);
      if (half == 0) chol_tile_product<true, false>(Dn, Ln, Ln, hl);
      __syncwarp();
      if (!chol_diag(Dn, lane) && lane == 0) *bad = 1;
    } else {
      for (int u = 1 + 2 * (warp - 1) + half; u < m * (m + 1) / 2; u += 2 * (nw - 1)) {
        int ii, jj;
        chol_tile_ij(u, ii, jj);
        const int i = p + 1 + ii, j = p + 1 + jj;
        chol_tile_product<true, false>(chol_tile(tiles, i, j), chol_tile(tiles, i, p),
                                       chol_tile(tiles, j, p), hl);
      }
    }
    __syncthreads();
  }
}

// sum_k u[k] v[k] over 16 terms as four chains of four, then their sum.
__device__ __forceinline__ float chol_dot16(const float* u, const float* v) {
  float s[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s[c] = u[4 * c] * v[4 * c];
#pragma unroll
    for (int e = 1; e < 4; ++e) s[c] = __fmaf_rn(u[4 * c + e], v[4 * c + e], s[c]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// Warp 0: vec[p] = Linv_pp vec[p] (TRANS: Linv_pp^T vec[p]); lanes 16-31
// compute what lanes 0-15 compute.
template <bool TRANS>
__device__ __forceinline__ void chol_diag_apply(const float* Li, float* vp, int lane) {
  const int r = lane & 15;
  float l[CHOL_NB], v[CHOL_NB];
#pragma unroll
  for (int k = 0; k < CHOL_NB; ++k) {
    l[k] = Li[TRANS ? chol_at(k, r) : chol_at(r, k)];
    v[k] = vp[k];
  }
  const float y = chol_dot16(l, v);
  __syncwarp();  // every lane has read vp before any lane overwrites it
  if (lane < CHOL_NB) vp[r] = y;
}

// Solve L L^T x = vec in place (vec: rhs -> y -> x, Dp = 16 T entries, zero
// in the padding) after chol_factor_tiles left *bad == 0; all threads call
// it. One barrier per panel each way: thread t updates rows t, t + blockDim,
// ... with the panel's solved block, and warp 0, whose lanes 0-15 own the
// next block's rows (their first), goes on to solve that block before the
// barrier. Ends on a barrier.
__device__ __forceinline__ void chol_solve_tiles(float* tiles, float* vec, int T) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, Dp = T * CHOL_NB;
  // forward: y_p = Linv_pp r_p, then r_i -= L_ip y_p for every row below
  if (tid < 32) chol_diag_apply<false>(chol_tile(tiles, 0, 0), vec, lane);
  __syncthreads();
  for (int p = 0; p < T - 1; ++p) {
    const float* yp = vec + p * CHOL_NB;
    for (int i = (p + 1) * CHOL_NB + tid; i < Dp; i += nt) {
      const float* L = chol_tile(tiles, i / CHOL_NB, p);
      const int ri = i % CHOL_NB;
      float l[CHOL_NB], y[CHOL_NB];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const float4 lv = chol_ld4(L, ri, kc);
        const float4 yv = *reinterpret_cast<const float4*>(yp + 4 * kc);
        l[4 * kc] = lv.x, l[4 * kc + 1] = lv.y, l[4 * kc + 2] = lv.z, l[4 * kc + 3] = lv.w;
        y[4 * kc] = yv.x, y[4 * kc + 1] = yv.y, y[4 * kc + 2] = yv.z, y[4 * kc + 3] = yv.w;
      }
      vec[i] -= chol_dot16(l, y);
    }
    if (tid < 32) {
      __syncwarp();
      chol_diag_apply<false>(chol_tile(tiles, p + 1, p + 1), vec + (p + 1) * CHOL_NB, lane);
    }
    __syncthreads();
  }
  // backward: x_p = Linv_pp^T y_p, then y_i -= L_pi^T x_p for every row above
  if (tid < 32)
    chol_diag_apply<true>(chol_tile(tiles, T - 1, T - 1), vec + (T - 1) * CHOL_NB, lane);
  __syncthreads();
  for (int p = T - 1; p > 0; --p) {
    const float* xp = vec + p * CHOL_NB;
    // warp 0's lanes 0-15 first: the block p - 1
    for (int i = p * CHOL_NB - 1 - tid; i >= 0; i -= nt) {
      const float* L = chol_tile(tiles, p, i / CHOL_NB);
      const int ri = i % CHOL_NB;
      float l[CHOL_NB], x[CHOL_NB];
#pragma unroll
      for (int c = 0; c < CHOL_NB; ++c) l[c] = L[chol_at(c, ri)], x[c] = xp[c];
      vec[i] -= chol_dot16(l, x);
    }
    if (tid < 32) {
      __syncwarp();
      chol_diag_apply<true>(chol_tile(tiles, p - 1, p - 1), vec + (p - 1) * CHOL_NB, lane);
    }
    __syncthreads();
  }
}
