// K6 retrieval_scores: batched Hamming retrieval scoring of the keyframe
// database (loop-closure candidate ranking before the BoW vocabulary freezes).
//
// Replaces isvins_tpu/ops/hamming_pallas.py::retrieval_scores_pallas (Pallas
// body _kernel). Plain version: isvins_tpu_torch/ops/hamming.py
// retrieval_scores_ref.
//
//   qd  (R, 8) query descriptors, 256-bit BRIEF as 8 32-bit words
//   qv  (R,)   query validity
//   dbd (K, R, 8) database descriptors, dbv (K, R) their validity
//   scores[k] = #{r : qv[r] and min_j dist(qd[r], dbd[k, j]) < thresh} / max(#qv, 1)
//
// with dist the Hamming distance and invalid database rows at 512. R is
// fixed at 64, the keyframe database's retrieval subsample
// (posegraph/keyframe_db.py); K = the keyframes before the query's window.
//
// What bounds it on the H100: the work is a product, 64 query descriptors
// against 64 K database descriptors over 256 bits. As xor + popcount on the
// CUDA cores it is 64 * 64 * 8 * K popc at 16 a clock per SM (0.032-0.036 ms
// at K = 4096); as an exact dot product of bits,
//   dist(a, b) = |a| + |b| - 2 <a, b>,
// it runs on the tensor cores (64 * 64 * 256 * 2 * K operations, 0.0043 ms
// at K = 4096 at the int8 rate of 1,979 TOP/s; the database is 33 B a
// descriptor, 0.0026 ms at 3.35 TB/s). At the pose-graph path's sizes
// (K = 1..23) it is bound by latency: one load round, one wgmma and the
// reductions. The TPU body made the same move when it put its per-keyframe
// reduction on the MXU; its block-indicator matmul and 128-lane padding are
// TPU devices and are not carried over.
//
// Design: a block is one warpgroup (four warps) and takes keyframes
// blockIdx.x, + gridDim.x, ... (at most BLOCKS_PER_SM blocks per SM). One
// wgmma m64n64k256.s32.b1.b1.and.popc makes a keyframe's 64 x 64 products
// <a, b> = popc(a & b) from the descriptors' bits as they are stored: A, the
// 64 query descriptors, in the warpgroup's registers (lane (g, t) of warp w
// holds words t and 4 + t of rows 16w + g and 16w + g + 8), B, the
// keyframe's 64 rows, in shared memory in the no-swizzle K-major layout
// (a row's two 16-byte K halves in two core matrices of eight rows), where
// cp.async puts them straight from device memory. The database streams
// through a ring of STAGES such tiles, STAGES - 1 keyframes ahead. While a
// keyframe's wgmma runs, the block counts |b_j| once a row; then each lane
// keeps min_j (|b_j| + 1024 [j invalid] - 2 <a, b_j>) over its 16 columns,
// two shuffles finish the min over the quad, min(|a| + min, 512) < thresh is
// one ballot per warp (lanes t < 2 report rows g + 8t), and the four warps'
// counts of valid hits are summed. The int32 sums are exact and the
// division is IEEE (nvcc's default -prec-div), so the kernel equals its
// plain version exactly. The binary form replaced an int8 design (wgmma
// m64n64k32.u8, the bits unpacked into bytes, eight wgmma a keyframe): by
// graph replay on an H100, 0.0088 against 0.0127 ms at K = 4096 and 0.0022
// against 0.0026 ms at K = 23 (k6_breakdown.py --versus; PERF.md, section 6).
#include <climits>

#include "common.cuh"

constexpr int NWORDS = 8;
constexpr int R = 64;               // descriptors per keyframe
constexpr int THREADS = 128;        // one warpgroup
constexpr int STAGES = 3;           // database ring: STAGES - 1 keyframes ahead
constexpr int BLOCKS_PER_SM = 4;
constexpr unsigned FULL = 0xffffffffu;
// the B tile: groups of eight rows SBO bytes apart, each group's two 16-byte
// K halves LBO bytes apart, eight rows of 16 bytes in each (a core matrix)
constexpr int LBO = 128, SBO = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct __align__(128) Stage {  // one keyframe: its B tile and validity
  uint4 b[R * 2];
  unsigned char valid[R];
};

// Index in Stage::b of the 16-byte K half h of row n.
__device__ __forceinline__ int bchunk(int n, int h) {
  return (n >> 3) * (SBO / 16) + h * (LBO / 16) + (n & 7);
}

// Stage keyframe k (if k < K): thread 2n + h copies K half h of row n into
// its place in the B tile, four threads copy the validity bytes; always
// commits a group, so the count stays uniform.
__device__ __forceinline__ void stage_load(Stage& st, const unsigned* dbd,
                                           const unsigned char* dbv, int k, int K) {
  const int tid = threadIdx.x;
  if (k < K) {
    const uint4* src = reinterpret_cast<const uint4*>(dbd + (size_t)k * R * NWORDS);
    cp_async16(&st.b[bchunk(tid >> 1, tid & 1)], src + tid);
    if (tid < R / 16) cp_async16(&st.valid[16 * tid], dbv + (size_t)k * R + 16 * tid);
  }
  cp_async_commit();
}

// wgmma's shared-memory matrix descriptor of the B tile at shared address
// addr: start, leading (K) and stride (row group) byte offsets, each >> 4;
// no swizzle.
__device__ __forceinline__ unsigned long long btile_desc(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) | ((unsigned long long)(LBO >> 4) << 16)
         | ((unsigned long long)(SBO >> 4) << 32);
}

// Pins the accumulators: the compiler may not move a use of d across it
// (wgmma writes them asynchronously, until wgmma.wait_group).
__device__ __forceinline__ void fence_acc(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d = A B: popc(a & b) over the 256 bits of every pair, A (64 x 256 bits)
// from the warpgroup's registers, B (256 x 64) from shared memory by
// descriptor.
__device__ __forceinline__ void wgmma_b1(int (&d)[32], const unsigned (&a)[4],
                                         unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    retrieval_scores_kernel(const unsigned* __restrict__ qd, const unsigned char* __restrict__ qv,
                            const unsigned* __restrict__ dbd,
                            const unsigned char* __restrict__ dbv, float* __restrict__ scores,
                            int K, int thresh) {
  __shared__ Stage ring[STAGES];
  __shared__ __align__(8) int pb[R];
  __shared__ int nq[4], hits[4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) stage_load(ring[s], dbd, dbv, blockIdx.x + s * gridDim.x, K);

  // A fragment of the warp's rows 16 warp + g (a[0], a[2]) and + 8 (a[1], a[3]):
  // words t and 4 + t; |a| of each row summed over the quad
  unsigned a[4];
  int pa[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned* row = qd + (16 * warp + 8 * h + g) * NWORDS;
    a[h] = row[t];
    a[h + 2] = row[4 + t];
    int p = __popc(a[h]) + __popc(a[h + 2]);
    p += __shfl_xor_sync(FULL, p, 1);
    pa[h] = p + __shfl_xor_sync(FULL, p, 2);
  }
  // lanes t < 2 report query row 16 warp + g + 8t in a ballot
  const unsigned qmask = __ballot_sync(FULL, t < 2 && qv[16 * warp + g + 8 * t] != 0);
  if (lane == 0) nq[warp] = __popc(qmask);
  __syncthreads();
  const float denom = (float)max(nq[0] + nq[1] + nq[2] + nq[3], 1);

  int it = 0;
  for (int k = blockIdx.x; k < K; k += gridDim.x, ++it) {
    const Stage& st = ring[it % STAGES];
    cp_async_wait<STAGES - 2>();  // this thread's copies of keyframe k
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // everyone's, and the previous keyframe is done with
    if (threadIdx.x == 0 && it > 0)  // the previous keyframe's score
      scores[k - gridDim.x] = (float)(hits[0] + hits[1] + hits[2] + hits[3]) / denom;
    stage_load(ring[(it + STAGES - 1) % STAGES], dbd, dbv, k + (STAGES - 1) * gridDim.x, K);
    int d[32];
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    wgmma_b1(d, a, btile_desc((unsigned)__cvta_generic_to_shared(st.b)));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    {  // |b_n| + 1024 [n invalid] while the product runs: thread 2n + h, half h
      const int n = threadIdx.x >> 1;
      const uint4 v = st.b[bchunk(n, threadIdx.x & 1)];
      int p = __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
      p += __shfl_xor_sync(FULL, p, 1);
      if ((threadIdx.x & 1) == 0) pb[n] = p + (st.valid[n] ? 0 : 1024);
    }
    __syncthreads();
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    int best0 = INT_MAX, best1 = INT_MAX;  // rows g, g + 8
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // d[4j + {0, 1}]: row g, columns 8j + 2t + {0, 1}
      const int2 b = *reinterpret_cast<const int2*>(&pb[8 * j + 2 * t]);
      best0 = min(best0, min(b.x - 2 * d[4 * j], b.y - 2 * d[4 * j + 1]));
      best1 = min(best1, min(b.x - 2 * d[4 * j + 2], b.y - 2 * d[4 * j + 3]));
    }
    best0 = min(best0, __shfl_xor_sync(FULL, best0, 1));
    best0 = min(best0, __shfl_xor_sync(FULL, best0, 2));
    best1 = min(best1, __shfl_xor_sync(FULL, best1, 1));
    best1 = min(best1, __shfl_xor_sync(FULL, best1, 2));
    const int b = (t & 1) ? best1 : best0, pm = (t & 1) ? pa[1] : pa[0];
    const unsigned hit = __ballot_sync(FULL, t < 2 && min(pm + b, 512) < thresh);
    if (lane == 0) hits[warp] = __popc(hit & qmask);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x == 0 && it > 0)  // the last keyframe's score
    scores[blockIdx.x + (it - 1) * gridDim.x] =
        (float)(hits[0] + hits[1] + hits[2] + hits[3]) / denom;
}

ISV_EXPORT int isv_retrieval_scores(const unsigned* qd, const unsigned char* qv,
                                    const unsigned* dbd, const unsigned char* dbv,
                                    float* scores, int K, int thresh, void* stream) {
  if (K == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int blocks = K < BLOCKS_PER_SM * sms ? K : BLOCKS_PER_SM * sms;
  retrieval_scores_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(qd, qv, dbd, dbv, scores,
                                                                       K, thresh);
  return (int)cudaGetLastError();
}
