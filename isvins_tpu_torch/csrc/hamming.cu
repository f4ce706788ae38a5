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
// with dist = sum_w popc(q[w] ^ d[w]) and invalid database rows at 512.
// R is fixed at 64, the keyframe database's retrieval subsample
// (posegraph/keyframe_db.py); K = the keyframes before the query's window.
//
// What bounds it on the H100: integer ALU throughput, R*R*8 xor+popc per
// keyframe (32,768 at R = 64); the database is K*R*33 bytes, read once.
// Design: one block of R = 64 threads (two warps) per database keyframe
// stages that keyframe's R x 8 words and validity in shared memory (every
// thread then reads the same word: a broadcast, no bank conflicts); thread r
// keeps query descriptor r's 8 words in registers and takes the min over the
// R database rows; a warp-shuffle + shared reduction counts the hits and the
// valid queries. Everything before the final division is integer
// arithmetic, and the division is IEEE (nvcc's default -prec-div), so the
// kernel equals its plain version exactly. The TPU body's MXU
// block-indicator matmul and 128-lane padding are TPU devices and are not
// carried over.
#include "common.cuh"

constexpr int NWORDS = 8;
constexpr int R = 64;  // descriptors per keyframe = threads per block

__device__ __forceinline__ int warp_sum_int(int s) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__global__ void __launch_bounds__(R)
    retrieval_scores_kernel(const unsigned* __restrict__ qd, const unsigned char* __restrict__ qv,
                            const unsigned* __restrict__ dbd,
                            const unsigned char* __restrict__ dbv, float* __restrict__ scores,
                            int thresh) {
  __shared__ unsigned d[R * NWORDS];
  __shared__ unsigned char v[R];
  __shared__ int red[2][R / 32];
  const int k = blockIdx.x, r = threadIdx.x;
  const unsigned* src = dbd + (size_t)k * R * NWORDS;
#pragma unroll
  for (int w = 0; w < NWORDS; ++w) d[w * R + r] = src[w * R + r];
  v[r] = dbv[(size_t)k * R + r];
  unsigned q[NWORDS];
#pragma unroll
  for (int w = 0; w < NWORDS; ++w) q[w] = qd[r * NWORDS + w];
  __syncthreads();

  int best = 512;
  for (int j = 0; j < R; ++j) {
    int dist = 0;
#pragma unroll
    for (int w = 0; w < NWORDS; ++w) dist += __popc(q[w] ^ d[j * NWORDS + w]);
    best = min(best, v[j] ? dist : 512);
  }
  const int valid = qv[r] != 0;
  const int hits = warp_sum_int((best < thresh) & valid);
  const int nvalid = warp_sum_int(valid);
  if ((r & 31) == 0) {
    red[0][r >> 5] = hits;
    red[1][r >> 5] = nvalid;
  }
  __syncthreads();
  if (r == 0) scores[k] = (float)(red[0][0] + red[0][1]) / (float)max(red[1][0] + red[1][1], 1);
}

ISV_EXPORT int isv_retrieval_scores(const unsigned* qd, const unsigned char* qv,
                                    const unsigned* dbd, const unsigned char* dbv,
                                    float* scores, int K, int thresh, void* stream) {
  if (K == 0) return 0;
  retrieval_scores_kernel<<<K, R, 0, (cudaStream_t)stream>>>(qd, qv, dbd, dbv, scores, thresh);
  return (int)cudaGetLastError();
}
