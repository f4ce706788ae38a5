// Shared helpers for the hand-written Hopper kernels of isvins_tpu_torch.
//
// Every kernel is exported through a plain C function that launches on the
// caller's stream and returns cudaGetLastError() as an int; the Python
// wrappers in isvins_tpu_torch/ops/ raise when it is not 0.
#pragma once

#include <cuda_runtime.h>

#define ISV_EXPORT extern "C" __attribute__((visibility("default")))

struct Q4 {
  float w, x, y, z;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  return Q4{a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
            a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
            a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
            a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

__device__ __forceinline__ Q4 qconj(Q4 a) { return Q4{a.w, -a.x, -a.y, -a.z}; }

// R(q) v, in the same operation order as the reference's component form.
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  float tx = 2.0f * (q.y * v.z - q.z * v.y);
  float ty = 2.0f * (q.z * v.x - q.x * v.z);
  float tz = 2.0f * (q.x * v.y - q.y * v.x);
  return V3{v.x + q.w * tx + (q.y * tz - q.z * ty),
            v.y + q.w * ty + (q.z * tx - q.x * tz),
            v.z + q.w * tz + (q.x * ty - q.y * tx)};
}

// R(q) as 9 row-major entries.
__device__ __forceinline__ void qmat(Q4 q, float* m) {
  float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  m[0] = 1.0f - 2.0f * (yy + zz); m[1] = 2.0f * (xy - wz); m[2] = 2.0f * (xz + wy);
  m[3] = 2.0f * (xy + wz); m[4] = 1.0f - 2.0f * (xx + zz); m[5] = 2.0f * (yz - wx);
  m[6] = 2.0f * (xz - wy); m[7] = 2.0f * (yz + wx); m[8] = 1.0f - 2.0f * (xx + yy);
}

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float warp_sum(float s) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}
