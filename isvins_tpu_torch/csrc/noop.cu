// An empty kernel. Its time is the floor that no single launch of the other
// kernels can go under, whether the host enqueues it or a CUDA graph replays
// it: the yardstick beside bounds of a fraction of a microsecond.
#include "common.cuh"

__global__ void noop_kernel() {}

ISV_EXPORT int isv_noop(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
