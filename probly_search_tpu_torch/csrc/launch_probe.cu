// Launch probe (P1) for Hopper (sm_90a): out = x + 1 over f32[8, 512].
//
// Replaces the Pallas TPU kernel pallas_add of
// benchmarks/profile_launch.py (tiny_kernel: o_ref[...] = x_ref[...] + 1.0),
// a probe of the fixed cost of one kernel launch.  One block of 512 threads,
// each adding 1 to eight floats; the work is 16 KB of traffic, so the time
// of a launch, not the bytes or the operations, bounds it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
    probe_add_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = x[i] + 1.0f;
}

}  // namespace

extern "C" {

// out[i] = x[i] + 1 for i < n, one block on `stream` of CUDA device
// `device`.  Returns cudaGetLastError() (0 = ok).
int probe_add(int device, const float* x, float* out, int n, void* stream) {
  if (n == 0) return 0;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  probe_add_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
