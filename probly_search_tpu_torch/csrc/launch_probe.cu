// Launch probe (P1) for Hopper (sm_90a): out = x + 1 over n floats
// (f32[8, 512] in the probe).
//
// Replaces the Pallas TPU kernel pallas_add of
// benchmarks/profile_launch.py (tiny_kernel: o_ref[...] = x_ref[...] + 1.0),
// a probe of the fixed cost of one kernel launch.  The probe's 16 KB of
// traffic take ~5 ns at 3.35 TB/s, so the launch and one memory round trip
// bound it.  The design keeps the body to that one round trip: each thread
// moves one 16-B word (one float4 load, add, store), blocks of 128 threads,
// as many blocks as cover n / 4 words (8 for the probe), so no thread loops;
// the thread past the last whole word adds the n % 4 floats of the tail.  A
// pointer that is not 16-B aligned (a view at an odd offset) takes a scalar
// kernel, one float a thread.  The host launches on the stream it is given,
// on the caller's current device: no cudaSetDevice a call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    probe_add_vec4(const float* __restrict__ x, float* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int words = n >> 2;
  if (i < words) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    reinterpret_cast<float4*>(out)[i] = v;
  } else if (i == words) {
    for (int j = words << 2; j < n; ++j) out[j] = x[j] + 1.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
    probe_add_scalar(const float* __restrict__ x, float* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = x[i] + 1.0f;
}

}  // namespace

extern "C" {

// out[i] = x[i] + 1 for i < n, on `stream` (a stream of the current CUDA
// device).  Returns cudaGetLastError() (0 = ok).
int probe_add(const float* x, float* out, int n, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) {
    probe_add_scalar<<<(n - 1) / kThreads + 1, kThreads, 0, s>>>(x, out, n);
  } else {
    const int threads = (n >> 2) + ((n & 3) != 0);  // whole words + the tail's thread
    probe_add_vec4<<<(threads - 1) / kThreads + 1, kThreads, 0, s>>>(x, out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
