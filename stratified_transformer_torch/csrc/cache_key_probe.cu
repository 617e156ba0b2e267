// y = x * 2, one thread per element.
//
// Replaces the Pallas TPU kernel `kernel` of tools/cache_key_probe.py, which
// exists to show whether compiled kernels are reused across processes. Here
// the question is whether a second process reuses the libraries that
// kernels/build.py built (the cache key: flags, sources, nvcc version);
// stratified_transformer_torch/tools/cache_key_probe.py prints the key's
// components. Plain PyTorch version: times_two_plain in the same module.
//
// What bounds it on the H100: 4 bytes read and 4 written per element (128
// KiB for the probe's 128 x 128 input) over 3.35 TB/s; at that size a
// launch costs more than the bytes.

#include <cuda_runtime.h>

__global__ void times_two_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f;
}

// C entry point, bound with ctypes: x, y [n] fp32. Returns
// cudaGetLastError() after the launch.
extern "C" int times_two(const float* x, float* y, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  times_two_kernel<<<(n + threads - 1) / threads, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}
