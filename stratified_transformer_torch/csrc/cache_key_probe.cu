// y = x * 2, as a bandwidth-bound elementwise pass (elementwise.cuh).
//
// Replaces the Pallas TPU kernel `kernel` of tools/cache_key_probe.py, which
// exists to show whether compiled kernels are reused across processes. Here
// the question is whether a second process reuses the libraries that
// kernels/build.py built (the cache key: flags, sources, nvcc version);
// stratified_transformer_torch/tools/cache_key_probe.py prints the key's
// components. Plain PyTorch version: times_two_plain in the same module.
//
// What bounds it on the H100: 4 bytes read and 4 written per element over
// 3.35 TB/s (0.160 ms at 2^26 elements), one multiply each. At the probe's
// 128 x 128 input (128 KiB) a launch costs more than the bytes.

#include <cuda_runtime.h>

#include "elementwise.cuh"

namespace stratified {

struct TimesTwo {
  using Out = float;
  __device__ __forceinline__ float operator()(float x) const {
    return x * 2.0f;
  }
};

}  // namespace stratified

// C entry point, bound with ctypes: x, y [n] fp32. Returns
// cudaGetLastError() after the launch.
extern "C" int times_two(const float* x, float* y, int n, void* stream) {
  return stratified::elementwise_launch(x, y, n, stratified::TimesTwo{},
                                        stream);
}

// An empty kernel on the grid that times_two takes for n elements: the
// launch floor that its times are read against.
extern "C" int times_two_floor(int n, void* stream) {
  return stratified::elementwise_floor(n, stream);
}
