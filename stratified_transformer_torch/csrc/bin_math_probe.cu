// The cRPE bin formula in its division form, one thread per element.
//
// Replaces the Pallas TPU kernel `kernel` of tools/bin_math_probe.py (the
// probe asks whether the device compiler computes the formula differently
// from the host). Plain PyTorch version: bin_formula_plain in
// stratified_transformer_torch/tools/bin_math_probe.py.
//
//   bin = floor((rint(x * 1e5) / 1e5 + 2*ws - 1e-4) / qs)
//
// evaluated left to right in fp32, round to nearest even. Each step is
// spelled with an _rn intrinsic, so nvcc can neither contract a multiply and
// an add into an FMA nor reorder the sum; the build never passes
// --use_fast_math, so the divisions are IEEE divisions and not reciprocal
// approximations.
//
// What bounds it on the H100: 4 bytes read and 4 written per element, a few
// operations each: the bytes (512 KiB for the probe's 256 x 256 sweep) over
// 3.35 TB/s; at that size a launch costs more than the bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__global__ void bin_formula_kernel(const float* __restrict__ x,
                                   int32_t* __restrict__ out, int n,
                                   float two_ws, float qs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float r = __fdiv_rn(rintf(__fmul_rn(x[i], 1e5f)), 1e5f);
  float t = __fsub_rn(__fadd_rn(r, two_ws), 1e-4f);
  out[i] = static_cast<int32_t>(floorf(__fdiv_rn(t, qs)));
}

// C entry point, bound with ctypes: x [n] fp32 -> out [n] int32; two_ws is
// the fp32 value of 2*ws. Returns cudaGetLastError() after the launch.
extern "C" int bin_formula(const float* x, int32_t* out, int n, float two_ws,
                           float qs, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  bin_formula_kernel<<<(n + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, out, n,
                                                            two_ws, qs);
  return static_cast<int>(cudaGetLastError());
}
