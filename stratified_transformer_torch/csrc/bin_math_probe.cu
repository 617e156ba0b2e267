// The cRPE bin formula in its division form, as a bandwidth-bound
// elementwise pass (elementwise.cuh).
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
// approximations. Vector access changes none of this: each lane of a float4
// goes through the same sequence.
//
// What bounds it on the H100: 4 bytes read and 4 written per element over
// 3.35 TB/s (0.160 ms at 2^26 elements); its 7 operations per element (two
// of them IEEE divisions, each a sequence of instructions) at the fp32 rate
// take 0.007 ms. At the probe's 256 x 256 sweep (512 KiB) a launch costs
// more than the bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elementwise.cuh"

namespace stratified {

struct BinFormula {
  using Out = int32_t;
  float two_ws, qs;
  __device__ __forceinline__ int32_t operator()(float x) const {
    const float r = __fdiv_rn(rintf(__fmul_rn(x, 1e5f)), 1e5f);
    const float t = __fsub_rn(__fadd_rn(r, two_ws), 1e-4f);
    return static_cast<int32_t>(floorf(__fdiv_rn(t, qs)));
  }
};

}  // namespace stratified

// C entry point, bound with ctypes: x [n] fp32 -> out [n] int32; two_ws is
// the fp32 value of 2*ws. Returns cudaGetLastError() after the launch.
extern "C" int bin_formula(const float* x, int32_t* out, int n, float two_ws,
                           float qs, void* stream) {
  return stratified::elementwise_launch(
      x, out, n, stratified::BinFormula{two_ws, qs}, stream);
}

// An empty kernel on the grid that bin_formula takes for n elements: the
// launch floor that its times are read against.
extern "C" int bin_formula_floor(int n, void* stream) {
  return stratified::elementwise_floor(n, stream);
}
