// Device code shared by the stratified-attention kernels, forward
// (attention_fwd_common.cuh) and backward (attention_bwd_common.cuh): the
// cRPE bin of one axis, shared-memory and warp helpers.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace stratified {

constexpr float kNegInf = -1e30f;

// Quantized relative-position bin of one axis, bit-identical to
// relative_position_index (ops/attention.py) and to the JAX package's
// ops/pallas/common.py:49-66: round(rel * 1e5) * 1e-5 (half to even), plus
// (2*window - 1e-4), times 1/quant, floor, clip to [0, nb_full), then the
// shift into the table slice [bin_lo, bin_lo + nb). The explicit _rn
// intrinsics keep nvcc from contracting a multiply and an add into an FMA,
// which would move bins at exact quantization boundaries.
__device__ __forceinline__ int rel_bin(float rel, float bin_offset,
                                       float inv_quant, int nb_full,
                                       int bin_lo, int nb) {
  float r = __fmul_rn(rintf(__fmul_rn(rel, 1e5f)), 1e-5f);
  float f = floorf(__fmul_rn(__fadd_rn(r, bin_offset), inv_quant));
  f = fminf(fmaxf(f, 0.0f), static_cast<float>(nb_full - 1));
  int b = static_cast<int>(f) - bin_lo;
  return min(max(b, 0), nb - 1);
}

// 4 consecutive floats of shared memory at a 16-byte aligned address.
__device__ __forceinline__ void lds4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// Sum / max over aligned groups of N neighbouring lanes (a butterfly: every
// lane of the group gets the same value, summed in a fixed order).
template <int N>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int s = 1; s < N; s <<= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

template <int N>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int s = 1; s < N; s <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

// Bytes of dynamic shared memory that a block of `kernel` may take on the
// current device: the opt-in limit per block less the kernel's static
// shared memory (227 KB less a few bytes on the H100).
template <typename Kernel>
__host__ cudaError_t smem_room(Kernel kernel, size_t* room) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    *room = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  return err;
}

}  // namespace stratified
