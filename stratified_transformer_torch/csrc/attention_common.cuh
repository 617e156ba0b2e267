// Device code shared by the stratified-attention kernels, forward
// (attention_fwd_common.cuh, attention_fwd_swin.cuh) and backward
// (attention_bwd_common.cuh): the cRPE bin of one axis, shared-memory and
// warp helpers, and the bf16 helpers of the kernels' fast forms.
#pragma once

#include <cuda_bf16.h>
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

// Swin3D's window-quantized bin of one axis (rpe_mode "swin_window"),
// bit-identical to swin_relative_position_index (ops/attention.py) and to
// the JAX package's ops/attention.py:59-72: rel = u_i - u_j of two points'
// window-quantized positions, small integers held as floats (so the
// subtraction before the call is exact), rounded half to even, plus
// qgl - 1, clipped to [0, nb). The tables have nb = 2 qgl - 1 rows and no
// slice.
__device__ __forceinline__ int swin_bin(float rel, int qgl, int nb) {
  const float f = __fadd_rn(rintf(rel), static_cast<float>(qgl - 1));
  return static_cast<int>(fminf(fmaxf(f, 0.0f), static_cast<float>(nb - 1)));
}

// The bin of one axis of the kernel's tables (FwdTables, BwdTables):
// swin_bin in the swin mode (kSwin, an instantiation of its own, so the
// stratified instantiations carry no branch), else rel_bin.
template <bool kSwin, typename Tables>
__device__ __forceinline__ int table_bin(const Tables& T, float rel) {
  if constexpr (kSwin)
    return swin_bin(rel, (T.nb_full + 1) / 2, T.nb);
  else
    return rel_bin(rel, T.bin_offset, T.inv_quant, T.nb_full, T.bin_lo,
                   T.nb);
}

// 4 consecutive floats of shared memory at a 16-byte aligned address.
__device__ __forceinline__ void lds4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// The fast forms are the TPU kernels' DEFAULT-precision mode, which the
// shipped YAMLs select (rpe_precision/qk_precision: default): each operand
// of a product that the TPU kernel contracts at DEFAULT precision is
// rounded to bf16 (to nearest, ties to even) and the products accumulate
// in fp32, on the tensor cores (attention_fwd_tc.cuh, attention_bwd_tc.cuh).

// Two floats rounded to bf16 and packed, the first in the low half (the
// lower-index element of an mma fragment register).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D += A·B on the tensor cores: A 16x16 bf16 (row-major fragment), B 16x8
// bf16 (column-major fragment), D 16x8 fp32 (PTX ISA, mma.m16n8k16). The
// products of bf16 values are exact; the sums run in fp32.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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
