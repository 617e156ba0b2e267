// One bandwidth-bound pass y[i] = op(x[i]) over n fp32 values, shared by the
// two probe kernels (bin_math_probe.cu, cache_key_probe.cu).
//
// What bounds such a pass on the H100: the bytes, 4 read and 4 written per
// element, over 3.35 TB/s; a few operations per element are far below the
// card's rate. So the pass is built to keep HBM busy:
//   - 16-byte accesses: a thread moves float4s in and float4s / int4s out,
//     neighbouring threads on neighbouring addresses;
//   - bytes in flight: each thread starts kElementwiseUnroll independent
//     float4 loads before it uses any of them (32 bytes a thread, 64 KB
//     on a full SM; 3.35 TB/s times ~0.7 us of latency over 132 SMs is
//     some 18 KB an SM). Four or eight measured no faster on the H100
//     (PERF.md);
//   - a grid that covers the data once (elementwise_shape), each block one
//     chunk of 8 KB: a block leaves when its chunk is stored, and a new
//     one takes its place. A persistent grid of the card's size (SMs x
//     resident blocks) walking the data in a grid-stride loop was slower
//     at 2^26 elements on the H100 (PERF.md); the loop stays, so any grid
//     is right. Below a wave of the card (n < SMs x 8 KB of
//     input, as at the probe's entry shapes) elementwise_small_kernel, one
//     element a thread;
//   - streaming cache hints (__ldcs / __stcs): every byte is touched once,
//     so the lines are marked to leave L2 first;
//   - scalar code for the n % 4 tail, and for pointers that are not both
//     16-byte aligned (a view at an element offset is read where it lies,
//     not copied).
// No TMA, no tensor cores: there is no product to feed.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stratified {

constexpr int kElementwiseThreads = 256;
// independent float4 loads a thread starts before it uses any of them
constexpr int kElementwiseUnroll = 2;

template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
  static __device__ __forceinline__ float4 make(float a, float b, float c,
                                                float d) {
    return make_float4(a, b, c, d);
  }
};
template <>
struct Vec4<int32_t> {
  using type = int4;
  static __device__ __forceinline__ int4 make(int32_t a, int32_t b, int32_t c,
                                              int32_t d) {
    return make_int4(a, b, c, d);
  }
};

// op applied to the four lanes of v, in lane order.
template <typename Op>
__device__ __forceinline__ typename Vec4<typename Op::Out>::type apply4(
    const Op& op, float4 v) {
  return Vec4<typename Op::Out>::make(op(v.x), op(v.y), op(v.z), op(v.w));
}

// y[i] = op(x[i]) for i < n, by any grid of blocks of at most
// kElementwiseThreads threads. Op has an `Out` type (float or int32_t) and
// `Out operator()(float) const`. Where x and y are 16-byte aligned, block b
// takes chunks b, b + gridDim.x, ... of blockDim.x x kElementwiseUnroll
// float4s, each thread loading its kElementwiseUnroll float4s of a chunk
// before it computes and stores them, and the n % 4 tail goes one element
// per thread; else each thread takes elements tid, tid + threads, ... one
// by one.
template <typename Op>
__device__ __forceinline__ void elementwise_pass(
    const float* __restrict__ x, typename Op::Out* __restrict__ y, int n,
    const Op& op) {
  using Out4 = typename Vec4<typename Op::Out>::type;
  constexpr int kU = kElementwiseUnroll;
  const int threads = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  int scalar_from = 0;
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    Out4* y4 = reinterpret_cast<Out4*>(y);
    const int n4 = n >> 2;
    for (int c = blockIdx.x * blockDim.x * kU + threadIdx.x; c < n4;
         c += threads * kU) {
      float4 v[kU] = {};
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (c + u * blockDim.x < n4) v[u] = __ldcs(x4 + c + u * blockDim.x);
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (c + u * blockDim.x < n4)
          __stcs(y4 + c + u * blockDim.x, apply4(op, v[u]));
    }
    scalar_from = n4 * 4;
  }
  for (int i = scalar_from + tid; i < n; i += threads) y[i] = op(x[i]);
}

template <typename Op>
__global__ void __launch_bounds__(kElementwiseThreads)
    elementwise_kernel(const float* __restrict__ x,
                       typename Op::Out* __restrict__ y, int n, Op op) {
  elementwise_pass(x, y, n, op);
}

// Below a wave of the card: one element a thread, no loop. At the probes'
// entry shapes a float4 a thread (16 and 4 blocks) was slower than this on
// the H100, the bin formula the most (PERF.md): a thread's four bins, each
// two IEEE divisions with a branch to a slow path, seem to run one after
// another.
template <typename Op>
__global__ void elementwise_small_kernel(const float* __restrict__ x,
                                         typename Op::Out* __restrict__ y,
                                         int n, Op op) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = op(x[i]);
}

// The launch of a pass over n elements on the current device, in blocks
// of kElementwiseThreads threads: elementwise_kernel with as many blocks as
// take every float4 once at kElementwiseUnroll a thread, where that gives
// every SM of the card a block (`small` false); else
// elementwise_small_kernel, one element a thread.
__host__ inline cudaError_t elementwise_shape(int n, int* grid, bool* small) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long threads = kElementwiseThreads;
  long long blocks = (n + 4 * threads * kElementwiseUnroll - 1) /
                     (4 * threads * kElementwiseUnroll);
  *small = blocks < sms;
  if (*small) blocks = (n + threads - 1) / threads;
  *grid = static_cast<int>(blocks);
  return cudaSuccess;
}

// Launches y[i] = op(x[i]), i < n, on `stream`. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue, and no launch, for n <= 0).
template <typename Op>
__host__ int elementwise_launch(const float* x, typename Op::Out* y, int n,
                                Op op, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  bool small = false;
  cudaError_t err = elementwise_shape(n, &grid, &small);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (small)
    elementwise_small_kernel<Op><<<grid, kElementwiseThreads, 0, s>>>(
        x, y, n, op);
  else
    elementwise_kernel<Op><<<grid, kElementwiseThreads, 0, s>>>(x, y, n, op);
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

// The launch floor of a pass at n elements: an empty kernel on the same
// grid and block, launched the same way. Returns cudaGetLastError().
__host__ inline int elementwise_floor(int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  bool small = false;
  cudaError_t err = elementwise_shape(n, &grid, &small);
  if (err != cudaSuccess) return static_cast<int>(err);
  empty_kernel<<<grid, kElementwiseThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stratified
