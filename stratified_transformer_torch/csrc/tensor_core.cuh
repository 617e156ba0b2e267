// Device helpers of the kernels' fast forms on the tensor cores, forward
// (attention_fwd_tc.cuh) and backward (attention_bwd_tc.cuh): the bf16
// tables' struct, ldmatrix, mma.m16n8k8, cp.async, a warp's bounding box
// and the walk that adds values into a row of bin masses in a fixed order.
#pragma once

#include "attention_common.cuh"

namespace stratified {

// bf16 cRPE tables ([H][3][nb][D] slices, each may be null) and their bins.
struct TcTables {
  const __nv_bfloat16* tq;
  const __nv_bfloat16* tk;
  const __nv_bfloat16* tv;
  int nb;
  int bin_lo;
  int nb_full;
  float bin_offset;
  float inv_quant;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 16-channel bf16 row of 32 bytes at row `row` of an array at shared
// address `base`: its two 16-byte halves swap places on every other group
// of four rows, so that the same half of 8 consecutive rows falls on 8
// distinct groups of banks (ldmatrix, cp.async).
__device__ __forceinline__ uint32_t row16(uint32_t base, int row, int half) {
  return base + row * 32 + ((half ^ ((row >> 2) & 1)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

// D += A·B, A 16x8 bf16 (row-major fragment), B 8x8 bf16 (column-major), D
// 16x8 fp32 (PTX ISA, mma.m16n8k8).
__device__ __forceinline__ void mma_bf16_1688(float (&d)[4],
                                              const uint32_t (&a)[2],
                                              uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// 16 (or, with !full, 0: zero-filled) bytes from global to shared memory,
// asynchronously (cp.async.cg: through L2 only).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int tc_max(int a, int b) { return a > b ? a : b; }

// min (lanes' b[0..2]) and max (b[3..5]) over a warp
__device__ __forceinline__ void warp_box(float (&b)[6]) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1)
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float o = __shfl_xor_sync(0xffffffffu, b[i], s);
      b[i] = i < 3 ? fminf(b[i], o) : fmaxf(b[i], o);
    }
}

__device__ __forceinline__ float mass_add(float a, float b) { return a + b; }
__device__ __forceinline__ float2 mass_add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// Adds values into the entries of one shared-memory row of masses, in the
// order given: the entry being added to stays in registers while the bin
// repeats, and a new bin's entry is loaded before the last one is stored
// (the two differ), so that two entries are in flight. Each entry's sum
// runs in the order of its adds, as adding to memory one by one would.
template <typename T>
struct MassWalk {
  T* row;
  int bin = -1;
  T acc;
  __device__ explicit MassWalk(T* r) : row(r) {}
  __device__ __forceinline__ void add(int b, T v) {
    if (b == bin) {
      acc = mass_add(acc, v);
      return;
    }
    const T m = row[b];
    if (bin >= 0) row[bin] = acc;
    acc = mass_add(m, v);
    bin = b;
  }
  __device__ __forceinline__ void done() {
    if (bin >= 0) row[bin] = acc;
  }
};

}  // namespace stratified
