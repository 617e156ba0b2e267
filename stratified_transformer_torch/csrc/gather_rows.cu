// Masked row gather and its backward, for the model's gathers that autograd
// differentiates (ops/neighbors.py::GatherRows: the KPConv neighbours of
// the ScanNet stem's residual block, TransitionDown's kNN groups, Upsample's
// 3-NN rows).
//
//   forward   out[s] = mask[s] ? feats[idx[s]] : fill       s < S slots
//   backward  dfeats[r] = sum of g[s] over the slots s with mask[s] and
//             idx[s] == r, taken in ascending slot order    r < R rows
//
// Replaces no TPU kernel: the JAX package's gathers are jnp indexing, which
// XLA fuses. It was added because PyTorch's backward of `feats[idx]`
// (indexing_backward_kernel, a sort of the indices, then one warp walks each
// run of equal indices serially) took 56-63% of a training step on the H100
// (PERF.md): collate points every pad slot of a row at one source row (row
// 0, or the row's own index in the down levels' kNN), so a few rows own
// hundreds of thousands of slots whose gradient is exactly 0.
//
// Design: masked slots are never read, in either direction. The backward
// has no float atomics: it builds the inverse map (each source row's
// unmasked slots, in slot order) on the device from idx and mask alone,
// then one thread sums a row's 4 channels in that order, so two launches on
// the same inputs give bit-identical results (the same sums as index_add_
// on the CPU, which adds in slot order). The map (gather_rows_map), every
// size from the shapes and no host read:
//   1. count[r]: unmasked slots per row, by integer atomics (exact in any
//      order);
//   2. start = exclusive scan of count over R + 1 entries (start[R] = U,
//      the unmasked slots): tile sums, then each tile scanned from the
//      sum of the tiles before it;
//   3. placement: each unmasked slot takes a free place of its row's
//      segment by an integer atomic on count (which returns to 0), in any
//      order;
//   4. order: every segment sorted ascending (slot numbers are distinct).
//      A row of L <= kWarpRankMax slots: one warp ranks each slot by
//      shuffles, O(L^2 / 32). A longer row goes on a list that a second
//      kernel's blocks take one row at a time: runs of a block's width
//      sorted by rank in shared memory, then merged pairwise, each slot
//      placed by a binary search in the other run, O(L log L). The long
//      rows are real: Upsample's 3-NN names a few coarse rows from
//      thousands of fine points (up to 2157 at S3DIS's train batch, 4339
//      at ScanNet's), where a warp's O(L^2) took milliseconds.
//
// What bounds it on the H100: bytes, at 3.35 TB/s; no operation is more
// than a compare or an add per byte. With S slots, U of them unmasked, R
// rows of C fp32 channels, N <= min(U, R) of them named by a slot, and b
// bytes an index (4 or 8):
//   forward   N C 4 read + S (b + 1) read + S C 4 written
//   map       2 S (b + 1) read + (R + 1) 4 set + 2 (R + 1) 4 read
//             + (R + 1) 4 written + 3 U 4 moved
//   backward  U C 4 + U 4 + (R + 1) 4 read + R C 4 written
// Rows of C % 4 == 0 channels at 16-byte aligned pointers go a float4 a
// thread, neighbouring threads on neighbouring channels; others a float a
// thread. Out-of-range indices of unmasked slots are read as masked.
// Limits: S C and R C below 2^31 (the wrapper refuses more).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace stratified {

constexpr int kGatherThreads = 256;
// entries of count one block of the scan takes: kScanItems a thread
constexpr int kScanItems = 8;
constexpr int kScanTile = kGatherThreads * kScanItems;
constexpr unsigned kFullWarp = 0xffffffffu;
// the longest row whose slots one warp orders (gather_rows_order_kernel)
constexpr int kWarpRankMax = 64;
// blocks of gather_rows_long_kernel, which take the long rows in turn
constexpr int kLongBlocks = 264;
// slots whose gradient rows a backward thread loads before it adds them
constexpr int kBwdUnroll = 16;

// blocks of kGatherThreads that cover n work items once (the kernels loop
// over a grid stride, so any grid is right)
inline int cover_blocks(long long n) {
  const long long b = (n + kGatherThreads - 1) / kGatherThreads;
  return static_cast<int>(b < (1 << 30) ? b : (1 << 30));
}

// The source row of slot s, or -1 where the slot is masked or its index
// lies outside [0, rows).
template <typename Idx>
__device__ __forceinline__ int source_row(const Idx* __restrict__ idx,
                                          const unsigned char* __restrict__ mask,
                                          int s, int rows) {
  if (!mask[s]) return -1;
  const long long r = static_cast<long long>(idx[s]);
  return (r >= 0 && r < rows) ? static_cast<int>(r) : -1;
}

// ---- forward ------------------------------------------------------------

// One float4 of one slot a thread: t = s * c4 + j.
template <typename Idx>
__global__ void __launch_bounds__(kGatherThreads) gather_rows_fwd_vec_kernel(
    const float4* __restrict__ feats, const Idx* __restrict__ idx,
    const unsigned char* __restrict__ mask, float4* __restrict__ out,
    int slots, int rows, int c4, float fill) {
  const unsigned n = static_cast<unsigned>(slots) * c4;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const unsigned s = t / c4;
    const int r = source_row(idx, mask, static_cast<int>(s), rows);
    out[t] = r >= 0 ? __ldg(feats + static_cast<unsigned>(r) * c4 + (t - s * c4))
                    : make_float4(fill, fill, fill, fill);
  }
}

// One channel of one slot a thread.
template <typename Idx>
__global__ void __launch_bounds__(kGatherThreads) gather_rows_fwd_kernel(
    const float* __restrict__ feats, const Idx* __restrict__ idx,
    const unsigned char* __restrict__ mask, float* __restrict__ out,
    int slots, int rows, int c, float fill) {
  const unsigned n = static_cast<unsigned>(slots) * c;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const unsigned s = t / c;
    const int r = source_row(idx, mask, static_cast<int>(s), rows);
    out[t] = r >= 0 ? __ldg(feats + static_cast<unsigned>(r) * c + (t - s * c))
                    : fill;
  }
}

// ---- the inverse map ----------------------------------------------------

template <typename Idx>
__global__ void __launch_bounds__(kGatherThreads) gather_rows_count_kernel(
    const Idx* __restrict__ idx, const unsigned char* __restrict__ mask,
    unsigned slots, int rows, int* __restrict__ count) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned s = blockIdx.x * blockDim.x + threadIdx.x; s < slots;
       s += stride) {
    const int r = source_row(idx, mask, static_cast<int>(s), rows);
    if (r >= 0) atomicAdd(count + r, 1);
  }
}

// The sum of v over the block (every thread gets it); `scratch` holds a
// value per warp.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullWarp, v, o);
  __syncthreads();                     // scratch free from an earlier use
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kGatherThreads / 32; ++w) total += scratch[w];
  return total;
}

// tile_sum[b] = the sum of count over tile b (kScanTile entries of n).
__global__ void __launch_bounds__(kGatherThreads) gather_rows_tile_sum_kernel(
    const int* __restrict__ count, int n, int* __restrict__ tile_sum) {
  __shared__ int scratch[kGatherThreads / 32];
  const int lo = blockIdx.x * kScanTile;
  const int hi = min(n, lo + kScanTile);
  int v = 0;
  for (int i = lo + threadIdx.x; i < hi; i += kGatherThreads) v += count[i];
  v = block_sum(v, scratch);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = v;
}

// start[i] = the sum of count[0, i), for i < n: each block scans its tile
// from the sum of the tiles before it.
__global__ void __launch_bounds__(kGatherThreads) gather_rows_scan_kernel(
    const int* __restrict__ count, int n, const int* __restrict__ tile_sum,
    int* __restrict__ start) {
  __shared__ int items[kScanTile];
  __shared__ int scratch[kGatherThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int before = 0;
  for (int b = threadIdx.x; b < static_cast<int>(blockIdx.x);
       b += kGatherThreads)
    before += tile_sum[b];
  before = block_sum(before, scratch);

  const int lo = blockIdx.x * kScanTile;
  for (int i = threadIdx.x; i < kScanTile; i += kGatherThreads)
    items[i] = lo + i < n ? count[lo + i] : 0;
  __syncthreads();
  int local[kScanItems];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    local[k] = items[threadIdx.x * kScanItems + k];
    sum += local[k];
  }
  // inclusive scan of the threads' sums: within the warp, then the warps'
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFullWarp, incl, o);
    if (lane >= o) incl += up;
  }
  __syncthreads();                     // scratch read by block_sum
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += scratch[w];
  int run = before + incl - sum;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    items[threadIdx.x * kScanItems + k] = run;
    run += local[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kScanTile; i += kGatherThreads)
    if (lo + i < n) start[lo + i] = items[i];
}

// Each unmasked slot takes a place in its row's segment; count returns to 0.
template <typename Idx>
__global__ void __launch_bounds__(kGatherThreads) gather_rows_place_kernel(
    const Idx* __restrict__ idx, const unsigned char* __restrict__ mask,
    unsigned slots, int rows, const int* __restrict__ start,
    int* __restrict__ count,
    int* __restrict__ placed) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned s = blockIdx.x * blockDim.x + threadIdx.x; s < slots;
       s += stride) {
    const int r = source_row(idx, mask, static_cast<int>(s), rows);
    if (r >= 0)
      placed[start[r] + atomicSub(count + r, 1) - 1] = static_cast<int>(s);
  }
}

// One warp a row of at most kWarpRankMax slots: each slot of the segment
// goes to start[r] + the number of the segment's slots below it. A longer
// row goes on long_rows (its place there by an integer atomic on
// *long_count: any order, each row sorted alone).
__global__ void __launch_bounds__(kGatherThreads) gather_rows_order_kernel(
    const int* __restrict__ start, const int* __restrict__ placed, int rows,
    int* __restrict__ order, int* __restrict__ long_rows,
    int* __restrict__ long_count) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kGatherThreads / 32);
  for (int r = blockIdx.x * (kGatherThreads / 32) + (threadIdx.x >> 5);
       r < rows; r += warps) {
    const int b = start[r], len = start[r + 1] - b;
    if (len > kWarpRankMax) {
      if (lane == 0) long_rows[atomicAdd(long_count, 1)] = r;
      continue;
    }
    for (int i0 = 0; i0 < len; i0 += 32) {
      const int v = i0 + lane < len ? placed[b + i0 + lane] : INT_MAX;
      int rank = 0;
      for (int k0 = 0; k0 < len; k0 += 32) {
        const int w = k0 + lane < len ? placed[b + k0 + lane] : INT_MAX;
        const int m = min(32, len - k0);
        for (int k = 0; k < m; ++k)
          rank += __shfl_sync(kFullWarp, w, k) < v;
      }
      if (i0 + lane < len) order[b + rank] = v;
    }
  }
}

// The number of entries of a[0, n) (ascending) below v.
__device__ __forceinline__ int count_below(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One block a long row at a time. Runs of kGatherThreads slots are sorted
// by rank in shared memory, then runs of w merged pairwise into runs of 2w,
// ping-ponging between placed and order within the segment so that the
// last pass writes order. placed and order are read here after this
// kernel's own writes (after __syncthreads), so no read-only loads.
__global__ void __launch_bounds__(kGatherThreads) gather_rows_long_kernel(
    const int* __restrict__ start, const int* __restrict__ long_rows,
    const int* __restrict__ long_count, int* placed, int* order) {
  __shared__ int run[kGatherThreads];
  const int t = threadIdx.x;
  const int n_long = *long_count;
  for (int i = blockIdx.x; i < n_long; i += gridDim.x) {
    const int r = long_rows[i];
    const int b = start[r], len = start[r + 1] - b;
    int passes = 0;
    for (int w = kGatherThreads; w < len; w <<= 1) ++passes;
    int* src = placed + b;
    int* dst = (passes & 1 ? placed : order) + b;
    for (int q = 0; q < len; q += kGatherThreads) {
      const int m = min(kGatherThreads, len - q);
      const int v = t < m ? src[q + t] : INT_MAX;
      run[t] = v;
      __syncthreads();
      int rank = 0;
      for (int k = 0; k < m; ++k) rank += run[k] < v;
      if (t < m) dst[q + rank] = v;
      __syncthreads();
    }
    src = dst;
    dst = (src == placed + b ? order : placed) + b;
    for (int w = kGatherThreads; w < len; w <<= 1) {
      for (int p = t; p < len; p += kGatherThreads) {
        const int base = p / (2 * w) * (2 * w);
        const int mid = min(base + w, len), end = min(base + 2 * w, len);
        const int v = src[p];
        dst[p < mid ? p + count_below(src + mid, end - mid, v)
                    : p - w + count_below(src + base, mid - base, v)] = v;
      }
      __syncthreads();
      int* tmp = src;
      src = dst;
      dst = tmp;
    }
  }
}

// ---- backward -----------------------------------------------------------

// One float4 of one row a thread, its slots' gradients added in slot
// order: kBwdUnroll slots' rows loaded before their adds, and the next
// kBwdUnroll slot numbers while those rows arrive (a long row's thread is
// the kernel's tail).
__global__ void __launch_bounds__(kGatherThreads) gather_rows_bwd_vec_kernel(
    const float4* __restrict__ g, const int* __restrict__ start,
    const int* __restrict__ order, float4* __restrict__ dfeats, int rows,
    int c4) {
  const unsigned n = static_cast<unsigned>(rows) * c4;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const unsigned r = t / c4, j = t - r * c4;
    const int e = start[r + 1];
    int i = start[r];
    int o[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) o[u] = i + u < e ? order[i + u] : 0;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (; i < e; i += kBwdUnroll) {
      float4 v[kBwdUnroll];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u)
        if (i + u < e) v[u] = __ldg(g + static_cast<unsigned>(o[u]) * c4 + j);
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u)
        o[u] = i + kBwdUnroll + u < e ? order[i + kBwdUnroll + u] : 0;
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        if (i + u < e) {
          acc.x += v[u].x;
          acc.y += v[u].y;
          acc.z += v[u].z;
          acc.w += v[u].w;
        }
      }
    }
    dfeats[t] = acc;
  }
}

// One channel of one row a thread, as the float4 kernel.
__global__ void __launch_bounds__(kGatherThreads) gather_rows_bwd_kernel(
    const float* __restrict__ g, const int* __restrict__ start,
    const int* __restrict__ order, float* __restrict__ dfeats, int rows,
    int c) {
  const unsigned n = static_cast<unsigned>(rows) * c;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const unsigned r = t / c, j = t - r * c;
    const int e = start[r + 1];
    int i = start[r];
    int o[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) o[u] = i + u < e ? order[i + u] : 0;
    float acc = 0.f;
    for (; i < e; i += kBwdUnroll) {
      float v[kBwdUnroll];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u)
        if (i + u < e) v[u] = __ldg(g + static_cast<unsigned>(o[u]) * c + j);
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u)
        o[u] = i + kBwdUnroll + u < e ? order[i + kBwdUnroll + u] : 0;
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u)
        if (i + u < e) acc += v[u];
    }
    dfeats[t] = acc;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename Idx>
int fwd_launch(const float* feats, const void* idx, const unsigned char* mask,
               float* out, int slots, int rows, int c, float fill,
               cudaStream_t s) {
  const Idx* ix = static_cast<const Idx*>(idx);
  if (c % 4 == 0 && aligned16(feats) && aligned16(out)) {
    const int c4 = c / 4;
    gather_rows_fwd_vec_kernel<Idx>
        <<<cover_blocks(static_cast<long long>(slots) * c4), kGatherThreads, 0,
           s>>>(reinterpret_cast<const float4*>(feats), ix, mask,
                reinterpret_cast<float4*>(out), slots, rows, c4, fill);
  } else {
    gather_rows_fwd_kernel<Idx>
        <<<cover_blocks(static_cast<long long>(slots) * c), kGatherThreads, 0,
           s>>>(feats, ix, mask, out, slots, rows, c, fill);
  }
  return static_cast<int>(cudaGetLastError());
}

// Entries of the map's int32 scratch for `rows` rows and `slots` slots:
// count [rows + 1] and the long rows' count, the tile sums, the long rows
// (a long row holds more than kWarpRankMax of the slots).
inline int scan_tiles(int rows) { return (rows + 1 + kScanTile - 1) / kScanTile; }
inline long long map_scratch(int rows, int slots) {
  return rows + 2LL + scan_tiles(rows) + slots / (kWarpRankMax + 1) + 1;
}

template <typename Idx>
int map_launch(const void* idx, const unsigned char* mask, int slots, int rows,
               int* scratch, int* start, int* placed, int* order,
               cudaStream_t s) {
  const Idx* ix = static_cast<const Idx*>(idx);
  const int n = rows + 1;
  const int tiles = scan_tiles(rows);
  int* count = scratch;
  int* long_count = scratch + n;
  int* tile_sum = long_count + 1;
  int* long_rows = tile_sum + tiles;
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int) * (n + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_rows_count_kernel<Idx>
      <<<cover_blocks(slots), kGatherThreads, 0, s>>>(ix, mask, slots, rows,
                                                       count);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  gather_rows_tile_sum_kernel<<<tiles, kGatherThreads, 0, s>>>(count, n,
                                                                tile_sum);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  gather_rows_scan_kernel<<<tiles, kGatherThreads, 0, s>>>(count, n, tile_sum,
                                                            start);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  gather_rows_place_kernel<Idx><<<cover_blocks(slots), kGatherThreads, 0, s>>>(
      ix, mask, slots, rows, start, count, placed);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  gather_rows_order_kernel<<<cover_blocks(static_cast<long long>(rows) * 32),
                             kGatherThreads, 0, s>>>(start, placed, rows,
                                                     order, long_rows,
                                                     long_count);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  gather_rows_long_kernel<<<kLongBlocks, kGatherThreads, 0, s>>>(
      start, long_rows, long_count, placed, order);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stratified

// C entry points, bound with ctypes. Each returns cudaGetLastError() after
// its launches (cudaErrorInvalidValue, and no launch, for empty shapes).
// idx: int32 (idx64 0) or int64 (idx64 1); mask: bool, one byte a slot.

// out [slots, c] fp32 from feats [rows, c] fp32.
extern "C" int gather_rows_fwd(const float* feats, const void* idx,
                               const unsigned char* mask, float* out,
                               int slots, int rows, int c, float fill,
                               int idx64, void* stream) {
  if (slots <= 0 || rows <= 0 || c <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return idx64 ? stratified::fwd_launch<long long>(feats, idx, mask, out,
                                                   slots, rows, c, fill, s)
               : stratified::fwd_launch<int>(feats, idx, mask, out, slots,
                                             rows, c, fill, s);
}

// The inverse map: start [rows + 1] and order [slots] (its first start[rows]
// entries), with scratch [gather_rows_map_scratch(rows, slots)] and placed
// [slots].
extern "C" int gather_rows_map(const void* idx, const unsigned char* mask,
                               int slots, int rows, int* scratch, int* start,
                               int* placed, int* order, int idx64,
                               void* stream) {
  if (slots <= 0 || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return idx64 ? stratified::map_launch<long long>(idx, mask, slots, rows,
                                                   scratch, start, placed,
                                                   order, s)
               : stratified::map_launch<int>(idx, mask, slots, rows, scratch,
                                             start, placed, order, s);
}

// Entries of gather_rows_map's scratch for `rows` rows and `slots` slots.
extern "C" long long gather_rows_map_scratch(int rows, int slots) {
  return stratified::map_scratch(rows, slots);
}

// dfeats [rows, c] fp32 from g [slots, c] fp32 and the map.
extern "C" int gather_rows_bwd(const float* g, const int* start,
                               const int* order, float* dfeats, int rows,
                               int c, void* stream) {
  if (rows <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 4 == 0 && stratified::aligned16(g) && stratified::aligned16(dfeats))
    stratified::gather_rows_bwd_vec_kernel
        <<<stratified::cover_blocks(static_cast<long long>(rows) * (c / 4)),
           stratified::kGatherThreads, 0, s>>>(
            reinterpret_cast<const float4*>(g), start, order,
            reinterpret_cast<float4*>(dfeats), rows, c / 4);
  else
    stratified::gather_rows_bwd_kernel
        <<<stratified::cover_blocks(static_cast<long long>(rows) * c),
           stratified::kGatherThreads, 0, s>>>(g, start, order, dfeats, rows,
                                               c);
  return static_cast<int>(cudaGetLastError());
}
