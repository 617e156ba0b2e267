// Dense (same-window) half of stratified attention, backward.
//
// Replaces the Pallas TPU kernel _band_bwd_kernel of
// stratified_transformer_tpu/ops/pallas/fused_attention_bwd.py (wrapper
// band_attention_bwd). Plain PyTorch version: band_attention_bwd_plain in
// stratified_transformer_torch/ops/attention.py.
//
// One block of 256 threads per (64-row slice of a 128-row tile, head): a
// row of tile t0 sees keys [t0 - band, t0 + tile + band) ∩ [seg_start,
// seg_end), both ends valid, as in the forward. The block runs
// attention_bwd_block (attention_bwd_common.cuh, which states the formulas,
// the projection form of the table terms and how sums are ordered) over
// that window. Outputs: dq [N,H,D] (times scale); dk and dv per key slot of
// each (tile, slice), [tiles * slices][tile + 2*band][H][D] with slot
// key - (t0 - band); the table-slice grads per (tile, slice, head). The
// wrapper adds the slices, composes dk/dv by absolute key position, so any
// band works (the TPU kernel needed band % tile == 0), sums the table
// partials over tiles and places them at bin_lo.
//
// What bounds it on the H100: the fp32 work of the unmasked pairs (the
// recomputed q·k and g·v, dl, dq, dk and dv: ~10 multiply-adds per channel
// per pair and head) plus the table terms through the projections (3
// lookups per table and pair, the masses, and products of 3·nb x 16 per
// row and per key); chip_smoke.py counts the least such work from the run's
// data and bounds the kernel by the larger of those operations over 67
// TFLOP/s and the bytes it must move (q, k, v, g, o, m, den in; dq, dk, dv,
// table grads out) over 3.35 TB/s. The design spends nothing on masked
// sub-tiles (the block visits only the union of its rows' segments, and a
// warp only the keys of a chunk that its rows reach), uses no atomics and
// keeps 8 warps per SM busy in every phase; the products run on fp32 FMA
// (tensor cores, TMA staging and a bf16 mode are left for later work).

#include "attention_bwd_common.cuh"

namespace stratified {

constexpr int kBandBwdRows = 64;   // rows per block: 2 slices of a tile

template <int D, int R>
__global__ void __launch_bounds__(kBwdThreads, 1)
band_attention_bwd_kernel(BwdQueries Q, BwdKeys K, BwdTables T, BwdOutputs O,
                          int n, int h, int tile, int band, float scale) {
  const int slices = tile / R;
  const int tile_idx = blockIdx.x / slices;
  const int t0 = tile_idx * tile;
  attention_bwd_block<D, R>(Q, K, T, O, h, blockIdx.x,
                            t0 + (blockIdx.x - tile_idx * slices) * R,
                            max(t0 - band, 0), min(t0 + tile + band, n),
                            t0 - band, tile + 2 * band, scale);
}

}  // namespace stratified

// C entry point, bound with ctypes. q is pre-scaled by d^-0.5; q/k/v/g/o
// are [N,H,D] fp32, m/den [N,H] (merged over both halves), xyz [N,3],
// seg bounds [N] int32, valid [N] bool; tables [H,3,nb,D] fp32 slices or
// null. dk_part/dv_part ([N / 64][tile + 2*band][H][D]) must be zeroed by
// the caller; dt_part is [N / 64][H][3][3][nb][D]. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head
// size other than 16, a tile that is not a multiple of 64, or more table
// rows per axis than band_attention_bwd_limits gives).
extern "C" int band_attention_bwd(
    const float* q, const float* k, const float* v, const float* xyz,
    const int32_t* seg_start, const int32_t* seg_end, const uint8_t* valid,
    const float* g, const float* o, const float* m, const float* den,
    const float* tq, const float* tk, const float* tv, float* dq,
    float* dk_part, float* dv_part, float* dt_part, int n, int h, int d,
    int tile, int band, int nb, int bin_lo, int nb_full, float bin_offset,
    float inv_quant, float scale, void* stream) {
  using namespace stratified;
  constexpr int R = kBandBwdRows;
  size_t room = 0;
  cudaError_t err = smem_room(band_attention_bwd_kernel<16, R>, &room);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Every stage of the ported configurations has D = 16; instantiate more
  // head sizes when a configuration needs them.
  if (d != 16 || tile <= 0 || tile % R != 0 || n % tile != 0 || nb < 0 ||
      nb > bwd_max_nb<16, R>(room))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdQueries Q{q, g, o, m, den, xyz, valid, seg_start, seg_end,
                     nullptr};
  const BwdKeys K{k, v, xyz, valid, nullptr};
  const BwdTables T{tq, tk, tv, nb, bin_lo, nb_full, bin_offset, inv_quant};
  const BwdOutputs O{dq, dk_part, dv_part, dt_part};
  const size_t smem = BwdSmem<16, R>(nb).bytes();
  err = cudaFuncSetAttribute(
      band_attention_bwd_kernel<16, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n / R, h);
  band_attention_bwd_kernel<16, R><<<grid, kBwdThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      Q, K, T, O, n, h, tile, band, scale);
  return static_cast<int>(cudaGetLastError());
}

// Rows per block, and the most table rows per axis whose block fits the
// current device's shared memory per block (45 on the H100; the band
// slice of a 64-bin table has 40). Returns a cudaError_t.
extern "C" int band_attention_bwd_limits(int* rows, int* max_nb) {
  using namespace stratified;
  constexpr int R = kBandBwdRows;
  size_t room = 0;
  const cudaError_t err =
      smem_room(band_attention_bwd_kernel<16, R>, &room);
  if (err != cudaSuccess) return static_cast<int>(err);
  *rows = R;
  *max_nb = bwd_max_nb<16, R>(room);
  return 0;
}
