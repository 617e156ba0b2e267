// Dense (same-window) half of stratified attention, backward.
//
// Replaces the Pallas TPU kernel _band_bwd_kernel of
// stratified_transformer_tpu/ops/pallas/fused_attention_bwd.py (wrapper
// band_attention_bwd). Plain PyTorch version: band_attention_bwd_plain in
// stratified_transformer_torch/ops/attention.py.
//
// One block per (tile, head), one thread per query row: a row of tile t0
// sees keys [t0 - band, t0 + tile + band) ∩ [seg_start, seg_end), both ends
// valid, as in the forward. The block runs attention_bwd_block
// (attention_bwd_common.cuh, which states the formulas and how sums are
// ordered) over that window. Outputs: dq [N,H,D] (times scale); dk and dv
// per key slot of the tile, [tiles][tile + 2*band][H][D] with slot
// key - (t0 - band); the table-slice grads per (tile, head). The wrapper
// composes dk/dv by absolute key position, so any band works (the TPU
// kernel needed band % tile == 0), sums the table partials over tiles and
// places them at bin_lo.
//
// What bounds it on the H100: the recompute of each unmasked pair (~350
// fp32 operations per pair and head at D = 16: the forward's logit, g·v and
// three g·Tv dot products, dq's k + ΣTq), the key side (~100 in phase B)
// and the table grads (three 16-wide multiply-adds per pair, axis and half-
// warp in phase C, walked serially by one warp per axis). The least work
// projects rows, keys and bin masses onto the 3 x nb table rows once;
// chip_smoke.py counts it from the run's data and bounds the kernel by the
// larger of those operations over 67 TFLOP/s and the bytes it must move
// (q, k, v, g, o, m, den in; dq, dk, dv, table grads out) over 3.35 TB/s.
// The design spends nothing on masked pairs (the block visits only the
// union of its rows' segments) and uses no atomics; wgmma tiles, TMA
// staging, per-bin projections for the table terms and a bf16 mode are left
// for later work.

#include "attention_bwd_common.cuh"

namespace stratified {

template <int D>
__global__ void band_attention_bwd_kernel(BwdQueries Q, BwdKeys K,
                                          BwdTables T, BwdOutputs O, int n,
                                          int h, int band, float scale) {
  const int tile = blockDim.x;
  const int t0 = blockIdx.x * tile;
  attention_bwd_block<D>(Q, K, T, O, n, h, blockIdx.x, max(t0 - band, 0),
                         min(t0 + tile + band, n), t0 - band,
                         tile + 2 * band, scale);
}

}  // namespace stratified

// C entry point, bound with ctypes. q is pre-scaled by d^-0.5; q/k/v/g/o
// are [N,H,D] fp32, m/den [N,H] (merged over both halves), xyz [N,3],
// seg bounds [N] int32, valid [N] bool; tables [H,3,nb,D] fp32 slices or
// null. dk_part/dv_part must be zeroed by the caller. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head
// size other than 16, a tile that is not a multiple of 32, or more than
// 256 table rows).
extern "C" int band_attention_bwd(
    const float* q, const float* k, const float* v, const float* xyz,
    const int32_t* seg_start, const int32_t* seg_end, const uint8_t* valid,
    const float* g, const float* o, const float* m, const float* den,
    const float* tq, const float* tk, const float* tv, float* dq,
    float* dk_part, float* dv_part, float* dt_part, int n, int h, int d,
    int tile, int band, int nb, int bin_lo, int nb_full, float bin_offset,
    float inv_quant, float scale, void* stream) {
  using namespace stratified;
  // Every stage of the ported configurations has D = 16; instantiate more
  // head sizes when a configuration needs them.
  if (d != 16 || tile % 32 != 0 || tile <= 0 || tile > 1024 || nb > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdQueries Q{q, g, o, m, den, xyz, valid, seg_start, seg_end,
                     nullptr};
  const BwdKeys K{k, v, xyz, valid, nullptr};
  const BwdTables T{tq, tk, tv, nb, bin_lo, nb_full, bin_offset, inv_quant};
  const BwdOutputs O{dq, dk_part, dv_part, dt_part};
  const size_t smem = bwd_smem_bytes<16>(nb, tile);
  cudaError_t err = cudaFuncSetAttribute(
      band_attention_bwd_kernel<16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n / tile, h);
  band_attention_bwd_kernel<16><<<grid, tile, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      Q, K, T, O, n, h, band, scale);
  return static_cast<int>(cudaGetLastError());
}
