// Dense (same-window) half of stratified attention, backward.
//
// Replaces the Pallas TPU kernel _band_bwd_kernel of
// stratified_transformer_tpu/ops/pallas/fused_attention_bwd.py (wrapper
// band_attention_bwd). Plain PyTorch version: band_attention_bwd_plain in
// stratified_transformer_torch/ops/attention.py.
//
// One block of 256 threads per (R-row slice of a 128-row tile, head), R =
// 64, 32 or 16 as the table size allows (kBandBwdRows; the swin mode,
// kBandBwdSwinRows): a row of tile t0
// sees keys [t0 - band, t0 + tile + band) ∩ [seg_start,
// seg_end), both ends valid, as in the forward. The block runs
// attention_bwd_block (attention_bwd_common.cuh, which states the formulas,
// the projection form of the table terms and how sums are ordered) over
// that window. Outputs: dq [N,H,D] (times scale); dk and dv per key slot of
// each (tile, slice), [tiles * slices][tile + 2*band][H][D] with slot
// key - (t0 - band); the table-slice grads per (tile, slice, head). The
// wrapper adds the slices, composes dk/dv by absolute key position, so any
// band works (the TPU kernel needed band % tile == 0), sums the table
// partials over tiles and places them at bin_lo.
// The swin mode (swin 1, Swin3D; kSwin instantiations) takes Swin3D's bins
// as the forward does (band_attention.cu): the whole table of 2 qgl - 1
// rows (31 for the shipped Swin YAMLs), bin_lo 0. A swin row sees only
// its own window, tens of keys, so a 64-row block spent most of its time
// in fixed costs, serial walks and barriers at one block per SM (PERF.md,
// the swin backward's phase split). Its blocks take 32 rows and run two
// per SM (bwd_paired) up to 32 table rows per axis (kBandBwdSwinRows
// beyond).
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
// warp only the keys of a chunk that its rows reach), uses no atomics, keeps
// 8 warps per block busy in every phase and loads the key chunks by
// cp.async while the chunk before computes; the products run on fp32 FMA.
// The fast form (band_attention_bwd_bf16, its kSwin mode included) is the
// TPU kernel's fast=True (fused_attention_bwd.py:95): the operands of its
// DEFAULT products in bf16. What bounds it on the H100 is bytes (PERF.md:
// 0.096 ms per S3DIS train step, 0.503 per ScanNet step, the products at
// the bf16 tensor-core peak); it runs attention_bwd_block_tc
// (attention_bwd_tc.cuh), which puts every bf16 product on mma.sync, takes
// bf16 copies made once by the wrapper, loads the key chunks by cp.async
// into a double buffer and multiplies only the (axis, bin) tiles the
// block's pairs can reach. Its blocks take their own heights
// (band_attention_bwd_bf16_limits: 64 rows for S3DIS's 40-row slice,
// Swin3D's 31-row tables and ScanNet's 48-row slice).

#include "attention_bwd_common.cuh"
#include "attention_bwd_tc.cuh"

namespace stratified {

// Block heights the launcher offers, in order of preference: 64 rows (2
// slices of a tile) while the table fits, as S3DIS's 40-row band slice
// does; 32 rows for up to 64 table rows per axis (ScanNet's band slice of
// 48); 16 rows beyond that. The swin mode: 32 rows, two blocks per SM, up
// to 32 table rows per axis (Swin3D's 31); then 64 rows, one block per SM
// (a window of 5 quanta, 39 rows); 16 rows beyond that.
constexpr int kBandBwdRows[] = {64, 32, 16};
constexpr int kBandBwdSwinRows[] = {32, 64, 16};
constexpr int kBandBwdShapes = 3;

template <int D, int R, bool kSwin>
__global__ void __launch_bounds__(kBwdThreads, bwd_paired<R, kSwin>() ? 2 : 1)
band_attention_bwd_kernel(BwdQueries Q, BwdKeys K, BwdTables T, BwdOutputs O,
                          int n, int h, int tile, int band, float scale) {
  const int slices = tile / R;
  const int tile_idx = blockIdx.x / slices;
  const int t0 = tile_idx * tile;
  attention_bwd_block<D, R, kSwin>(Q, K, T, O, h, blockIdx.x,
                                   t0 + (blockIdx.x - tile_idx * slices) * R,
                                   max(t0 - band, 0),
                                   min(t0 + tile + band, n), t0 - band,
                                   tile + 2 * band, scale);
}

template <int R, bool kSwin>
cudaError_t band_bwd_max_nb(int* max_nb) {
  size_t room = 0;
  const cudaError_t err =
      smem_room(band_attention_bwd_kernel<16, R, kSwin>, &room);
  if (err == cudaSuccess) *max_nb = bwd_max_nb<16, R, kSwin>(room);
  return err;
}

// Rows per block for nb table rows per axis (0 if no block takes them) and
// the most rows per axis that any block takes on the current device, in
// the stratified bins or (kSwin) the swin mode.
template <bool kSwin>
cudaError_t band_bwd_rows(int nb, int* rows, int* max_nb) {
  int fit[kBandBwdShapes];
  cudaError_t err;
  if constexpr (kSwin) {
    err = band_bwd_max_nb<32, true>(&fit[0]);
    if (err == cudaSuccess) err = band_bwd_max_nb<64, true>(&fit[1]);
    if (err == cudaSuccess) err = band_bwd_max_nb<16, true>(&fit[2]);
    if (err == cudaSuccess)
      bwd_pick_rows(nb, kBandBwdSwinRows, fit, kBandBwdShapes, rows, max_nb);
  } else {
    err = band_bwd_max_nb<64, false>(&fit[0]);
    if (err == cudaSuccess) err = band_bwd_max_nb<32, false>(&fit[1]);
    if (err == cudaSuccess) err = band_bwd_max_nb<16, false>(&fit[2]);
    if (err == cudaSuccess)
      bwd_pick_rows(nb, kBandBwdRows, fit, kBandBwdShapes, rows, max_nb);
  }
  return err;
}

// The launch attributes of a block of R rows with smem bytes of dynamic
// shared memory: all of the SM's unified memory as shared memory, so that
// the paired blocks fit side by side.
template <int R, bool kSwin>
cudaError_t band_bwd_attributes(size_t smem) {
  const auto kernel = band_attention_bwd_kernel<16, R, kSwin>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int R, bool kSwin>
cudaError_t band_bwd_launch(const BwdQueries& Q, const BwdKeys& K,
                            const BwdTables& T, const BwdOutputs& O, int n,
                            int h, int tile, int band, float scale,
                            cudaStream_t stream) {
  const size_t smem = BwdSmem<16, R>(T.nb).bytes();
  const cudaError_t err = band_bwd_attributes<R, kSwin>(smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n / R, h);
  band_attention_bwd_kernel<16, R, kSwin><<<grid, kBwdThreads, smem, stream>>>(
      Q, K, T, O, n, h, tile, band, scale);
  return cudaGetLastError();
}

// The launch at the block height band_bwd_rows picked.
template <bool kSwin>
cudaError_t band_bwd_rows_launch(int rows, const BwdQueries& Q,
                                 const BwdKeys& K, const BwdTables& T,
                                 const BwdOutputs& O, int n, int h, int tile,
                                 int band, float scale, cudaStream_t st) {
  if (rows == 64)
    return band_bwd_launch<64, kSwin>(Q, K, T, O, n, h, tile, band, scale,
                                      st);
  if (rows == 32)
    return band_bwd_launch<32, kSwin>(Q, K, T, O, n, h, tile, band, scale,
                                      st);
  return band_bwd_launch<16, kSwin>(Q, K, T, O, n, h, tile, band, scale, st);
}

template <int R, bool kSwin>
cudaError_t band_bwd_occupancy(int nb, int* blocks) {
  const size_t smem = BwdSmem<16, R>(nb).bytes();
  cudaError_t err = band_bwd_attributes<R, kSwin>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, band_attention_bwd_kernel<16, R, kSwin>, kBwdThreads, smem);
  return err;
}

// Blocks of the height band_bwd_rows picks for nb table rows per axis that
// one SM of the current device holds at once (0 if no block takes nb).
template <bool kSwin>
cudaError_t band_bwd_blocks(int nb, int* blocks) {
  int rows = 0, max_nb = 0;
  *blocks = 0;
  const cudaError_t err = band_bwd_rows<kSwin>(nb, &rows, &max_nb);
  if (err != cudaSuccess || rows == 0) return err;
  if (rows == 64) return band_bwd_occupancy<64, kSwin>(nb, blocks);
  if (rows == 32) return band_bwd_occupancy<32, kSwin>(nb, blocks);
  return band_bwd_occupancy<16, kSwin>(nb, blocks);
}

// The rows of q, g, k and v start on 16 bytes (the routine's cp.async).
inline bool rows16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

inline cudaError_t band_bwd(
    const float* q, const float* k, const float* v, const float* xyz,
    const int32_t* seg_start, const int32_t* seg_end, const uint8_t* valid,
    const float* g, const float* o, const float* m, const float* den,
    const float* tq, const float* tk, const float* tv, float* dq,
    float* dk_part, float* dv_part, float* dt_part, int n, int h, int d,
    int tile, int band, int nb, int bin_lo, int nb_full, int swin,
    float bin_offset, float inv_quant, float scale, cudaStream_t st) {
  int rows = 0, max_nb = 0;
  const cudaError_t err = swin ? band_bwd_rows<true>(nb, &rows, &max_nb)
                               : band_bwd_rows<false>(nb, &rows, &max_nb);
  if (err != cudaSuccess) return err;
  // Every stage of the ported configurations has D = 16; instantiate more
  // head sizes when a configuration needs them. The swin mode reads the
  // whole table, no slice.
  if (d != 16 || rows == 0 || tile <= 0 || tile % rows != 0 ||
      n % tile != 0 || nb < 0 ||
      (swin != 0 && (bin_lo != 0 || nb != nb_full)) || !rows16(q) ||
      !rows16(k) || !rows16(v) || !rows16(g) || !rows16(tq) ||
      !rows16(tk) || !rows16(tv))
    return cudaErrorInvalidValue;
  const BwdQueries Q{q, g, o, m, den, xyz, valid, seg_start, seg_end,
                     nullptr};
  const BwdKeys K{k, v, xyz, valid, nullptr};
  const BwdTables T{tq, tk, tv, nb, bin_lo, nb_full, bin_offset, inv_quant};
  const BwdOutputs O{dq, dk_part, dv_part, dt_part};
  return swin ? band_bwd_rows_launch<true>(rows, Q, K, T, O, n, h, tile,
                                           band, scale, st)
              : band_bwd_rows_launch<false>(rows, Q, K, T, O, n, h, tile,
                                            band, scale, st);
}

// ---- the fast form: attention_bwd_block_tc (attention_bwd_tc.cuh) -------

template <int R, bool kSwin>
__global__ void __launch_bounds__(kTcThreads, 1)
band_attention_bwd_tc_kernel(TcQueries Q, TcKeys K, TcTables T, BwdOutputs O,
                             int n, int h, int tile, int band, float scale) {
  const int slices = tile / R;
  const int tile_idx = blockIdx.x / slices;
  const int t0 = tile_idx * tile;
  attention_bwd_block_tc<R, kSwin>(Q, K, T, O, h, blockIdx.x,
                                   t0 + (blockIdx.x - tile_idx * slices) * R,
                                   max(t0 - band, 0),
                                   min(t0 + tile + band, n), t0 - band,
                                   tile + 2 * band, scale);
}

template <int R>
cudaError_t band_bwd_tc_max_nb(int* max_nb) {
  size_t room = 0;
  const cudaError_t err =
      smem_room(band_attention_bwd_tc_kernel<R, false>, &room);
  if (err == cudaSuccess) *max_nb = tc_max_nb<R>(room);
  return err;
}

// Rows per block of the fast form for nb table rows per axis (0 if no block
// takes them) and the most rows per axis that any of its blocks takes.
inline cudaError_t band_bwd_tc_rows(int nb, int* rows, int* max_nb) {
  int fit[kBandBwdShapes];
  cudaError_t err = band_bwd_tc_max_nb<64>(&fit[0]);
  if (err == cudaSuccess) err = band_bwd_tc_max_nb<32>(&fit[1]);
  if (err == cudaSuccess) err = band_bwd_tc_max_nb<16>(&fit[2]);
  if (err == cudaSuccess)
    bwd_pick_rows(nb, kBandBwdRows, fit, kBandBwdShapes, rows, max_nb);
  return err;
}

template <int R, bool kSwin>
cudaError_t band_bwd_tc_launch(const TcQueries& Q, const TcKeys& K,
                               const TcTables& T, const BwdOutputs& O, int n,
                               int h, int tile, int band, float scale,
                               cudaStream_t stream) {
  const size_t smem = TcSmem<R>(T.nb).bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      band_attention_bwd_tc_kernel<R, kSwin>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(n / R, h);
  band_attention_bwd_tc_kernel<R, kSwin><<<grid, kTcThreads, smem, stream>>>(
      Q, K, T, O, n, h, tile, band, scale);
  return cudaGetLastError();
}

template <bool kSwin>
cudaError_t band_bwd_tc_rows_launch(int rows, const TcQueries& Q,
                                    const TcKeys& K, const TcTables& T,
                                    const BwdOutputs& O, int n, int h,
                                    int tile, int band, float scale,
                                    cudaStream_t st) {
  switch (rows) {
    case 64:
      return band_bwd_tc_launch<64, kSwin>(Q, K, T, O, n, h, tile, band,
                                           scale, st);
    case 32:
      return band_bwd_tc_launch<32, kSwin>(Q, K, T, O, n, h, tile, band,
                                           scale, st);
    default:
      return band_bwd_tc_launch<16, kSwin>(Q, K, T, O, n, h, tile, band,
                                           scale, st);
  }
}

inline cudaError_t band_bwd_tc(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* g, const float* g32, const float* o, const float* m,
    const float* den, const float4* xyzv, const int32_t* seg_start,
    const int32_t* seg_end, const __nv_bfloat16* tq,
    const __nv_bfloat16* tk, const __nv_bfloat16* tv, float* dq,
    float* dk_part, float* dv_part, float* dt_part, int n, int h, int d,
    int tile, int band, int nb, int bin_lo, int nb_full, int swin,
    float bin_offset, float inv_quant, float scale, cudaStream_t st) {
  int rows = 0, max_nb = 0;
  const cudaError_t err = band_bwd_tc_rows(nb, &rows, &max_nb);
  if (err != cudaSuccess) return err;
  if (d != 16 || rows == 0 || tile <= 0 || tile % rows != 0 ||
      n % tile != 0 || nb < 0 ||
      (swin != 0 && (bin_lo != 0 || nb != nb_full)))
    return cudaErrorInvalidValue;
  const TcQueries Q{q, g, g32, o, m, den, xyzv, seg_start, seg_end, nullptr};
  const TcKeys K{k, v, xyzv, nullptr};
  const TcTables T{tq, tk, tv, nb, bin_lo, nb_full, bin_offset, inv_quant};
  const BwdOutputs O{dq, dk_part, dv_part, dt_part};
  return swin ? band_bwd_tc_rows_launch<true>(rows, Q, K, T, O, n, h, tile,
                                              band, scale, st)
              : band_bwd_tc_rows_launch<false>(rows, Q, K, T, O, n, h, tile,
                                               band, scale, st);
}

}  // namespace stratified

// C entry point, bound with ctypes. q is pre-scaled by d^-0.5; q/k/v/g/o
// are [N,H,D] fp32, m/den [N,H] (merged over both halves), xyz [N,3],
// seg bounds [N] int32, valid [N] bool; tables [H,3,nb,D] fp32 slices or
// null; swin as band_attention_fwd (xyz the quantized positions in the swin
// mode). q, k, v, g and the tables start on 16 bytes. With R the rows per
// block that band_attention_bwd_limits (the swin mode:
// band_attention_bwd_swin_limits) gives for nb, dk_part/dv_part ([N / R]
// [tile + 2*band][H][D]) must be zeroed by the caller; dt_part is [N / R]
// [H][3][3][nb][D]. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head size other than 16, a tile that is not
// a multiple of R, more table rows per axis than any block takes, or a
// misaligned array).
extern "C" int band_attention_bwd(
    const float* q, const float* k, const float* v, const float* xyz,
    const int32_t* seg_start, const int32_t* seg_end, const uint8_t* valid,
    const float* g, const float* o, const float* m, const float* den,
    const float* tq, const float* tk, const float* tv, float* dq,
    float* dk_part, float* dv_part, float* dt_part, int n, int h, int d,
    int tile, int band, int nb, int bin_lo, int nb_full, int swin,
    float bin_offset, float inv_quant, float scale, void* stream) {
  return static_cast<int>(stratified::band_bwd(
      q, k, v, xyz, seg_start, seg_end, valid, g, o, m, den, tq, tk, tv, dq,
      dk_part, dv_part, dt_part, n, h, d, tile, band, nb, bin_lo, nb_full,
      swin, bin_offset, inv_quant, scale, static_cast<cudaStream_t>(stream)));
}

// The fast (bf16) form (attention_bwd_tc.cuh): q (pre-scaled in fp32, then
// rounded), k, v, g and the table slices bf16, rounded to nearest even by
// the caller; g32 the fp32 g (for g·o); xyzv [N] float4 (x, y, z, valid as
// 1 or 0) in place of xyz and valid. The other arguments and the outputs as
// band_attention_bwd, with R the rows per block that
// band_attention_bwd_bf16_limits gives for nb.
extern "C" int band_attention_bwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* g, const float* g32, const float* o, const float* m,
    const float* den, const float4* xyzv, const int32_t* seg_start,
    const int32_t* seg_end, const __nv_bfloat16* tq,
    const __nv_bfloat16* tk, const __nv_bfloat16* tv, float* dq,
    float* dk_part, float* dv_part, float* dt_part, int n, int h, int d,
    int tile, int band, int nb, int bin_lo, int nb_full, int swin,
    float bin_offset, float inv_quant, float scale, void* stream) {
  return static_cast<int>(stratified::band_bwd_tc(
      q, k, v, g, g32, o, m, den, xyzv, seg_start, seg_end, tq, tk, tv, dq,
      dk_part, dv_part, dt_part, n, h, d, tile, band, nb, bin_lo, nb_full,
      swin, bin_offset, inv_quant, scale, static_cast<cudaStream_t>(stream)));
}

// The rows per block that band_attention_bwd takes for nb table rows per
// axis in the stratified bins (0 if none), and the most table rows per axis
// that any of its blocks fits in the current device's shared memory: on the
// H100, 64 rows up to 44 (the band slice of S3DIS's 64-bin tables has 40),
// 32 rows up to 64 (of ScanNet's 80-bin tables 48), 16 rows up to 112.
// Returns a cudaError_t.
extern "C" int band_attention_bwd_limits(int nb, int* rows, int* max_nb) {
  return static_cast<int>(stratified::band_bwd_rows<false>(nb, rows, max_nb));
}

// The same for the swin mode (swin 1): on the H100, 32 rows up to 32 table
// rows per axis (Swin3D's 31), two blocks per SM; 64 rows up to 44; 16
// rows up to 112.
extern "C" int band_attention_bwd_swin_limits(int nb, int* rows,
                                              int* max_nb) {
  return static_cast<int>(stratified::band_bwd_rows<true>(nb, rows, max_nb));
}

// The blocks of band_attention_bwd's launch for nb table rows per axis
// (swin as band_attention_bwd) that one SM of the current device holds at
// once: on the H100, 1 in the stratified bins, 2 in the swin mode up to 32
// rows per axis. Returns a cudaError_t.
extern "C" int band_attention_bwd_occupancy(int nb, int swin, int* blocks) {
  return static_cast<int>(swin ? stratified::band_bwd_blocks<true>(nb, blocks)
                               : stratified::band_bwd_blocks<false>(nb,
                                                                    blocks));
}

// The same for the fast form: on the H100, 64 rows up to 48 (S3DIS's band
// slice of 40, ScanNet's 48, Swin3D's 31-row tables), 32 rows up to 91, 16
// rows up to 128.
extern "C" int band_attention_bwd_bf16_limits(int nb, int* rows,
                                              int* max_nb) {
  return static_cast<int>(stratified::band_bwd_tc_rows(nb, rows, max_nb));
}
