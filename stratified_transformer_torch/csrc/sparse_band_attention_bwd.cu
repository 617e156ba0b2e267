// Far-key (stratified sparse) half of stratified attention, backward.
//
// Replaces the Pallas TPU kernel _sparse_bwd_kernel of
// stratified_transformer_tpu/ops/pallas/fused_attention_bwd.py (wrapper
// sparse_band_attention_bwd). Plain PyTorch version:
// sparse_band_attention_bwd_plain in
// stratified_transformer_torch/ops/attention.py.
//
// Queries in large-window (lw) order, keys in aux order, as the forward
// kernel takes them. Tile t reads the s_band aux slots from
// base = (min(sb_start[t * tile], A - s_band) / 16) * 16; a row attends to
// slots [sb_start, sb_end) of that window whose small-window key differs
// from its own, both ends valid. Bins span the full table (nb = 64 in the
// S3DIS configuration, 80 in ScanNet's), so a block takes 32 rows of the
// tile, or 16 for tables over 64 rows, which keeps its per-row masses and
// projections within shared memory. The block runs
// attention_bwd_block (attention_bwd_common.cuh: formulas, the projection
// form, and how sums are ordered) over the window. Outputs: dq in lw order
// (times scale); dk and dv per slot of the tile's window, [tiles * slices]
// [s_band][H][D]; the table grads per (tile, slice, head). The wrapper
// un-permutes dq, adds the slices, scatter-adds the windows into aux slots
// and then into points through sb_src (plain PyTorch, as they sit outside
// the pallas_call in the JAX package), and sums the table partials.
//
// What bounds it on the H100: as the band backward, the fp32 work of the
// unmasked pairs and the table projections and masses, against reading q,
// g, o, m, den and the aux k/v once and writing dq, the windows and the
// table grads. A tile's far keys span a few dozen aux slots, so the bytes
// are a large share of the bound; chip_smoke.py computes it from the run's
// data. Tensor cores, TMA staging and a bf16 mode are left for later work.

#include "attention_bwd_common.cuh"

namespace stratified {

// Block heights the launcher offers, in order of preference: 32 rows (4
// slices of a tile) for up to 64 table rows per axis (S3DIS's tables), 16
// rows beyond that (ScanNet's 80).
constexpr int kSparseBwdRows[] = {32, 16};
constexpr int kSparseBwdShapes = 2;

template <int D, int R>
__global__ void __launch_bounds__(kBwdThreads, 1)
sparse_band_attention_bwd_kernel(BwdQueries Q, BwdKeys K, BwdTables T,
                                 BwdOutputs O, int a_sz, int h, int tile,
                                 int s_band, float scale) {
  const int slices = tile / R;
  const int tile_idx = blockIdx.x / slices;
  const int t0 = tile_idx * tile;
  const int base = (min(Q.key_lo[t0], a_sz - s_band) / 16) * 16;
  attention_bwd_block<D, R>(Q, K, T, O, h, blockIdx.x,
                            t0 + (blockIdx.x - tile_idx * slices) * R, base,
                            base + s_band, base, s_band, scale);
}

template <int R>
cudaError_t sparse_bwd_max_nb(int* max_nb) {
  size_t room = 0;
  const cudaError_t err =
      smem_room(sparse_band_attention_bwd_kernel<16, R>, &room);
  if (err == cudaSuccess) *max_nb = bwd_max_nb<16, R>(room);
  return err;
}

// Rows per block for nb table rows per axis (0 if no block takes them) and
// the most rows per axis that any block takes on the current device.
inline cudaError_t sparse_bwd_rows(int nb, int* rows, int* max_nb) {
  int fit[kSparseBwdShapes];
  cudaError_t err = sparse_bwd_max_nb<32>(&fit[0]);
  if (err == cudaSuccess) err = sparse_bwd_max_nb<16>(&fit[1]);
  if (err == cudaSuccess)
    bwd_pick_rows(nb, kSparseBwdRows, fit, kSparseBwdShapes, rows, max_nb);
  return err;
}

template <int R>
cudaError_t sparse_bwd_launch(const BwdQueries& Q, const BwdKeys& K,
                              const BwdTables& T, const BwdOutputs& O,
                              int n, int a_sz, int h, int tile, int s_band,
                              float scale, cudaStream_t stream) {
  const size_t smem = BwdSmem<16, R>(T.nb).bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      sparse_band_attention_bwd_kernel<16, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(n / R, h);
  sparse_band_attention_bwd_kernel<16, R><<<grid, kBwdThreads, smem,
                                            stream>>>(
      Q, K, T, O, a_sz, h, tile, s_band, scale);
  return cudaGetLastError();
}

}  // namespace stratified

// C entry point, bound with ctypes. Query arrays are in lw order (q_lw
// pre-scaled, g/o [N,H,D], m/den [N,H] merged over both halves); aux arrays
// have A rows (k_aux/v_aux [A,H,D], zero in empty slots); s_band <= A; the
// tables are [H,3,nb,D] fp32 or null. With R the rows per block that
// sparse_band_attention_bwd_limits gives for nb, dk_part/dv_part ([N / R]
// [s_band][H][D]) must be zeroed by the caller; dt_part is [N / R][H][3][3]
// [nb][D]. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head size other than 16, a tile that is not
// a multiple of R, or more table rows per axis than any block takes).
extern "C" int sparse_band_attention_bwd(
    const float* q_lw, const float* g_lw, const float* o_lw,
    const float* m_lw, const float* den_lw, const float* xyz_lw,
    const uint8_t* valid_lw, const int32_t* skey_lw, const int32_t* sb_start,
    const int32_t* sb_end, const float* k_aux, const float* v_aux,
    const float* xyz_aux, const uint8_t* valid_aux, const int32_t* skey_aux,
    const float* tq, const float* tk, const float* tv, float* dq_lw,
    float* dk_part, float* dv_part, float* dt_part, int n, int a_sz, int h,
    int d, int tile, int s_band, int nb, float bin_offset, float inv_quant,
    float scale, void* stream) {
  using namespace stratified;
  int rows = 0, max_nb = 0;
  const cudaError_t err = sparse_bwd_rows(nb, &rows, &max_nb);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Every stage of the ported configurations has D = 16; instantiate more
  // head sizes when a configuration needs them.
  if (d != 16 || rows == 0 || tile <= 0 || tile % rows != 0 ||
      n % tile != 0 || nb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdQueries Q{q_lw, g_lw, o_lw, m_lw, den_lw, xyz_lw, valid_lw,
                     sb_start, sb_end, skey_lw};
  const BwdKeys K{k_aux, v_aux, xyz_aux, valid_aux, skey_aux};
  const BwdTables T{tq, tk, tv, nb, 0, nb, bin_offset, inv_quant};
  const BwdOutputs O{dq_lw, dk_part, dv_part, dt_part};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 32)
    return static_cast<int>(sparse_bwd_launch<32>(
        Q, K, T, O, n, a_sz, h, tile, s_band, scale, st));
  return static_cast<int>(sparse_bwd_launch<16>(
      Q, K, T, O, n, a_sz, h, tile, s_band, scale, st));
}

// The rows per block that sparse_band_attention_bwd takes for nb table rows
// per axis (0 if none), and the most table rows per axis that any of its
// blocks takes on the current device: on the H100, 32 rows up to 64 (the
// cap of that block; S3DIS's tables have 64), 16 rows up to 116 (ScanNet's
// 80). Returns a cudaError_t.
extern "C" int sparse_band_attention_bwd_limits(int nb, int* rows,
                                                int* max_nb) {
  return static_cast<int>(stratified::sparse_bwd_rows(nb, rows, max_nb));
}
