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
// from its own, both ends valid. Bins span the full table. The block runs
// attention_bwd_block (attention_bwd_common.cuh: formulas, and how sums are
// ordered) over the window. Outputs: dq in lw order (times scale); dk and
// dv per slot of the tile's window, [tiles][s_band][H][D]; the table grads
// per (tile, head). The wrapper un-permutes dq, scatter-adds the windows
// into aux slots and then into points through sb_src (plain PyTorch, as
// they sit outside the pallas_call in the JAX package), and sums the table
// partials over tiles.
//
// What bounds it on the H100: as the band backward, ~450 fp32 operations
// per unmasked pair and head plus the table grads' serial walk (phase C),
// against reading q, g, o, m, den and the aux k/v once and writing dq, the
// windows and the table grads. A tile's far keys span a few dozen aux
// slots, so the bytes are a large share of the bound; chip_smoke.py
// computes it from the run's data. wgmma tiles, TMA staging and a bf16 mode
// are left for later work.

#include "attention_bwd_common.cuh"

namespace stratified {

template <int D>
__global__ void sparse_band_attention_bwd_kernel(BwdQueries Q, BwdKeys K,
                                                 BwdTables T, BwdOutputs O,
                                                 int n, int a_sz, int h,
                                                 int s_band, float scale) {
  const int t0 = blockIdx.x * blockDim.x;
  const int base = (min(Q.key_lo[t0], a_sz - s_band) / 16) * 16;
  attention_bwd_block<D>(Q, K, T, O, n, h, blockIdx.x, base, base + s_band,
                         base, s_band, scale);
}

}  // namespace stratified

// C entry point, bound with ctypes. Query arrays are in lw order (q_lw
// pre-scaled, g/o [N,H,D], m/den [N,H] merged over both halves); aux arrays
// have A rows (k_aux/v_aux [A,H,D], zero in empty slots); s_band <= A; the
// tables are [H,3,nb,D] fp32 or null. dk_part/dv_part must be zeroed by the
// caller. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head size other than 16, a tile that is not
// a multiple of 32, or more than 256 table rows).
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
  // Every stage of the ported configurations has D = 16; instantiate more
  // head sizes when a configuration needs them.
  if (d != 16 || tile % 32 != 0 || tile <= 0 || tile > 1024 || nb > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdQueries Q{q_lw, g_lw, o_lw, m_lw, den_lw, xyz_lw, valid_lw,
                     sb_start, sb_end, skey_lw};
  const BwdKeys K{k_aux, v_aux, xyz_aux, valid_aux, skey_aux};
  const BwdTables T{tq, tk, tv, nb, 0, nb, bin_offset, inv_quant};
  const BwdOutputs O{dq_lw, dk_part, dv_part, dt_part};
  const size_t smem = bwd_smem_bytes<16>(nb, tile);
  cudaError_t err = cudaFuncSetAttribute(
      sparse_band_attention_bwd_kernel<16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n / tile, h);
  sparse_band_attention_bwd_kernel<16><<<grid, tile, smem,
                                         static_cast<cudaStream_t>(stream)>>>(
      Q, K, T, O, n, a_sz, h, s_band, scale);
  return static_cast<int>(cudaGetLastError());
}
