// Far-key (stratified sparse) half of stratified attention, forward.
//
// Replaces the Pallas TPU kernel _sparse_kernel of
// stratified_transformer_tpu/ops/pallas/fused_attention.py (wrapper
// sparse_band_attention). Plain PyTorch version: sparse_band_attention_plain
// in stratified_transformer_torch/ops/attention.py.
//
// Queries run in large-window (lw) order: row r is point lw_map[r] of the
// small-window-sorted order, whose q it reads (scaled in the kernel) and to
// whose row it writes its triple, so the output is in small-window order.
// Keys are the downsampled members compacted into aux slots sorted by
// large-window key (ops/plan.py::SparseBandLayout): slot p reads k/v row
// sb_src[p] where sb_valid[p]. Query tile t (128 rows) reads the s_band aux
// slots from base = (min(sb_start[t * tile], A - s_band) / 16) * 16; row r
// attends to slots [sb_start[r], sb_end[r]) of that window whose
// small-window key differs from its own, both ends valid. Bins span the
// full ±2·window range (no table slice). A row with no key gets m = -1e30,
// den = 0, acc = 0. The gathers into lw and aux order and the un-permute,
// which sit outside the pallas_call in the JAX package, are the kernel's
// own reads and writes: the wrapper allocates the outputs and launches.
//
// What bounds it on the H100: reading q, k and v, the plan's indices and
// the tables once and writing the triple once, against the fp32 work of
// the unmasked pairs (q·k, p·v and the softmax, ~24 operations for the
// bins, and the table terms). A row has at most sparse_cap far keys (48
// for S3DIS), fewer than the ~nb rows per axis (64) beyond which projecting
// it onto the 3·nb table rows costs fewer FMA than three d-long dot
// products per pair, so the fp32 form takes the per-pair form
// (chip_smoke.py::least_ops picks the cheaper form per table, and counts
// each key's projection once per call). That count is of FMA on the CUDA
// cores: on the tensor cores a projection is one mma per 16 rows and 8
// table rows, and the fast form takes the projection form, as the TPU
// kernel does in this half too (fused_attention.py:340-347, 392-397). At
// the S3DIS point the bytes set the bound at most stages.
// The design (attention_fwd_common.cuh): one block of 256 threads per
// (64-row slice of a tile, head), two blocks per SM, four lanes per row
// taking whole pairs, one softmax rescale per chunk of 32 keys; the head's
// three full tables are staged once per block, a thread per (table, bin)
// with its twelve float4 reads of the model's layout in flight together;
// the block visits only the union of its rows' segments in the s_band
// window. Tensor cores and TMA staging are left for later work.
// The fast form (sparse_band_attention_fwd_bf16) is the TPU kernel's
// fast=True: the TPU kernel stages fp32 (fused_attention.py:494-499) and
// rounds the operands of its DEFAULT products to bf16, which this form
// stages in bf16 (q after the scaling, k and v through sb_src, the head's
// tables), with p rounded for p·v and Tv taken as the TPU kernel takes it:
// per row and (axis, bin) the fp32 mass of p, rounded once for mass·Tv
// (fused_attention.py:451-456). It runs attention_fwd_block_tc
// (attention_fwd_tc.cuh: every bf16 product on mma.sync, the projection
// form, the next key chunk loaded while one computes, the masses added in
// key order) in 64-row blocks; at the far keys' full tables (64 rows per
// axis for S3DIS, 80 for ScanNet) a block's per-row projections and masses
// take 144-177 KB of shared memory, one block per SM.

#include "attention_fwd_common.cuh"
#include "attention_fwd_tc.cuh"

namespace stratified {

constexpr int kSparseRows = 64;   // rows per block: 2 slices of a tile

template <int D, int R>
__global__ void __launch_bounds__(kFwdThreads, 2)
sparse_band_attention_kernel(FwdQueries Q, FwdKeys K, FwdTables T,
                             FwdOutputs O, int a_sz, int h, int tile,
                             int s_band, float scale) {
  const int slices = tile / R;
  const int tile_idx = blockIdx.x / slices;
  const int t0 = tile_idx * tile;
  const int base = (min(Q.key_lo[t0], a_sz - s_band) / 16) * 16;
  attention_fwd_block<D, R, false>(
      Q, K, T, O, h, t0 + (blockIdx.x - tile_idx * slices) * R, base,
      base + s_band, scale);
}

inline cudaError_t sparse_fwd_limits(int* rows, int* max_nb) {
  size_t room = 0;
  const cudaError_t err =
      smem_room(sparse_band_attention_kernel<16, kSparseRows>, &room);
  if (err != cudaSuccess) return err;
  *rows = kSparseRows;
  *max_nb = fwd_max_nb<kSparseRows, false>(room);
  return cudaSuccess;
}

inline cudaError_t sparse_fwd(
    const float* q, const float* k, const float* v, const int32_t* lw_map,
    const float* xyz_lw, const uint8_t* valid_lw, const int32_t* skey_lw,
    const int32_t* sb_start, const int32_t* sb_end, const int32_t* sb_src,
    const float* sb_xyz, const uint8_t* sb_valid, const int32_t* sb_skey,
    const float* tq, const float* tk, const float* tv, float* acc, float* m,
    float* den, int n, int a_sz, int h, int d, int q_rs, int k_rs, int v_rs,
    int tile, int s_band, int nb, float bin_offset, float inv_quant,
    float scale, cudaStream_t stream) {
  constexpr int R = kSparseRows;
  int rows = 0, max_nb = 0;
  cudaError_t err = sparse_fwd_limits(&rows, &max_nb);
  if (err != cudaSuccess) return err;
  // Every stage of the ported configurations has D = 16; instantiate more
  // head sizes when a configuration needs them.
  if (d != 16 || tile <= 0 || tile % R != 0 || n % tile != 0 || nb < 0 ||
      nb > max_nb || s_band <= 0 || s_band > a_sz)
    return cudaErrorInvalidValue;
  const FwdQueries Q{q, q_rs, lw_map, xyz_lw, valid_lw, sb_start, sb_end,
                     skey_lw};
  const FwdKeys K{k, k_rs, v, v_rs, sb_src, sb_xyz, sb_valid, sb_skey};
  const FwdTables T{tq, tk, tv, nb, 0, nb, bin_offset, inv_quant};
  const FwdOutputs O{acc, m, den};
  const size_t smem = FwdSmem<R, false>(nb).bytes();
  err = cudaFuncSetAttribute(sparse_band_attention_kernel<16, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(n / R, h);
  sparse_band_attention_kernel<16, R><<<grid, kFwdThreads, smem, stream>>>(
      Q, K, T, O, a_sz, h, tile, s_band, scale);
  return cudaGetLastError();
}

// ---- the fast form: attention_fwd_block_tc (attention_fwd_tc.cuh) -------

__global__ void __launch_bounds__(kFtThreads, 2)
sparse_band_attention_tc_kernel(FwdQueries Q, FwdKeys K, FwdTables T,
                                FwdOutputs O, int a_sz, int h, int tile,
                                int s_band, float scale) {
  const int slices = tile / kFtRows;
  const int tile_idx = blockIdx.x / slices;
  const int t0 = tile_idx * tile;
  const int base = (min(Q.key_lo[t0], a_sz - s_band) / 16) * 16;
  attention_fwd_block_tc<false>(
      Q, K, T, O, h, t0 + (blockIdx.x - tile_idx * slices) * kFtRows, base,
      base + s_band, scale);
}

inline cudaError_t sparse_fwd_tc_limits(int* rows, int* max_nb) {
  size_t room = 0;
  const cudaError_t err = smem_room(sparse_band_attention_tc_kernel, &room);
  if (err != cudaSuccess) return err;
  *rows = kFtRows;
  *max_nb = ft_max_nb(room);
  return cudaSuccess;
}

inline cudaError_t sparse_fwd_tc(
    const float* q, const float* k, const float* v, const int32_t* lw_map,
    const float* xyz_lw, const uint8_t* valid_lw, const int32_t* skey_lw,
    const int32_t* sb_start, const int32_t* sb_end, const int32_t* sb_src,
    const float* sb_xyz, const uint8_t* sb_valid, const int32_t* sb_skey,
    const float* tq, const float* tk, const float* tv, float* acc, float* m,
    float* den, int n, int a_sz, int h, int d, int q_rs, int k_rs, int v_rs,
    int tile, int s_band, int nb, float bin_offset, float inv_quant,
    float scale, cudaStream_t stream) {
  int rows = 0, max_nb = 0;
  cudaError_t err = sparse_fwd_tc_limits(&rows, &max_nb);
  if (err != cudaSuccess) return err;
  // q, k and v are read a float4 at a time
  if (d != 16 || tile <= 0 || tile % rows != 0 || n % tile != 0 || nb < 0 ||
      nb > max_nb || s_band <= 0 || s_band > a_sz || !rows16(q, q_rs) ||
      !rows16(k, k_rs) || !rows16(v, v_rs))
    return cudaErrorInvalidValue;
  const FwdQueries Q{q, q_rs, lw_map, xyz_lw, valid_lw, sb_start, sb_end,
                     skey_lw};
  const FwdKeys K{k, k_rs, v, v_rs, sb_src, sb_xyz, sb_valid, sb_skey};
  const FwdTables T{tq, tk, tv, nb, 0, nb, bin_offset, inv_quant};
  const FwdOutputs O{acc, m, den};
  const size_t smem = FtSmem(nb).bytes();
  err = cudaFuncSetAttribute(sparse_band_attention_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(n / kFtRows, h);
  sparse_band_attention_tc_kernel<<<grid, kFtThreads, smem, stream>>>(
      Q, K, T, O, a_sz, h, tile, s_band, scale);
  return cudaGetLastError();
}

}  // namespace stratified

// C entry point, bound with ctypes. q/k/v are [N,H,D] fp32 in
// small-window-sorted order, rows of q_rs / k_rs / v_rs floats (head stride
// D, channel stride 1); q is scaled by `scale` in the kernel. The plan's
// fields: lw_map [N] int32, xyz_lw [N,3], valid_lw [N] bool, skey_lw,
// sb_start, sb_end [N] int32 in lw order; sb_src [A] int32 (-1 in empty
// slots), sb_xyz [A,3], sb_valid [A] bool, sb_skey [A] int32; s_band <= A
// is the aux window per tile; the tables are the model's [nb][H][D][3] fp32
// or null. acc [N,H,D], m, den [N,H] come out in small-window order.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head size other than 16, a tile that is not a multiple of 64, or more
// table rows per axis than sparse_band_attention_limits gives).
extern "C" int sparse_band_attention_fwd(
    const float* q, const float* k, const float* v, const int32_t* lw_map,
    const float* xyz_lw, const uint8_t* valid_lw, const int32_t* skey_lw,
    const int32_t* sb_start, const int32_t* sb_end, const int32_t* sb_src,
    const float* sb_xyz, const uint8_t* sb_valid, const int32_t* sb_skey,
    const float* tq, const float* tk, const float* tv, float* acc, float* m,
    float* den, int n, int a_sz, int h, int d, int q_rs, int k_rs, int v_rs,
    int tile, int s_band, int nb, float bin_offset, float inv_quant,
    float scale, void* stream) {
  return static_cast<int>(stratified::sparse_fwd(
      q, k, v, lw_map, xyz_lw, valid_lw, skey_lw, sb_start, sb_end, sb_src,
      sb_xyz, sb_valid, sb_skey, tq, tk, tv, acc, m, den, n, a_sz, h, d,
      q_rs, k_rs, v_rs, tile, s_band, nb, bin_offset, inv_quant, scale,
      static_cast<cudaStream_t>(stream)));
}

// The fast (bf16) form (attention_fwd_tc.cuh): the same arguments and
// outputs as sparse_band_attention_fwd, with q, k and v at 16-byte aligned
// rows (row strides a multiple of 4 floats);
// sparse_band_attention_bf16_limits gives its limits.
extern "C" int sparse_band_attention_fwd_bf16(
    const float* q, const float* k, const float* v, const int32_t* lw_map,
    const float* xyz_lw, const uint8_t* valid_lw, const int32_t* skey_lw,
    const int32_t* sb_start, const int32_t* sb_end, const int32_t* sb_src,
    const float* sb_xyz, const uint8_t* sb_valid, const int32_t* sb_skey,
    const float* tq, const float* tk, const float* tv, float* acc, float* m,
    float* den, int n, int a_sz, int h, int d, int q_rs, int k_rs, int v_rs,
    int tile, int s_band, int nb, float bin_offset, float inv_quant,
    float scale, void* stream) {
  return static_cast<int>(stratified::sparse_fwd_tc(
      q, k, v, lw_map, xyz_lw, valid_lw, skey_lw, sb_start, sb_end, sb_src,
      sb_xyz, sb_valid, sb_skey, tq, tk, tv, acc, m, den, n, a_sz, h, d,
      q_rs, k_rs, v_rs, tile, s_band, nb, bin_offset, inv_quant, scale,
      static_cast<cudaStream_t>(stream)));
}

// Rows per block, and the most table rows per axis that the entry point
// takes on the current device (kFwdMaxNb = 256 on the H100, where the
// block's shared memory would fit 307; S3DIS's tables have 64, ScanNet's
// 80). Returns a cudaError_t.
extern "C" int sparse_band_attention_limits(int* rows, int* max_nb) {
  return static_cast<int>(stratified::sparse_fwd_limits(rows, max_nb));
}

// The same for the fast form: 64 rows, and on the H100 up to 101 table
// rows per axis.
extern "C" int sparse_band_attention_bf16_limits(int* rows, int* max_nb) {
  return static_cast<int>(stratified::sparse_fwd_tc_limits(rows, max_nb));
}
