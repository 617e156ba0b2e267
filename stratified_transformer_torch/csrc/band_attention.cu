// Dense (same-window) half of stratified attention, forward.
//
// Replaces the Pallas TPU kernel _band_kernel of
// stratified_transformer_tpu/ops/pallas/fused_attention.py (wrapper
// band_attention). Plain PyTorch version: band_attention_plain in
// stratified_transformer_torch/ops/attention.py.
//
// Every query row t attends to keys [t0 - band, t0 + tile + band) ∩
// [seg_start[t], seg_end[t]), both ends valid, with t0 = (t / tile) * tile.
// The logit adds the cRPE biases q·Tq[bin] and k·Tk[bin] over the 3 axes;
// the value adds Tv[bin]. Band pairs only reach table rows [bin_lo, bin_lo +
// nb), which the kernel reads from the model's [nb_full][H][D][3] tables.
// Output: the unnormalised online-softmax triple (acc [N,H,D], m [N,H], den
// [N,H]); a row with no key gets m = -1e30, den = 0, acc = 0.
//
// What bounds it on the H100: the fp32 work of the unmasked pairs, q·k, p·v
// and the softmax (~4d + 5 operations per pair and head) and ~24 for the
// bins, plus the table terms in the projection form (each query, key and
// row's bin mass projected once onto the 3·nb table rows, 6·nb·d operations
// each, then 3 lookups per pair and table), against reading q, k, v and
// writing acc once. chip_smoke.py::least_ops counts those operations from
// the run's data; the bound is the larger of them over 67 TFLOP/s (CUDA
// cores, fp32) and the bytes over 3.35 TB/s: operations at S3DIS's stages
// 1-3 (~150 keys per query at stage 2), bytes at stage 0.
// The design (attention_fwd_common.cuh): one block of 256 threads per
// (64-row slice of a tile, head); the projection form, so that a pair costs
// a 16-long dot product, six lookups, an exp and a 16-long axpy; Tv through
// per-row bin masses walked in a fixed order (no atomics); whole pairs per
// lane, four lanes per row, so a warp no longer waits on its longest row;
// one softmax rescale per chunk of 32 keys instead of one per key. Keys
// outside the union of the slice's segments are never staged. Bins are
// computed per head (a block of several heads would need their per-row
// projections and masses at once, more shared memory than a block has).
// The fp32 form's products stay on fp32 FMA; TMA staging is left for later
// work.
// The fast form (band_attention_fwd_bf16) is the TPU kernel's fast=True
// (fused_attention.py:646-668, 86): q (rounded after the fp32 scaling), k,
// v and the table entries in bf16, p rounded for p·v and the bin masses
// for mass·Tv, everything else fp32. What bounds it on the H100 is bytes
// (PERF.md: 0.049 ms per S3DIS step, 0.255 per ScanNet step, with the
// products at the bf16 tensor-core peak). It runs attention_fwd_block_tc
// (attention_fwd_tc.cuh): q·kᵀ, p·v, the projections and mass·Tv on
// mma.sync from bf16 operands it stages itself (the same arguments as the
// fp32 form), the next key chunk loaded while one computes, a warp per 8
// rows over the whole window, the bin masses added in key order; 64-row
// blocks, two per SM up to ScanNet's band slice of 48 table rows per axis
// (band_attention_bf16_limits).
// The swin mode (swin 1; Swin3D, rpe_mode "swin_window") takes Swin3D's
// bins (swin_bin, attention_common.cuh): xyz holds the points'
// window-quantized positions, the bin is round(u_i - u_j) + qgl - 1 over the
// whole table of 2 qgl - 1 rows (31 at every stage of the shipped Swin
// YAMLs), no slice. The TPU kernel has no such mode: the JAX package runs
// Swin3D on its jnp path (ops/attention.py:400-560), whose function this
// computes. Its fp32 form runs a routine of its own
// (attention_fwd_swin.cuh: the table terms per pair, cp.async key chunks;
// 64-row blocks, two per SM; band_attention_swin_limits); its fast form is
// attention_fwd_block_tc's kSwin mode.

#include "attention_fwd_common.cuh"
#include "attention_fwd_swin.cuh"
#include "attention_fwd_tc.cuh"

namespace stratified {

constexpr int kBandRows = 64;   // rows per block: 2 slices of a tile
constexpr int kSwinRows = 64;   // the swin mode's rows per block

// kSwin: the swin mode's routine (attention_fwd_swin.cuh), else the
// projection form of attention_fwd_block; both run 256 threads a block.
template <int D, int R, bool kSwin>
__global__ void __launch_bounds__(kFwdThreads, 2)
band_attention_kernel(FwdQueries Q, FwdKeys K, FwdTables T, FwdOutputs O,
                      int n, int h, int tile, int band, float scale) {
  static_assert(kFwdThreads == kSwinThreads, "one block size");
  const int slices = tile / R;
  const int tile_idx = blockIdx.x / slices;
  const int t0 = tile_idx * tile;
  const int row0 = t0 + (blockIdx.x - tile_idx * slices) * R;
  const int win_lo = max(t0 - band, 0), win_hi = min(t0 + tile + band, n);
  if constexpr (kSwin)
    attention_fwd_swin<D, R>(Q, K, T, O, h, row0, win_lo, win_hi, scale);
  else
    attention_fwd_block<D, R, true>(Q, K, T, O, h, row0, win_lo, win_hi,
                                    scale);
}

__global__ void rel_bin_probe_kernel(const float* __restrict__ rel,
                                     int32_t* __restrict__ out, int n,
                                     float bin_offset, float inv_quant,
                                     int nb_full, int bin_lo, int nb,
                                     int swin) {
  const FwdTables T{nullptr, nullptr, nullptr, nb, bin_lo,
                    nb_full, bin_offset, inv_quant};
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    out[i] = swin ? table_bin<true>(T, rel[i]) : table_bin<false>(T, rel[i]);
}

inline cudaError_t band_fwd_limits(int* rows, int* max_nb) {
  size_t room = 0;
  const cudaError_t err =
      smem_room(band_attention_kernel<16, kBandRows, false>, &room);
  if (err != cudaSuccess) return err;
  *rows = kBandRows;
  *max_nb = fwd_max_nb<kBandRows, true>(room);
  return cudaSuccess;
}

inline cudaError_t band_fwd_swin_limits(int* rows, int* max_nb) {
  size_t room = 0;
  const cudaError_t err =
      smem_room(band_attention_kernel<16, kSwinRows, true>, &room);
  if (err != cudaSuccess) return err;
  *rows = kSwinRows;
  *max_nb = swin_max_nb<kSwinRows>(room);
  return cudaSuccess;
}

// The fp32 kernel of the stratified bins, or (kSwin) of the swin mode, its
// rows per block and its dynamic shared memory for nb table rows per axis.
template <bool kSwin>
struct BandFwd {
  static constexpr int rows = kSwin ? kSwinRows : kBandRows;
  static auto kernel() { return band_attention_kernel<16, rows, kSwin>; }
  static size_t smem(int nb) {
    return kSwin ? SwinSmem<kSwinRows>(nb).bytes()
                 : FwdSmem<kBandRows, true>(nb).bytes();
  }
  // the swin mode: all of the SM's unified memory as shared memory, so
  // that two blocks fit side by side (the stratified form reads its tables
  // through the L1 cache)
  static cudaError_t attributes(size_t bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err == cudaSuccess && kSwin)
      err = cudaFuncSetAttribute(
          kernel(), cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    return err;
  }
};

template <bool kSwin>
cudaError_t band_fwd_launch(const FwdQueries& Q, const FwdKeys& K,
                            const FwdTables& T, const FwdOutputs& O, int n,
                            int h, int tile, int band, float scale,
                            cudaStream_t stream) {
  using F = BandFwd<kSwin>;
  const size_t smem = F::smem(T.nb);
  const cudaError_t err = F::attributes(smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n / F::rows, h);
  band_attention_kernel<16, F::rows, kSwin>
      <<<grid, kFwdThreads, smem, stream>>>(Q, K, T, O, n, h, tile, band,
                                            scale);
  return cudaGetLastError();
}

// Blocks of the fp32 launch (kSwin: the swin mode's) for nb table rows per
// axis that one SM of the current device holds at once.
template <bool kSwin>
cudaError_t band_fwd_blocks(int nb, int* blocks) {
  using F = BandFwd<kSwin>;
  const size_t smem = F::smem(nb);
  cudaError_t err = F::attributes(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, F::kernel(),
                                                        kFwdThreads, smem);
  return err;
}

inline cudaError_t band_fwd(const float* q, const float* k, const float* v,
                            const float* xyz, const int32_t* seg_start,
                            const int32_t* seg_end, const uint8_t* valid,
                            const float* tq, const float* tk,
                            const float* tv, float* acc, float* m, float* den,
                            int n, int h, int d, int q_rs, int k_rs, int v_rs,
                            int tile, int band, int nb, int bin_lo,
                            int nb_full, int swin, float bin_offset,
                            float inv_quant, float scale,
                            cudaStream_t stream) {
  int rows = 0, max_nb = 0;
  cudaError_t err = swin ? band_fwd_swin_limits(&rows, &max_nb)
                         : band_fwd_limits(&rows, &max_nb);
  if (err != cudaSuccess) return err;
  // Every stage of the ported configurations has D = 16; instantiate more
  // head sizes when a configuration needs them. The swin mode reads the
  // whole table, no slice, and copies rows of q, k and v 16 bytes at a time.
  if (d != 16 || tile <= 0 || tile % rows != 0 || n % tile != 0 || nb < 0 ||
      nb > max_nb ||
      (swin != 0 && (bin_lo != 0 || nb != nb_full || !rows16(q, q_rs) ||
                     !rows16(k, k_rs) || !rows16(v, v_rs))))
    return cudaErrorInvalidValue;
  const FwdQueries Q{q, q_rs, nullptr, xyz, valid, seg_start, seg_end,
                     nullptr};
  const FwdKeys K{k, k_rs, v, v_rs, nullptr, xyz, valid, nullptr};
  const FwdTables T{tq, tk, tv, nb, bin_lo, nb_full, bin_offset, inv_quant};
  const FwdOutputs O{acc, m, den};
  return swin ? band_fwd_launch<true>(Q, K, T, O, n, h, tile, band, scale,
                                      stream)
              : band_fwd_launch<false>(Q, K, T, O, n, h, tile, band, scale,
                                       stream);
}

// ---- the fast form: attention_fwd_block_tc (attention_fwd_tc.cuh) -------

template <bool kSwin>
__global__ void __launch_bounds__(kFtThreads, 2)
band_attention_tc_kernel(FwdQueries Q, FwdKeys K, FwdTables T, FwdOutputs O,
                         int n, int h, int tile, int band, float scale) {
  const int slices = tile / kFtRows;
  const int tile_idx = blockIdx.x / slices;
  const int t0 = tile_idx * tile;
  attention_fwd_block_tc<kSwin>(
      Q, K, T, O, h, t0 + (blockIdx.x - tile_idx * slices) * kFtRows,
      max(t0 - band, 0), min(t0 + tile + band, n), scale);
}

inline cudaError_t band_fwd_tc_limits(int* rows, int* max_nb) {
  size_t room = 0;
  const cudaError_t err = smem_room(band_attention_tc_kernel<false>, &room);
  if (err != cudaSuccess) return err;
  *rows = kFtRows;
  *max_nb = ft_max_nb(room);
  return cudaSuccess;
}

template <bool kSwin>
cudaError_t band_fwd_tc_launch(const FwdQueries& Q, const FwdKeys& K,
                               const FwdTables& T, const FwdOutputs& O,
                               int n, int h, int tile, int band, float scale,
                               cudaStream_t stream) {
  const size_t smem = FtSmem(T.nb).bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      band_attention_tc_kernel<kSwin>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(n / kFtRows, h);
  band_attention_tc_kernel<kSwin><<<grid, kFtThreads, smem, stream>>>(
      Q, K, T, O, n, h, tile, band, scale);
  return cudaGetLastError();
}

inline cudaError_t band_fwd_tc(
    const float* q, const float* k, const float* v, const float* xyz,
    const int32_t* seg_start, const int32_t* seg_end, const uint8_t* valid,
    const float* tq, const float* tk, const float* tv, float* acc, float* m,
    float* den, int n, int h, int d, int q_rs, int k_rs, int v_rs, int tile,
    int band, int nb, int bin_lo, int nb_full, int swin, float bin_offset,
    float inv_quant, float scale, cudaStream_t stream) {
  int rows = 0, max_nb = 0;
  const cudaError_t err = band_fwd_tc_limits(&rows, &max_nb);
  if (err != cudaSuccess) return err;
  // q, k and v are read a float4 at a time
  if (d != 16 || tile <= 0 || tile % rows != 0 || n % tile != 0 || nb < 0 ||
      nb > max_nb || (swin != 0 && (bin_lo != 0 || nb != nb_full)) ||
      !rows16(q, q_rs) || !rows16(k, k_rs) || !rows16(v, v_rs))
    return cudaErrorInvalidValue;
  const FwdQueries Q{q, q_rs, nullptr, xyz, valid, seg_start, seg_end,
                     nullptr};
  const FwdKeys K{k, k_rs, v, v_rs, nullptr, xyz, valid, nullptr};
  const FwdTables T{tq, tk, tv, nb, bin_lo, nb_full, bin_offset, inv_quant};
  const FwdOutputs O{acc, m, den};
  return swin ? band_fwd_tc_launch<true>(Q, K, T, O, n, h, tile, band, scale,
                                         stream)
              : band_fwd_tc_launch<false>(Q, K, T, O, n, h, tile, band,
                                          scale, stream);
}

}  // namespace stratified

// Diagnostic entry point: the bins table_bin (the device function the
// attention kernels use: rel_bin, or swin_bin when swin is 1) gives for n
// relative coordinates of one axis.
extern "C" int rel_bin_probe(const float* rel, int32_t* out, int n,
                             float bin_offset, float inv_quant, int nb_full,
                             int bin_lo, int nb, int swin, void* stream) {
  const int threads = 256;
  stratified::rel_bin_probe_kernel<<<(n + threads - 1) / threads, threads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      rel, out, n, bin_offset, inv_quant, nb_full, bin_lo, nb, swin);
  return static_cast<int>(cudaGetLastError());
}

// C entry point, bound with ctypes. q/k/v are [N,H,D] fp32 rows of q_rs /
// k_rs / v_rs floats (head stride D, channel stride 1: the model's views of
// its qkv projection); q is scaled by `scale` in the kernel. xyz [N,3]
// fp32, seg bounds [N] int32, valid [N] bool; the tables are the model's
// [nb_full][H][D][3] fp32 or null, of which rows [bin_lo, bin_lo + nb) are
// read. swin 0: the stratified bins of xyz, the points' coordinates; swin
// 1: Swin3D's window-quantized bins (rpe_mode "swin_window"), xyz holding
// the points' quantized in-window positions, bin_lo 0 and nb = nb_full.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head size other than 16, a tile that is not a multiple of 64, more table
// rows per axis than band_attention_limits (the swin mode:
// band_attention_swin_limits) gives, or in the swin mode a table slice or
// rows of q, k, v that do not start on 16 bytes).
extern "C" int band_attention_fwd(
    const float* q, const float* k, const float* v, const float* xyz,
    const int32_t* seg_start, const int32_t* seg_end, const uint8_t* valid,
    const float* tq, const float* tk, const float* tv, float* acc, float* m,
    float* den, int n, int h, int d, int q_rs, int k_rs, int v_rs, int tile,
    int band, int nb, int bin_lo, int nb_full, int swin, float bin_offset,
    float inv_quant, float scale, void* stream) {
  return static_cast<int>(stratified::band_fwd(
      q, k, v, xyz, seg_start, seg_end, valid, tq, tk, tv, acc, m, den, n,
      h, d, q_rs, k_rs, v_rs, tile, band, nb, bin_lo, nb_full, swin,
      bin_offset, inv_quant, scale, static_cast<cudaStream_t>(stream)));
}

// The fast (bf16) form (attention_fwd_tc.cuh): the same arguments and
// outputs as band_attention_fwd, with q, k and v at 16-byte aligned rows
// (row strides a multiple of 4 floats); band_attention_bf16_limits gives
// its limits.
extern "C" int band_attention_fwd_bf16(
    const float* q, const float* k, const float* v, const float* xyz,
    const int32_t* seg_start, const int32_t* seg_end, const uint8_t* valid,
    const float* tq, const float* tk, const float* tv, float* acc, float* m,
    float* den, int n, int h, int d, int q_rs, int k_rs, int v_rs, int tile,
    int band, int nb, int bin_lo, int nb_full, int swin, float bin_offset,
    float inv_quant, float scale, void* stream) {
  return static_cast<int>(stratified::band_fwd_tc(
      q, k, v, xyz, seg_start, seg_end, valid, tq, tk, tv, acc, m, den, n,
      h, d, q_rs, k_rs, v_rs, tile, band, nb, bin_lo, nb_full, swin,
      bin_offset, inv_quant, scale, static_cast<cudaStream_t>(stream)));
}

// Rows per block, and the most table rows per axis whose block fits the
// current device's shared memory per block (106 on the H100; the band slice
// of S3DIS's 64-bin tables has 40, of ScanNet's 80-bin tables 48). Returns
// a cudaError_t.
extern "C" int band_attention_limits(int* rows, int* max_nb) {
  return static_cast<int>(stratified::band_fwd_limits(rows, max_nb));
}

// The blocks of band_attention_fwd's launch for nb table rows per axis
// (swin as band_attention_fwd) that one SM of the current device holds at
// once. Returns a cudaError_t.
extern "C" int band_attention_occupancy(int nb, int swin, int* blocks) {
  return static_cast<int>(swin ? stratified::band_fwd_blocks<true>(nb, blocks)
                               : stratified::band_fwd_blocks<false>(nb,
                                                                    blocks));
}

// The same for the fp32 swin mode (swin 1): 64 rows, two blocks per SM at
// Swin3D's 31 table rows per axis.
extern "C" int band_attention_swin_limits(int* rows, int* max_nb) {
  return static_cast<int>(stratified::band_fwd_swin_limits(rows, max_nb));
}

// The same for the fast form: 64 rows, and on the H100 up to 101 table
// rows per axis (two blocks per SM up to ScanNet's slice of 48).
extern "C" int band_attention_bf16_limits(int* rows, int* max_nb) {
  return static_cast<int>(stratified::band_fwd_tc_limits(rows, max_nb));
}
