// Shared device code of the two stratified-attention backward kernels.
//
// Both kernels give one thread block to each (query tile, head), as the
// forward kernels do, and run the same routine (attention_bwd_block) over a
// window of keys; they differ only in which keys a tile sees.
//
// Given the forward's merged statistics m and den (over BOTH halves) and its
// normalised output o, each pair (t, j) recomputes its logit l exactly as the
// forward kernel does and forms (fused_attention_bwd.py:5-15)
//   r  = exp(l - m_t) / den_t,
//   dl = r * (g_t·(v_j + Σ_a Tv[b_a]) - g_t·o_t),
// and the gradients
//   dq_t  += dl (k_j + Σ_a Tq[b_a])          (times scale on the way out)
//   dk_j  += dl (q_t + Σ_a Tk[b_a]),   dv_j += r g_t
//   dTq[b_a] += dl q_t,  dTk[b_a] += dl k_j,  dTv[b_a] += r g_t.
//
// Per key chunk (kBwdChunk keys staged in shared memory) a block runs three
// phases:
//   A. one thread per query row: recompute the pair terms, accumulate the
//      row's dq in registers, and leave dl, r and the three bins of every
//      (key, row) pair in shared memory. Lane L of a warp visits the chunk's
//      keys from key -L (mod chunk), so the lanes read different key rows
//      (padded strides keep them on distinct banks);
//   B. one lane per key, one warp per 32-row slice of the tile: sum dk and
//      dv over the slice's rows in row order, then add the warps' partial
//      sums in warp order and write the chunk's keys into the tile's slot
//      buffer;
//   C. the table grads: warp a (one per axis) walks the chunk's pairs in
//      (key, row) order, its two half-warps taking alternate rows, each
//      lane one channel; it adds dl·q, dl·k and r·g into the pair's bin row
//      of its own accumulators (an absent table's are never written out).
//      No two lanes share an address, so there are no atomics: many pairs of a tile fall into the same bin, and float
//      atomic adds in shared memory are compare-and-swap loops that
//      serialise on such an address (the first version of this kernel,
//      with 144 of them per pair and head, was 40x slower per step).
// Every sum has a fixed order, so the kernel is deterministic. Each block
// writes its table sums out per (tile, head); the wrapper reduces them over
// tiles in order.
#pragma once

#include "attention_common.cuh"

namespace stratified {

constexpr int kBwdChunk = 32;   // keys per round: one key per lane in phase B

// Shared-memory row strides (floats) that keep the lanes of a warp on
// distinct banks: key rows of D + 1 (phase A lanes read different keys),
// key coordinates of 5, and (key, row) pair rows of tile + 2 (phase A lanes
// write row t of key t - L; phase B lanes read one row of 32 keys).
// Bins are packed 8 bits per axis, so a table may have at most 256 rows.
template <int D>
struct BwdStride {
  static constexpr int kKey = D + 1;
  static constexpr int kXyz = 5;
  static __device__ __forceinline__ int pair(int tile) { return tile + 2; }
};

// Query side of a tile: rows [t0, t0 + blockDim.x) of [N,H,D] / [N,H] / [N]
// arrays. key_lo/key_hi bound each row's keys; skey (null for the band
// half) excludes keys of the row's own small window.
struct BwdQueries {
  const float* q;        // pre-scaled by d^-0.5
  const float* g;        // output cotangent
  const float* o;        // normalised merged output
  const float* m;        // merged row max
  const float* den;      // merged denominator
  const float* xyz;      // [N,3]
  const uint8_t* valid;
  const int32_t* key_lo;
  const int32_t* key_hi;
  const int32_t* skey;
};

// Key side: [K,H,D] k and v, [K,3] xyz, [K] valid, [K] skey or null.
struct BwdKeys {
  const float* k;
  const float* v;
  const float* xyz;
  const uint8_t* valid;
  const int32_t* skey;
};

// cRPE tables ([H][3][nb][D] slices, each may be null) and their bins.
struct BwdTables {
  const float* tq;
  const float* tk;
  const float* tv;
  int nb;
  int bin_lo;
  int nb_full;
  float bin_offset;
  float inv_quant;
};

// dq [N,H,D] (times scale); dk_part/dv_part [tiles][slots][H][D], zeroed by
// the wrapper, slot = key - slot0 of the tile; dt_part [tiles][H][3 tables]
// [3 axes][nb][D], the block's table-grad sums.
struct BwdOutputs {
  float* dq;
  float* dk_part;
  float* dv_part;
  float* dt_part;
};

// Shared-memory bytes of a block of `tile` threads: the three table slices,
// the table-grad accumulators (3 axes x 2 half-warps x 3 tables), the rows'
// q and g and coordinates, the key chunk, and the chunk's pairs (dl, r and
// packed bins).
template <int D>
constexpr size_t bwd_smem_bytes(int nb, int tile) {
  return sizeof(float) *
             ((9 + 18) * static_cast<size_t>(nb) * TableSmem<D>::kStride +
              static_cast<size_t>(tile) * (2 * D + 3) +
              kBwdChunk * (2 * BwdStride<D>::kKey + BwdStride<D>::kXyz) +
              2 * kBwdChunk * static_cast<size_t>(tile + 2)) +
         sizeof(int) * kBwdChunk * (static_cast<size_t>(tile + 2) + 1);
}

__device__ __forceinline__ void pair_bins(float xq0, float xq1, float xq2,
                                          const float* xk,
                                          const BwdTables& T, int* bins) {
  bins[0] = rel_bin(__fsub_rn(xq0, xk[0]), T.bin_offset, T.inv_quant,
                    T.nb_full, T.bin_lo, T.nb);
  bins[1] = rel_bin(__fsub_rn(xq1, xk[1]), T.bin_offset, T.inv_quant,
                    T.nb_full, T.bin_lo, T.nb);
  bins[2] = rel_bin(__fsub_rn(xq2, xk[2]), T.bin_offset, T.inv_quant,
                    T.nb_full, T.bin_lo, T.nb);
}

// The backward of one (tile, head) over keys [win_lo, win_hi) ∩ the union of
// the rows' [key_lo, key_hi). blockDim.x is the tile (a multiple of 32).
template <int D>
__device__ void attention_bwd_block(const BwdQueries& Q, const BwdKeys& K,
                                    const BwdTables& T, const BwdOutputs& O,
                                    int n, int h, int tile_idx, int win_lo,
                                    int win_hi, int slot0, int n_slots,
                                    float scale) {
  static_assert(D == 16, "phase C gives one lane of a half-warp a channel");
  extern __shared__ float smem[];
  constexpr int C = kBwdChunk;
  const int tile = blockDim.x;
  const int nb = T.nb;
  const int tf = 3 * nb * TableSmem<D>::kStride;
  const int rf = nb * TableSmem<D>::kStride;   // one table's rows of one axis
  float* s_tq = smem;
  float* s_tk = s_tq + tf;
  float* s_tv = s_tk + tf;
  float* s_acc = s_tv + tf;             // [3 axes][2 halves][3 tables][nb][D+1]
  float* s_q = s_acc + 6 * tf;          // [tile][D]
  float* s_g = s_q + tile * D;          // [tile][D]
  float* s_xq = s_g + tile * D;         // [tile][3]
  constexpr int KS = BwdStride<D>::kKey;
  constexpr int XS = BwdStride<D>::kXyz;
  const int PS = BwdStride<D>::pair(tile);
  float* s_k = s_xq + tile * 3;         // [C][KS]
  float* s_v = s_k + C * KS;            // [C][KS]
  float* s_xk = s_v + C * KS;           // [C][XS]: xyz, valid
  float* s_dl = s_xk + C * XS;          // [C][PS]
  float* s_r = s_dl + C * PS;           // [C][PS]
  int* s_bin = reinterpret_cast<int*>(s_r + C * PS);   // [C][PS]
  int* s_skey = s_bin + C * PS;
  __shared__ int s_lo, s_hi;

  const int head = blockIdx.y;
  const int tid = threadIdx.x;
  const int row = tile_idx * tile + tid;
  const float* ptq = T.tq != nullptr ? s_tq : nullptr;
  const float* ptk = T.tk != nullptr ? s_tk : nullptr;
  const float* ptv = T.tv != nullptr ? s_tv : nullptr;

  if (ptq != nullptr) load_table<D>(s_tq, T.tq, head, nb);
  if (ptk != nullptr) load_table<D>(s_tk, T.tk, head, nb);
  if (ptv != nullptr) load_table<D>(s_tv, T.tv, head, nb);
  for (int i = tid; i < 6 * tf; i += tile) s_acc[i] = 0.0f;
  if (tid == 0) {
    s_lo = win_hi;
    s_hi = win_lo;
  }
  __syncthreads();

  const bool row_ok = row < n && Q.valid[row];
  const int ks = row_ok ? Q.key_lo[row] : 0;
  const int ke = row_ok ? Q.key_hi[row] : 0;
  const int skey = (Q.skey != nullptr && row < n) ? Q.skey[row] : 0;
  if (row_ok && ke > ks) {
    atomicMin(&s_lo, ks);
    atomicMax(&s_hi, ke);
  }
  float q[D], g[D], dq[D];
  float m = 0.0f, den = 1.0f, go = 0.0f;
  float xq0 = 0.0f, xq1 = 0.0f, xq2 = 0.0f;
  if (row < n) {
    const size_t o = static_cast<size_t>(row) * h + head;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      q[c] = Q.q[o * D + c];
      g[c] = Q.g[o * D + c];
      go = fmaf(g[c], Q.o[o * D + c], go);
    }
    m = Q.m[o];
    den = fmaxf(Q.den[o], 1e-20f);
    xq0 = Q.xyz[row * 3 + 0];
    xq1 = Q.xyz[row * 3 + 1];
    xq2 = Q.xyz[row * 3 + 2];
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) q[c] = g[c] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < D; ++c) {
    s_q[tid * D + c] = q[c];
    s_g[tid * D + c] = g[c];
    dq[c] = 0.0f;
  }
  s_xq[tid * 3 + 0] = xq0;
  s_xq[tid * 3 + 1] = xq1;
  s_xq[tid * 3 + 2] = xq2;
  __syncthreads();
  const int lo = max(s_lo, win_lo);
  const int hi = min(s_hi, win_hi);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = tile >> 5;

  for (int c0 = lo; c0 < hi; c0 += C) {
    const int cn = min(C, hi - c0);
    for (int i = tid; i < cn * D; i += tile) {
      const int j = i / D, c = i - j * D;
      const size_t src = (static_cast<size_t>(c0 + j) * h + head) * D + c;
      s_k[j * KS + c] = K.k[src];
      s_v[j * KS + c] = K.v[src];
    }
    for (int j = tid; j < cn; j += tile) {
      const int p = c0 + j;
      s_xk[j * XS + 0] = K.xyz[p * 3 + 0];
      s_xk[j * XS + 1] = K.xyz[p * 3 + 1];
      s_xk[j * XS + 2] = K.xyz[p * 3 + 2];
      s_xk[j * XS + 3] = K.valid[p] ? 1.0f : 0.0f;
      s_skey[j] = K.skey != nullptr ? K.skey[p] : 0;
    }
    __syncthreads();

    // ---- phase A: one thread per query row ------------------------------
    const int lane_off = lane % cn;
    for (int step = 0; step < cn; ++step) {
      const int j = step >= lane_off ? step - lane_off : step - lane_off + cn;
      const int p = c0 + j;
      float dl = 0.0f, r = 0.0f;
      int packed = 0;
      if (row_ok && p >= ks && p < ke && s_xk[j * XS + 3] != 0.0f &&
          (K.skey == nullptr || s_skey[j] != skey)) {
        const float* kj = s_k + j * KS;
        const float* vj = s_v + j * KS;
        int bins[3] = {0, 0, 0};
        if (nb > 0) pair_bins(xq0, xq1, xq2, s_xk + j * XS, T, bins);
        packed = bins[0] | (bins[1] << 8) | (bins[2] << 16);
        // the logit in the forward kernel's order (RowState::add_key)
        float l = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) l = fmaf(q[c], kj[c], l);
        if (ptq != nullptr) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float* tr = ptq + TableSmem<D>::offset(a, bins[a], nb);
            float s = 0.0f;
#pragma unroll
            for (int c = 0; c < D; ++c) s = fmaf(q[c], tr[c], s);
            l += s;
          }
        }
        if (ptk != nullptr) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float* tr = ptk + TableSmem<D>::offset(a, bins[a], nb);
            float s = 0.0f;
#pragma unroll
            for (int c = 0; c < D; ++c) s = fmaf(kj[c], tr[c], s);
            l += s;
          }
        }
        r = expf(l - m) / den;
        float gv = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) gv = fmaf(g[c], vj[c], gv);
        if (ptv != nullptr) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float* tr = ptv + TableSmem<D>::offset(a, bins[a], nb);
            float s = 0.0f;
#pragma unroll
            for (int c = 0; c < D; ++c) s = fmaf(g[c], tr[c], s);
            gv += s;
          }
        }
        dl = r * (gv - go);
        if (ptq != nullptr) {
          const float* t0r = ptq + TableSmem<D>::offset(0, bins[0], nb);
          const float* t1r = ptq + TableSmem<D>::offset(1, bins[1], nb);
          const float* t2r = ptq + TableSmem<D>::offset(2, bins[2], nb);
#pragma unroll
          for (int c = 0; c < D; ++c)
            dq[c] = fmaf(dl, kj[c] + t0r[c] + t1r[c] + t2r[c], dq[c]);
        } else {
#pragma unroll
          for (int c = 0; c < D; ++c) dq[c] = fmaf(dl, kj[c], dq[c]);
        }
      }
      s_dl[j * PS + tid] = dl;
      s_r[j * PS + tid] = r;
      s_bin[j * PS + tid] = packed;
    }
    __syncthreads();

    // ---- phase B: lane = key, warp = 32-row slice -------------------------
    float dk[D], dv[D];
#pragma unroll
    for (int c = 0; c < D; ++c) dk[c] = dv[c] = 0.0f;
    if (lane < cn) {
      for (int tt = warp * 32; tt < warp * 32 + 32; ++tt) {
        const float dl = s_dl[lane * PS + tt];
        const float r = s_r[lane * PS + tt];
        if (dl == 0.0f && r == 0.0f) continue;
        const float* qt = s_q + tt * D;
        const float* gt = s_g + tt * D;
        if (ptk != nullptr) {
          const int packed = s_bin[lane * PS + tt];
          const float* t0r = ptk + TableSmem<D>::offset(0, packed & 255, nb);
          const float* t1r =
              ptk + TableSmem<D>::offset(1, (packed >> 8) & 255, nb);
          const float* t2r =
              ptk + TableSmem<D>::offset(2, (packed >> 16) & 255, nb);
#pragma unroll
          for (int c = 0; c < D; ++c)
            dk[c] = fmaf(dl, qt[c] + t0r[c] + t1r[c] + t2r[c], dk[c]);
        } else {
#pragma unroll
          for (int c = 0; c < D; ++c) dk[c] = fmaf(dl, qt[c], dk[c]);
        }
#pragma unroll
        for (int c = 0; c < D; ++c) dv[c] = fmaf(r, gt[c], dv[c]);
      }
    }

    // ---- phase C: warp = axis, half-warp = row parity, lane = channel ---
    if (nb > 0) {
      const int half = lane >> 4, c = lane & 15;
      for (int a = warp; a < 3; a += n_warps) {
        float* aq = s_acc + ((a * 2 + half) * 3 + 0) * rf + c;
        float* ak = s_acc + ((a * 2 + half) * 3 + 1) * rf + c;
        float* av = s_acc + ((a * 2 + half) * 3 + 2) * rf + c;
        for (int j = 0; j < cn; ++j) {
          const float kjc = s_k[j * KS + c];
          for (int tt = half; tt < tile; tt += 2) {
            const float dl = s_dl[j * PS + tt];
            const float r = s_r[j * PS + tt];
            if (dl == 0.0f && r == 0.0f) continue;
            const int off = ((s_bin[j * PS + tt] >> (8 * a)) & 255) *
                            TableSmem<D>::kStride;
            aq[off] = fmaf(dl, s_q[tt * D + c], aq[off]);
            ak[off] = fmaf(dl, kjc, ak[off]);
            av[off] = fmaf(r, s_g[tt * D + c], av[off]);
          }
        }
      }
    }
    __syncthreads();                      // s_dl / s_r are reused below
    float* s_pk = s_dl;                   // [n_warps][C][D]
    float* s_pv = s_dl + n_warps * C * D;
    if (lane < cn) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        s_pk[(warp * C + lane) * D + c] = dk[c];
        s_pv[(warp * C + lane) * D + c] = dv[c];
      }
    }
    __syncthreads();
    for (int i = tid; i < cn * D; i += tile) {
      const int j = i / D, c = i - j * D;
      float sk = 0.0f, sv = 0.0f;
      for (int w = 0; w < n_warps; ++w) {
        sk += s_pk[(w * C + j) * D + c];
        sv += s_pv[(w * C + j) * D + c];
      }
      const size_t o =
          ((static_cast<size_t>(tile_idx) * n_slots + (c0 + j - slot0)) * h +
           head) * D + c;
      O.dk_part[o] = sk;
      O.dv_part[o] = sv;
    }
    __syncthreads();
  }

  if (row < n) {
    const size_t o = (static_cast<size_t>(row) * h + head) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) O.dq[o + c] = dq[c] * scale;
  }
  __syncthreads();
  const float* tabs[3] = {T.tq, T.tk, T.tv};
  for (int tb = 0; tb < 3; ++tb) {
    if (tabs[tb] == nullptr) continue;
    float* dst = O.dt_part +
                 ((static_cast<size_t>(tile_idx) * h + head) * 3 + tb) * 3 *
                     nb * D;
    for (int i = tid; i < 3 * nb * D; i += tile) {
      const int a = i / (nb * D), rest = i - a * nb * D;
      const int bin = rest / D, c = rest - bin * D;
      const int o = bin * TableSmem<D>::kStride + c;
      dst[i] = s_acc[((a * 2 + 0) * 3 + tb) * rf + o] +
               s_acc[((a * 2 + 1) * 3 + tb) * rf + o];
    }
  }
}

}  // namespace stratified
