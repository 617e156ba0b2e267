// Shared device code of the two stratified-attention backward kernels.
//
// Both kernels give one block of 256 threads to each (row slice, head): a
// slice is R consecutive rows of a 128-row query tile, and it sees the
// tile's window of keys (the 128-row tile stays semantic). The kernels run
// the same routine (attention_bwd_block) and differ only in which keys a
// tile sees.
//
// Given the forward's merged statistics m and den (over BOTH halves) and its
// normalised output o, each pair (t, j) recomputes its logit l and forms
// (fused_attention_bwd.py:5-15)
//   r  = exp(l - m_t) / den_t,
//   dl = r * (g_t·(v_j + Σ_a Tv[b_a]) - g_t·o_t),
// and the gradients
//   dq_t  += dl (k_j + Σ_a Tq[b_a])          (times scale on the way out)
//   dk_j  += dl (q_t + Σ_a Tk[b_a]),   dv_j += r g_t
//   dTq[b_a] += dl q_t,  dTk[b_a] += dl k_j,  dTv[b_a] += r g_t.
//
// The table terms take the projection form of the TPU kernel
// (fused_attention_bwd.py:132-259). Per block, each row's q is projected
// onto the 3·nb rows of Tq and its g onto those of Tv, once; per key chunk,
// each key's k onto those of Tk. A pair then reads three projections per
// table instead of taking 16-long dot products. The table terms of the
// gradients go through bin masses: per row and (axis, bin), Mq = Σ dl and
// Mr = Σ r over the row's keys in that bin; per key of a chunk, Mk = Σ dl
// over the rows. Then dq += Mq·Tq and dTq = Mqᵀq, dTv = Mrᵀg at the end of
// the block, and dTk += Mkᵀk per chunk: small matrix products instead of
// sums per pair. dk's table term is taken per pair in the key phase, from
// the pair's three Tk rows: a key meets at most R rows of the block, and
// the product Mk·Tk over all 3·nb table rows per key cost more (PERF.md,
// the swin backward's phase split). For the same reason the swin mode,
// whose keys meet few rows, takes k·Tk per pair in the pair phase instead
// of projecting each key onto all 3·nb rows.
//
// Per key chunk (kBwdChunk keys, loaded by cp.async into one of two key
// buffers while the chunk before computes):
//   1. every thread: the chunk's key projections onto Tk (not in the swin
//      mode);
//   2. pair phase, kBwdThreads / R lanes per row, each lane taking every
//      (256 / R)-th key of those the warp's rows reach: the pair's logit,
//      r and dl with 16-channel dot products and three lookups per table,
//      the row's dq in registers, and dl, r and the bins into shared
//      memory. Then lane a < 3 of the row walks the chunk's keys in order
//      and adds dl and r into the row's masses of axis a;
//   3. key phase: warps 0-3 sum dk (with its Tk term) and dv over the rows
//      in row order (4 lanes per key, 4 channels each) and write them out
//      to the tile's key slots, warps 4-7 the key's dl mass per bin (one
//      lane per axis, which first zeroes its key's masses, the key
//      projections' room); a warp's rows are visited only for the keys
//      they reached;
//   4. every thread: the block's dTk += Mkᵀk.
// The mass walks load a run of values and bins before adding them
// (MassWalk, tensor_core.cuh: each entry's sum in the order of its adds).
// At the end of the block the row's lanes add their dq parts by shuffles.
// This routine is the fp32 form (the TPU kernels at fast=False): what bounds
// it on the H100 is the fp32 work of the pairs and of the table products
// (PERF.md kernel table: bound by operations at 67 TFLOP/s). Its products
// run on fp32 FMA, register-blocked, which measured faster than 3xTF32
// mma.sync for these small products (PERF.md, Findings). The fast (bf16)
// forms run attention_bwd_block_tc (attention_bwd_tc.cuh) instead.
// What holds it back in practice is latency: serial mass walks and a
// barrier per phase, with few pairs per block in the swin mode. The swin
// mode's 31-row tables take 32-row blocks of which two fit on an SM
// (bwd_paired; PERF.md, the swin backward's phase split), so one block's
// walks and barriers overlap the other's; the key chunks arrive by
// cp.async while the chunk before computes.
// No two threads write one shared-memory address in a phase, so there are
// no atomics (shared-memory float atomics serialise where the lanes of a
// warp share bins: the first backward kernel of the port was 40x slower for
// them), and every sum runs in a fixed order, so the kernel is
// deterministic. Each block writes its dk/dv slots and table sums per
// (slice, head); the wrapper adds the slices and tiles in order.
#pragma once

#include "tensor_core.cuh"

namespace stratified {

constexpr int kBwdChunk = 32;     // keys per round
constexpr int kBwdThreads = 256;  // 8 warps per block

// Whether the blocks of R rows are built to run two per SM: the swin mode's
// 32-row blocks (__launch_bounds__(kBwdThreads, 2), at most 128 registers a
// thread), whose shared memory at up to 32 table rows per axis fits twice
// in the H100's 228 KB.
template <int R, bool kSwin>
__host__ __device__ constexpr bool bwd_paired() { return kSwin && R == 32; }

// Table rows per axis that a block of R rows is instantiated for: they size
// each thread's table-grad units (NU below). The 64- and 32-row blocks keep
// 64 (S3DIS's tables), the paired swin blocks 32 (Swin3D's 31); the 16-row
// block, which ScanNet's 80-row tables need, takes up to 128 (its shared
// memory fits 112 on the H100).
template <int R, bool kSwin = false>
__host__ __device__ constexpr int bwd_nb_cap() {
  return bwd_paired<R, kSwin>() ? 32 : R >= 32 ? 64 : 128;
}
// floats per staged q/g/k/v row and per table row: 16-byte rows whose
// float4 reads by 8 neighbouring rows fall on distinct banks
constexpr int kBwdRowStride = 20;

// Query side of a tile: rows of [N,H,D] / [N,H] / [N] arrays. key_lo/key_hi
// bound each row's keys; skey (null for the band half) excludes keys of the
// row's own small window.
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

// dq [N,H,D] (times scale); dk_part/dv_part [blocks][slots][H][D], zeroed
// by the wrapper, block = tile * slices + slice, slot = key - slot0 of the
// tile; dt_part [blocks][H][3 tables][3 axes][nb][D], the block's
// table-grad sums.
struct BwdOutputs {
  float* dq;
  float* dk_part;
  float* dv_part;
  float* dt_part;
};

// Shared-memory layout of a block of R rows (offsets in 4-byte words, each
// array 16-byte aligned). Per-row arrays of (axis, bin) pairs have an odd
// stride (3·nb + 1) so that neighbouring rows fall on other banks. Two key
// buffers of kKeyBuf words, each k [C][S], v [C][S], the points [C][4]
// (x, y, z, valid) and skey [C].
template <int D, int R>
struct BwdSmem {
  static constexpr int C = kBwdChunk;
  static constexpr int S = kBwdRowStride;
  static constexpr int kKeyBuf = 2 * C * S + 4 * C + C;
  int nb3, ps;
  int tab, proj, mass, kp, keys, q, g, dl, r, bin, act, total;

  __host__ __device__ static int up4(int x) { return (x + 3) & ~3; }
  __host__ __device__ explicit BwdSmem(int nb) : nb3(3 * nb), ps(3 * nb + 1) {
    int o = 0;
    tab = o;  o += 3 * nb3 * S;           // Tq, Tk, Tv: [3][3·nb][S]
    proj = o; o += up4(2 * R * ps);       // float2 (q·Tq, g·Tv) [R][ps]
    mass = o; o += up4(2 * R * ps);       // float2 (Mq, Mr) [R][ps]
    kp = o;   o += up4(C * ps);           // k·Tk, then Mk [C][ps]
    keys = o; o += 2 * kKeyBuf;           // the two key buffers
    q = o;    o += R * S;
    g = o;    o += R * S;
    dl = o;   o += up4(R * (C + 1));
    r = o;    o += up4(R * (C + 1));
    bin = o;  o += up4(R * (C + 1));      // the axes' bins, 8 bits each
    act = o;  o += 4 * kBwdThreads / 32;  // each warp's keys; the rows' span
    total = o;
  }
  __host__ size_t bytes() const { return sizeof(float) * static_cast<size_t>(total); }
};

// The most table rows per axis (at most bwd_nb_cap<R, kSwin>) for which a
// block of R rows fits in `room` bytes. On the H100: 44 for 64-row blocks,
// 64 (the cap; 76 would fit) for 32-row blocks, 32 (the cap) for the
// paired swin blocks, 112 for 16-row blocks.
template <int D, int R, bool kSwin = false>
__host__ int bwd_max_nb(size_t room) {
  int nb = bwd_nb_cap<R, kSwin>();
  while (nb > 0 && BwdSmem<D, R>(nb).bytes() > room) --nb;
  return nb;
}

// Rows per block for a table of nb rows per axis: the first of the offered
// block heights (in the kernel's order of preference) whose block takes nb,
// or 0 if none does; max_nb, the most any of them takes. max_nb_of[i] is
// bwd_max_nb of rows_of[i] on the current device.
__host__ inline void bwd_pick_rows(int nb, const int* rows_of,
                                   const int* max_nb_of, int count,
                                   int* rows, int* max_nb) {
  *rows = 0;
  *max_nb = 0;
  for (int i = 0; i < count; ++i) {
    if (*rows == 0 && nb <= max_nb_of[i]) *rows = rows_of[i];
    *max_nb = max_nb_of[i] > *max_nb ? max_nb_of[i] : *max_nb;
  }
}

// The backward of rows [row0, row0 + R), for the head blockIdx.y, over keys
// [win_lo, win_hi) ∩ the union of the rows' [key_lo, key_hi). The tile's
// n_slots key slots start at key slot0; blk indexes dk_part/dv_part and
// dt_part. kSwin: Swin3D's bins (table_bin). The rows of q, g, k, v and the
// tables start on 16 bytes (cp.async; the wrappers' copies do).
template <int D, int R, bool kSwin = false>
__device__ void attention_bwd_block(const BwdQueries& Q, const BwdKeys& K,
                                    const BwdTables& T, const BwdOutputs& O,
                                    int h, int blk, int row0,
                                    int win_lo, int win_hi, int slot0,
                                    int n_slots, float scale) {
  static_assert(D == 16, "the key phase gives 4 lanes 4 channels each");
  constexpr int NT = kBwdThreads;
  constexpr int NW = NT / 32;
  constexpr int C = kBwdChunk;
  constexpr int S = kBwdRowStride;
  constexpr int LPR = NT / R;           // lanes per row in the pair phase
  constexpr int RPW = 32 / LPR;         // rows per warp
  constexpr int KB = BwdSmem<D, R>::kKeyBuf;
  // (bin row, 4 channels) units of a table grad owned by each thread
  constexpr int NU = (3 * bwd_nb_cap<R, kSwin>() * (D / 4) + NT - 1) / NT;
  static_assert(LPR >= 4 && LPR <= 32, "R in [8, 64]");
  static_assert(bwd_nb_cap<R, kSwin>() <= 255,
                "bins are packed 8 bits per axis");
  static_assert(2 * C * (D / 4) == NT, "one 16-byte copy of k or v a thread");

  extern __shared__ __align__(16) float smem[];
  const BwdSmem<D, R> L(T.nb);
  const int nb = T.nb, nb3 = L.nb3, ps = L.ps;
  const bool tabs = nb > 0;
  float* s_tab = smem + L.tab;
  float2* s_proj = reinterpret_cast<float2*>(smem + L.proj);
  float2* s_mass = reinterpret_cast<float2*>(smem + L.mass);
  float* s_kp = smem + L.kp;
  float* s_q = smem + L.q;
  float* s_g = smem + L.g;
  float* s_dl = smem + L.dl;
  float* s_r = smem + L.r;
  int* s_bin = reinterpret_cast<int*>(smem + L.bin);
  int* s_act = reinterpret_cast<int*>(smem + L.act);

  const int head = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // ---- tables, rows, masses: the tables, q and g by cp.async -------------
  const float* tabs_in[3] = {T.tq, T.tk, T.tv};
  for (int tb = 0; tb < 3; ++tb) {
    const float* src = tabs_in[tb] == nullptr ? nullptr
        : tabs_in[tb] + static_cast<size_t>(head) * nb3 * D;
    for (int i = tid; i < nb3 * (D / 4); i += NT) {
      float* dst = s_tab + (tb * nb3 + (i >> 2)) * S + (i & 3) * 4;
      if (src != nullptr)
        cp_async16(smem_addr(dst), src + i * 4, true);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int i = tid; i < 2 * R * (D / 4); i += NT) {
    const int t = (i >> 2) % R, c4 = (i & 3) * 4;
    const bool is_g = i >= R * (D / 4);
    const size_t o = (static_cast<size_t>(row0 + t) * h + head) * D + c4;
    cp_async16(smem_addr((is_g ? s_g : s_q) + t * S + c4),
               (is_g ? Q.g : Q.q) + o, true);
  }
  cp_async_commit();
  for (int i = tid; i < (2 * R * ps + 3) / 4; i += NT)
    reinterpret_cast<float4*>(s_mass)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // this thread's row in the pair phase (LPR lanes per row)
  const int t = tid / LPR, sub = tid % LPR;
  const int row = row0 + t;
  const bool row_ok = Q.valid[row] != 0;
  const int ks = row_ok ? Q.key_lo[row] : 0;
  const int ke = row_ok ? Q.key_hi[row] : 0;
  const int skey = Q.skey != nullptr ? Q.skey[row] : 0;
  const size_t ro = static_cast<size_t>(row) * h + head;
  float go = 0.0f;                      // g·o
#pragma unroll
  for (int c = 0; c < D; ++c) go = fmaf(Q.g[ro * D + c], Q.o[ro * D + c], go);
  const float m = Q.m[ro];
  const float den = fmaxf(Q.den[ro], 1e-20f);
  const float xq0 = Q.xyz[row * 3 + 0], xq1 = Q.xyz[row * 3 + 1],
              xq2 = Q.xyz[row * 3 + 2];
  {
    // the span of the warp's rows' keys (s_act[2 NW..4 NW))
    const bool any = row_ok && ke > ks;
    const int wlo = static_cast<int>(__reduce_min_sync(
        0xffffffffu, any ? static_cast<unsigned>(ks) : 0x7fffffffu));
    const int whi = static_cast<int>(__reduce_max_sync(
        0xffffffffu, any ? static_cast<unsigned>(ke) : 0u));
    if (lane == 0) {
      s_act[2 * NW + 2 * warp] = wlo;
      s_act[2 * NW + 2 * warp + 1] = whi;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  int lo = win_hi, hi = win_lo;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    lo = min(lo, s_act[2 * NW + 2 * w]);
    hi = max(hi, s_act[2 * NW + 2 * w + 1]);
  }
  lo = max(lo, win_lo);
  hi = min(hi, win_hi);

  // key chunk [c0, c0 + C) into key buffer b: k, v (16-byte copies) and the
  // points, skey (4-byte) by cp.async; keys past hi are never read
  auto stage_chunk = [&](int b, int c0) {
    const int cn = min(C, hi - c0);
    float* kb = smem + L.keys + b * KB;
    {
      const int j = tid >> 3, which = (tid >> 2) & 1, c4 = (tid & 3) * 4;
      const bool full = j < cn;
      cp_async16(smem_addr(kb + which * C * S + j * S + c4),
                 (which ? K.v : K.k) +
                     (static_cast<size_t>(c0 + (full ? j : 0)) * h + head) *
                         D + c4,
                 full);
    }
    if (tid < 3 * C) {
      const int j = tid / 3, a = tid - 3 * j;
      cp_async4(smem_addr(kb + 2 * C * S + j * 4 + a),
                K.xyz + static_cast<size_t>(c0 + (j < cn ? j : 0)) * 3 + a,
                j < cn);
    } else if (tid < 4 * C && K.skey != nullptr) {
      const int j = tid - 3 * C;
      cp_async4(smem_addr(kb + 2 * C * S + 4 * C + j),
                K.skey + c0 + (j < cn ? j : 0), j < cn);
    }
  };
  // the keys' valid flags (bytes, which cp.async does not copy): loaded into
  // a register of thread j < C one chunk ahead, stored as a float beside the
  // key's point when its chunk comes up
  int vnext = 0;
  if (lo < hi) {
    stage_chunk(0, lo);
    if (tid < C)
      smem[L.keys + 2 * C * S + tid * 4 + 3] =
          tid < hi - lo && K.valid[lo + tid] ? 1.0f : 0.0f;
  }
  cp_async_commit();

  float q[D], g[D], dq[D];
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    lds4(s_q + t * S + c, q + c);
    lds4(s_g + t * S + c, g + c);
  }
#pragma unroll
  for (int c = 0; c < D; ++c) dq[c] = 0.0f;

  // the rows' projections onto Tq and Tv: a thread keeps one row's q and g
  // in registers and takes every (NT / R)-th table row
  {
    const int tt = tid % R;
    float qr[D], gr[D];
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      lds4(s_q + tt * S + c, qr + c);
      lds4(s_g + tt * S + c, gr + c);
    }
    for (int ab = tid / R; ab < nb3; ab += NT / R) {
      float tq[D], tv[D];
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        lds4(s_tab + ab * S + c, tq + c);
        lds4(s_tab + (2 * nb3 + ab) * S + c, tv + c);
      }
      float sq = 0.0f, sg = 0.0f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        sq = fmaf(qr[c], tq[c], sq);
        sg = fmaf(gr[c], tv[c], sg);
      }
      s_proj[tt * ps + ab] = make_float2(sq, sg);
    }
  }
  float acc_k[NU][4];                   // this thread's units of dTk
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[u][c] = 0.0f;

  int b = 0;                            // the key buffer of chunk c0
  for (int c0 = lo; c0 < hi; c0 += C, b ^= 1) {
    const int cn = min(C, hi - c0);
    float* s_k = smem + L.keys + b * KB;
    float* s_v = s_k + C * S;
    float* s_xk = s_v + C * S;          // x, y, z, valid
    const int* s_skey = reinterpret_cast<const int*>(s_xk + 4 * C);
    if (c0 != lo && tid < C) s_xk[tid * 4 + 3] = vnext ? 1.0f : 0.0f;
    cp_async_wait<0>();                 // this chunk has landed
    __syncthreads();
    // the next chunk into the other buffer, which the last chunk's phases
    // left before that barrier
    if (c0 + C < hi) {
      stage_chunk(b ^ 1, c0 + C);
      vnext = tid < min(C, hi - c0 - C) ? K.valid[c0 + C + tid] : 0;
    }
    cp_async_commit();

    // ---- 1. the chunk's keys projected onto Tk: a thread keeps one key in
    //         registers and takes every (NT / C)-th table row (not in the
    //         swin mode, where a key meets few rows: phase 2 takes each
    //         pair's three projections itself) ----------------------------
    if (!kSwin && tabs && (tid & (C - 1)) < cn) {
      const int j = tid & (C - 1);
      float kr[D];
#pragma unroll
      for (int c = 0; c < D; c += 4) lds4(s_k + j * S + c, kr + c);
      for (int ab = tid / C; ab < nb3; ab += NT / C) {
        float tk[D];
#pragma unroll
        for (int c = 0; c < D; c += 4)
          lds4(s_tab + (nb3 + ab) * S + c, tk + c);
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) s = fmaf(kr[c], tk[c], s);
        s_kp[j * ps + ab] = s;
      }
    }
    if (!kSwin) __syncthreads();

    // ---- 2. pair phase: the LPR lanes of a row take every LPR-th key of
    //         the keys of the chunk that the warp's rows reach ------------
    const bool reach = row_ok && ks < c0 + cn && ke > c0;
    const int jlo = static_cast<int>(__reduce_min_sync(
        0xffffffffu, reach ? static_cast<unsigned>(max(ks - c0, 0)) : C));
    const int jhi = static_cast<int>(__reduce_max_sync(
        0xffffffffu, reach ? static_cast<unsigned>(min(ke - c0, cn)) : 0u));
    if (lane == 0) {
      s_act[2 * warp] = jlo;
      s_act[2 * warp + 1] = jhi;
    }
    for (int j = jlo + sub; j < jhi; j += LPR) {
      const int p = c0 + j;
      float r = 0.0f, dl = 0.0f;
      int packed = 0;
      if (row_ok && p >= ks && p < ke && s_xk[j * 4 + 3] != 0.0f &&
          (K.skey == nullptr || s_skey[j] != skey)) {
        float kc[D];
        float l = 0.0f, gv = 0.0f;
#pragma unroll
        for (int c = 0; c < D; c += 4) {
          float vc[4];
          lds4(s_k + j * S + c, kc + c);
          lds4(s_v + j * S + c, vc);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            l = fmaf(q[c + e], kc[c + e], l);
            gv = fmaf(g[c + e], vc[e], gv);
          }
        }
        if (tabs) {
          const float xq[3] = {xq0, xq1, xq2};
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            const int bn =
                table_bin<kSwin>(T, __fsub_rn(xq[ax], s_xk[j * 4 + ax]));
            const float2 pr = s_proj[t * ps + ax * nb + bn];
            float kt;
            if constexpr (kSwin) {
              // k·Tk[bn] in phase 1's order of products
              kt = 0.0f;
#pragma unroll
              for (int c = 0; c < D; c += 4) {
                float tk[4];
                lds4(s_tab + (nb3 + ax * nb + bn) * S + c, tk);
#pragma unroll
                for (int e = 0; e < 4; ++e) kt = fmaf(kc[c + e], tk[e], kt);
              }
            } else {
              kt = s_kp[j * ps + ax * nb + bn];
            }
            l += pr.x + kt;
            gv += pr.y;
            packed |= bn << (8 * ax);
          }
        }
        r = expf(l - m) / den;
        dl = r * (gv - go);
#pragma unroll
        for (int c = 0; c < D; ++c) dq[c] = fmaf(dl, kc[c], dq[c]);
      }
      s_dl[t * (C + 1) + j] = dl;
      s_r[t * (C + 1) + j] = r;
      s_bin[t * (C + 1) + j] = packed;
    }
    __syncwarp();
    // the row masses: lane ax of the row walks the keys in order, 8 keys'
    // dl, r and bins loaded ahead of their adds
    if (tabs && sub < 3 && row_ok) {
      MassWalk<float2> walk(s_mass + t * ps + sub * nb);
      for (int j0 = jlo; j0 < jhi; j0 += 8) {
        float dl[8], r[8];
        int bn[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = min(j0 + u, jhi - 1);
          dl[u] = j0 + u < jhi ? s_dl[t * (C + 1) + j] : 0.0f;
          r[u] = j0 + u < jhi ? s_r[t * (C + 1) + j] : 0.0f;
          bn[u] = s_bin[t * (C + 1) + j];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (dl[u] != 0.0f || r[u] != 0.0f)
            walk.add((bn[u] >> (8 * sub)) & 255, make_float2(dl[u], r[u]));
      }
      walk.done();
    }
    __syncthreads();

    // ---- 3. key phase, rows in order: warps 0-3 sum dk = Σ dl (q + Σ_a
    //         Tk[b_a]) (the pair's three Tk rows) and dv
    //         = Σ r g (4 lanes per key, 4 channels each) and write them out
    //         to the tile's key slots; warps 4-7 the key's dl mass per bin
    //         (lane a < 3 of 4 per key: axis a, its masses zeroed first:
    //         they overwrite the key projections). A warp's rows are visited
    //         only for the keys they reached ----------------------------------
    const int kj = (tid & (NT / 2 - 1)) >> 2, kq = tid & 3;
    if (kj < cn && tid < NT / 2) {
      float dk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float dv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int w = 0; w < NW; ++w) {
        if (kj < s_act[2 * w] || kj >= s_act[2 * w + 1]) continue;
#pragma unroll
        for (int tt = w * RPW; tt < (w + 1) * RPW; ++tt) {
          const float dl = s_dl[tt * (C + 1) + kj];
          const float r = s_r[tt * (C + 1) + kj];
          float qc[4], gc[4];
          lds4(s_q + tt * S + kq * 4, qc);
          lds4(s_g + tt * S + kq * 4, gc);
          if (tabs) {
            // read even where dl is 0 (the product adds 0), so that the
            // rows' loads need no branch and go out together
            const int bins = s_bin[tt * (C + 1) + kj];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              float tk[4];
              lds4(s_tab + (nb3 + a * nb + ((bins >> (8 * a)) & 255)) * S +
                       kq * 4,
                   tk);
#pragma unroll
              for (int c = 0; c < 4; ++c) qc[c] += tk[c];
            }
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dk[c] = fmaf(dl, qc[c], dk[c]);
            dv[c] = fmaf(r, gc[c], dv[c]);
          }
        }
      }
      const size_t o = ((static_cast<size_t>(blk) * n_slots +
                         (c0 + kj - slot0)) * h + head) * D + kq * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        O.dk_part[o + c] = dk[c];
        O.dv_part[o + c] = dv[c];
      }
    } else if (kj < cn && tabs && kq < 3) {
      float* mk = s_kp + kj * ps + kq * nb;
      for (int a = 0; a < nb; ++a) mk[a] = 0.0f;
      MassWalk<float> walk(mk);
      for (int w = 0; w < NW; ++w) {
        if (kj < s_act[2 * w] || kj >= s_act[2 * w + 1]) continue;
        float dl[RPW];
        int bn[RPW];
#pragma unroll
        for (int u = 0; u < RPW; ++u) {
          dl[u] = s_dl[(w * RPW + u) * (C + 1) + kj];
          bn[u] = s_bin[(w * RPW + u) * (C + 1) + kj];
        }
#pragma unroll
        for (int u = 0; u < RPW; ++u)
          if (dl[u] != 0.0f) walk.add((bn[u] >> (8 * kq)) & 255, dl[u]);
      }
      walk.done();
    }
    __syncthreads();

    // ---- 4. the block's dTk += Mkᵀk ---------------------------------------
    // no barrier after it: the next chunk's first barrier orders these
    // reads of Mk and of this key buffer before their next writes
    if (tabs) {
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int i = tid + u * NT;
        if (i < nb3 * (D / 4)) {
          const int ab = i >> 2, c4 = (i & 3) * 4;
#pragma unroll 4
          for (int j = 0; j < cn; ++j) {
            const float mk = s_kp[j * ps + ab];
            float kc[4];
            lds4(s_k + j * S + c4, kc);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc_k[u][c] = fmaf(mk, kc[c], acc_k[u][c]);
          }
        }
      }
    }
  }

  // ---- end of block: dq += Mq·Tq; dTq = Mqᵀq, dTv = Mrᵀg --------------------
  // each lane adds the Tq term of every LPR-th bin row to its keys' part of
  // dq; the row's lanes then add their parts
  if (tabs) {
    for (int ab = sub; ab < nb3; ab += LPR) {
      const float mq = s_mass[t * ps + ab].x;
      float tq[D];
#pragma unroll
      for (int c = 0; c < D; c += 4) lds4(s_tab + ab * S + c, tq + c);
#pragma unroll
      for (int c = 0; c < D; ++c) dq[c] = fmaf(mq, tq[c], dq[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < D; ++c) dq[c] = group_sum<LPR>(dq[c]);
  if (sub == 0) {
#pragma unroll
    for (int c = 0; c < D; ++c) O.dq[ro * D + c] = dq[c] * scale;
  }
  if (!tabs) return;
  float* dst = O.dt_part + (static_cast<size_t>(blk) * h + head) * 3 * nb3 * D;
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int i = tid + u * NT;
    if (i < nb3 * (D / 4)) {
      const int ab = i >> 2, c4 = (i & 3) * 4;
      float sq[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int tt = 0; tt < R; ++tt) {
        const float2 mv = s_mass[tt * ps + ab];
        float qc[4], gc[4];
        lds4(s_q + tt * S + c4, qc);
        lds4(s_g + tt * S + c4, gc);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sq[c] = fmaf(mv.x, qc[c], sq[c]);
          sv[c] = fmaf(mv.y, gc[c], sv[c]);
        }
      }
      const int o = ab * D + c4;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (T.tq != nullptr) dst[o + c] = sq[c];
        if (T.tk != nullptr) dst[nb3 * D + o + c] = acc_k[u][c];
        if (T.tv != nullptr) dst[2 * nb3 * D + o + c] = sv[c];
      }
    }
  }
}

}  // namespace stratified
