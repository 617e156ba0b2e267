// The fast (bf16) form of the two stratified-attention backward kernels,
// on the tensor cores.
//
// Replaces, with the launchers of band_attention_bwd.cu and
// sparse_band_attention_bwd.cu, the Pallas TPU kernels _band_bwd_kernel and
// _sparse_bwd_kernel of
// stratified_transformer_tpu/ops/pallas/fused_attention_bwd.py at
// fast=True (:95, :474), the mode the shipped YAMLs select. It computes
// what attention_bwd_block (attention_bwd_common.cuh, which states the
// formulas and the projection form of the table terms) computes in fp32,
// rounded at the TPU kernel's sites: q (scaled in fp32, then rounded), k,
// v, g and the tables are bf16, staged so by the wrapper; dl, r and the bin
// masses Mq, Mr, Mk are rounded where they enter a product; g·o takes the
// fp32 g, and the cRPE lookups added to l and gv, r, dl and every sum stay
// fp32, as in the plain fast versions (ops/attention.py).
//
// What bounds it on the H100: bytes (PERF.md kernel table: 0.096 ms per
// S3DIS train step for the band half, 0.077 for the far-key half, with the
// products at the bf16 tensor-core peak). The bf16 routine it replaced ran
// every product on fp32 FMA from bf16 values unpacked one by one, so its
// table products (3·nb rows x 16 channels per key and per row) took most
// of a block's time and it ran 50-129x its bound. Here every product with
// bf16 operands is one mma.sync.m16n8k16 (or m16n8k8) per 16x8 tile with
// fp32 accumulators:
//   the pair logits Q·Kᵀ and G·Vᵀ, dq += dl·K, dk = dlᵀ·Q + Mk·Tk,
//   dv = rᵀ·G, the projections Q·Tqᵀ, G·Tvᵀ, K·Tkᵀ, dTk += Mkᵀ·K, and at
//   the end of the block dq += Mq·Tq, dTq = Mqᵀ·Q, dTv = Mrᵀ·G,
// with fragments read by ldmatrix from rows laid out without bank
// conflicts, and the key chunks (k, v, xyz and valid, skey) loaded by
// cp.async into a double buffer while the chunk before computes. The
// products over the table rows visit only the 16-row tiles of (axis, bin)
// that the block's pairs can reach: the bins are monotone in the relative
// position, so the bounding boxes of the block's rows and of its keys bound
// them; the masses elsewhere stay zero.
//
// Block: 256 threads for R rows of a 128-row tile and one head, key chunks
// of kTcChunk keys. Per chunk:
//   1. K·Tkᵀ into the key projections;
//   2. the pairs, 16 rows x 8 keys per warp and tile: Q·Kᵀ and G·Vᵀ on the
//      tensor cores, then per pair the bins, the three lookups per table,
//      r and dl; dq += dl·K; dl, r and the bins into shared memory;
//   3. the bin masses, scatters in a fixed order (no float atomics): one
//      lane per (row, axis) walks the chunk's keys in order into Mq, Mr;
//      one lane per (key, axis) walks the rows in order into Mk, which it
//      then rounds to bf16;
//   4. dk (warps 0-3) and dv (warps 4-7) out to the tile's key slots; warps
//      4-7 also add Mkᵀ·K into their dTk tiles, kept in registers.
// At the end of the block the warps' dq parts are added in warp order and
// the masses go through their products. Every sum runs in a fixed order,
// so the kernel is deterministic.
#pragma once

#include "attention_bwd_common.cuh"
#include "tensor_core.cuh"

namespace stratified {

constexpr int kTcChunk = 32;     // keys per round
constexpr int kTcThreads = 256;  // 8 warps

// Table rows per axis that a block of R rows is instantiated for: they size
// the dTk tiles that warps 4-7 keep in registers. Shared memory allows less
// for 64- and 32-row blocks (tc_max_nb on the H100: 48 and 91).
template <int R>
__host__ __device__ constexpr int tc_nb_cap() {
  return R >= 64 ? 64 : (R >= 32 ? 96 : 128);
}

// Query side of the fast form: bf16 q (scaled, then rounded) and g; the
// fp32 g, o, m and den; xyzv [N] as (x, y, z, valid); key ranges; skey or
// null.
struct TcQueries {
  const __nv_bfloat16* q;
  const __nv_bfloat16* g;
  const float* g32;
  const float* o;
  const float* m;
  const float* den;
  const float4* xyzv;
  const int32_t* key_lo;
  const int32_t* key_hi;
  const int32_t* skey;
};

// Key side: bf16 [K,H,D] k and v, xyzv [K], skey [K] or null.
struct TcKeys {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float4* xyzv;
  const int32_t* skey;
};

// ---- layout -----------------------------------------------------------------

// Shared-memory layout of a block of R rows (byte offsets, each 16-byte
// aligned). nb3 = 3·nb (axis, bin) rows, np = nb3 rounded up to 16 (the
// tables' and Mk's tiles), ps = nb3 + 1 (the odd stride of the fp32
// per-row arrays), mks = np + 8 (the bf16 mass rows: an odd number of 16
// bytes, so ldmatrix's 8 rows fall on distinct banks).
template <int R>
struct TcSmem {
  static constexpr int C = kTcChunk;
  // one key buffer: k and v rows (row16), xyzv, skey
  static constexpr int kKeyBuf = 2 * C * 32 + C * 16 + C * 4;
  int nb3, np, ps, mks;
  int tab, q, g, kb, proj, mass, kp, mk, pair, d16, total;

  __host__ __device__ static int up16(int x) { return (x + 15) & ~15; }
  __host__ __device__ explicit TcSmem(int nb)
      : nb3(3 * nb), np((3 * nb + 15) & ~15), ps(3 * nb + 1),
        mks(((3 * nb + 15) & ~15) + 8) {
    int o = 0;
    tab = o;  o += np * 32;                      // Tk (row16)
    q = o;    o += R * 32;                       // bf16 q, g (row16)
    g = o;    o += R * 32;
    kb = o;   o += 3 * kKeyBuf;                  // three key buffers
    // float2 (q·Tq, g·Tv) [R][ps]; at the end of the block the rounded
    // masses Mq, Mr [R][mks] bf16
    proj = o; o += up16(tc_max(R * ps * 8, 2 * R * mks * 2));
    mass = o; o += up16(R * ps * 8);             // float2 (Mq, Mr) [R][ps]
    // k·Tk, then Mk [C][ps]; before the first chunk Tq and Tv (row16) for
    // the rows' projections, after the last Tq for Mq·Tq
    kp = o;   o += up16(tc_max(C * ps * 4, 2 * np * 32));
    mk = o;   o += up16(C * mks * 2);            // Mk in bf16 [C][mks]
    // dl, r, bins [R][C + 1]; at the end of the block the warps' dq parts
    pair = o; o += up16(tc_max(3 * R * (C + 1) * 4, 8 * 16 * 16 * 4));
    d16 = o;  o += 2 * R * (C + 8) * 2;          // dl, r in bf16 [R][C + 8]
    total = o;
  }
  __host__ size_t bytes() const { return static_cast<size_t>(total); }
};

// The most table rows per axis (at most tc_nb_cap<R>) for which a block of
// R rows fits in `room` bytes.
template <int R>
__host__ int tc_max_nb(size_t room) {
  int nb = tc_nb_cap<R>();
  while (nb > 0 && TcSmem<R>(nb).bytes() > room) --nb;
  return nb;
}

// The backward of rows [row0, row0 + R), for the head blockIdx.y, over keys
// [win_lo, win_hi) ∩ the union of the rows' [key_lo, key_hi), in the fast
// form. The tile's n_slots key slots start at key slot0; blk indexes
// dk_part/dv_part and dt_part (BwdOutputs, as attention_bwd_block).
// kSwin: Swin3D's bins (table_bin).
template <int R, bool kSwin>
__device__ void attention_bwd_block_tc(const TcQueries& Q, const TcKeys& K,
                                       const TcTables& T, const BwdOutputs& O,
                                       int h, int blk, int row0, int win_lo,
                                       int win_hi, int slot0, int n_slots,
                                       float scale) {
  constexpr int D = 16;
  constexpr int NT = kTcThreads, NW = NT / 32, C = kTcChunk;
  constexpr int MT = R / 16;                  // 16-row tiles
  constexpr int KT = C / 8;                   // 8-key tiles of a chunk
  constexpr int NPT = MT * KT;                // pair tiles
  constexpr int TPW = NPT >= NW ? NPT / NW : 1;   // pair tiles per warp
  constexpr int NP_CAP = (3 * tc_nb_cap<R>() + 15) / 16 * 16;
  constexpr int NKU = (NP_CAP / 8 + 3) / 4;   // dTk tiles of warps 4-7
  static_assert(R % 16 == 0 && R <= 64 && (NPT < NW || NPT % NW == 0),
                "R in {16, 32, 64}");
  static_assert(NP_CAP / 16 <= 32, "touched tiles are a 32-bit mask");
  static_assert(tc_nb_cap<R>() <= 255, "bins are packed 8 bits per axis");

  extern __shared__ __align__(16) uint4 tc_smem[];
  __shared__ int s_lo, s_hi;
  __shared__ int s_rk[R][2];        // each row's key range, (0, 0) if none
  __shared__ int s_act[MT][2];      // per 16-row tile, the chunk keys reached
  __shared__ float s_rbox[NW][6], s_kbox[NW][6];

  const TcSmem<R> L(T.nb);
  const int nb = T.nb, nb3 = L.nb3, np = L.np, ps = L.ps, mks = L.mks;
  const int n16 = np / 16;
  const bool tabs = nb > 0;
  unsigned char* base = reinterpret_cast<unsigned char*>(tc_smem);
  const uint32_t sbase = smem_addr(base);
  const uint32_t a_tk = sbase + L.tab, a_q = sbase + L.q, a_g = sbase + L.g;
  const uint32_t a_tq = sbase + L.kp, a_tv = a_tq + np * 32;
  float2* s_proj = reinterpret_cast<float2*>(base + L.proj);
  float2* s_mass = reinterpret_cast<float2*>(base + L.mass);
  float* s_kp = reinterpret_cast<float*>(base + L.kp);
  __nv_bfloat16* s_mk = reinterpret_cast<__nv_bfloat16*>(base + L.mk);
  float* s_dl = reinterpret_cast<float*>(base + L.pair);
  float* s_r = s_dl + R * (C + 1);
  int* s_bin = reinterpret_cast<int*>(s_r + R * (C + 1));
  float* s_dqp = reinterpret_cast<float*>(base + L.pair);
  __nv_bfloat16* s_dl16 = reinterpret_cast<__nv_bfloat16*>(base + L.d16);
  __nv_bfloat16* s_r16 = s_dl16 + R * (C + 8);
  __nv_bfloat16* s_mq16 = reinterpret_cast<__nv_bfloat16*>(base + L.proj);
  __nv_bfloat16* s_mr16 = s_mq16 + R * mks;

  const int head = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tg = lane & 3;    // fragment row / column pair
  const float kInf = __int_as_float(0x7f800000);

  // half `half` of row ab of a table slice into row16 storage at `at`,
  // asynchronously (zeros past 3·nb and for an absent table)
  auto stage_table = [&](uint32_t at, const __nv_bfloat16* src, int ab,
                         int half) {
    const bool full = src != nullptr && ab < nb3;
    cp_async16(row16(at, ab, half),
               full ? static_cast<const void*>(
                          src + (static_cast<size_t>(head) * nb3 + ab) * D +
                          half * 8)
                    : static_cast<const void*>(Q.q),
               full);
  };

  // ---- the tables and the rows' q and g, asynchronously (group 1): Tk for
  //      the whole block, Tq and Tv in the key projections' place until the
  //      rows' projections are taken ----------------------------------------
  const __nv_bfloat16* tabs_in[3] = {T.tq, T.tk, T.tv};
  const uint32_t tab_at[3] = {a_tq, a_tk, a_tv};
  for (int i = tid; i < 3 * np * 2; i += NT) {
    const int tb = i / (2 * np), rest = i - tb * 2 * np;
    stage_table(tab_at[tb], tabs_in[tb], rest >> 1, rest & 1);
  }
  for (int i = tid; i < 4 * R; i += NT) {
    const int which = i / (2 * R), rest = i - which * 2 * R;
    const int t = rest >> 1, half = rest & 1;
    cp_async16(row16(which ? a_g : a_q, t, half),
               (which ? Q.g : Q.q) +
                   (static_cast<size_t>(row0 + t) * h + head) * D + half * 8,
               true);
  }
  cp_async_commit();

  // this warp's 16-row tile in the pair phase, and its lane's two rows
  const int pw_mt = (warp * TPW) / KT;
  const bool pw_on = warp * TPW < NPT;
  float rm[2], rden[2], rgo[2], rx[2][3];
  int rks[2], rke[2], rsk[2];
  bool rok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = pw_mt * 16 + g8 + 8 * i;
    const int row = row0 + (pw_on ? t : 0);
    const float4 x = Q.xyzv[row];
    rok[i] = pw_on && x.w != 0.0f;
    rx[i][0] = x.x;
    rx[i][1] = x.y;
    rx[i][2] = x.z;
    rks[i] = rok[i] ? Q.key_lo[row] : 0;
    rke[i] = rok[i] ? Q.key_hi[row] : 0;
    rsk[i] = Q.skey != nullptr ? Q.skey[row] : 0;
    const size_t ro = static_cast<size_t>(row) * h + head;
    float go = 0.0f;                          // g·o of the fp32 g
#pragma unroll
    for (int c = 4 * tg; c < 4 * tg + 4; ++c)
      go = fmaf(Q.g32[ro * D + c], Q.o[ro * D + c], go);
    rgo[i] = group_sum<4>(go);
    rm[i] = Q.m[ro];
    rden[i] = fmaxf(Q.den[ro], 1e-20f);
  }

  // ---- the rows' key ranges and the box of the rows that have keys --------
  if (tid == 0) {
    s_lo = win_hi;
    s_hi = win_lo;
  }
  __syncthreads();
  {
    float bx[6] = {kInf, kInf, kInf, -kInf, -kInf, -kInf};
    if (tid < R) {
      const int row = row0 + tid;
      const float4 x = Q.xyzv[row];
      const int ks = Q.key_lo[row], ke = Q.key_hi[row];
      const bool has = x.w != 0.0f && ke > ks;
      s_rk[tid][0] = has ? ks : 0;
      s_rk[tid][1] = has ? ke : 0;
      if (has) {
        atomicMin(&s_lo, ks);
        atomicMax(&s_hi, ke);
        bx[0] = bx[3] = x.x;
        bx[1] = bx[4] = x.y;
        bx[2] = bx[5] = x.z;
      }
    }
    warp_box(bx);
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < 6; ++i) s_rbox[warp][i] = bx[i];
  }
  // masses and Mk's bf16 rows start at zero (entries no pair reaches stay 0)
  for (int i = tid; i < R * ps / 2; i += NT)
    reinterpret_cast<uint4*>(s_mass)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < C * mks / 8; i += NT)
    reinterpret_cast<uint4*>(s_mk)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int lo = max(s_lo, win_lo);
  const int hi = min(s_hi, win_hi);

  // a chunk of keys into key buffer b, asynchronously (zero-filled past hi)
  auto stage_chunk = [&](int b, int c0) {
    const int cn = min(C, hi - c0);
    const uint32_t kb = sbase + L.kb + b * TcSmem<R>::kKeyBuf;
    for (int i = tid; i < 4 * C; i += NT) {
      const int j = i >> 2, which = (i >> 1) & 1, half = i & 1;
      const bool full = j < cn;
      cp_async16(row16(kb + which * C * 32, j, half),
                 (which ? K.v : K.k) +
                     (static_cast<size_t>(c0 + (full ? j : 0)) * h + head) *
                         D + half * 8,
                 full);
    }
    if (tid < C) {
      cp_async16(kb + 2 * C * 32 + tid * 16, K.xyzv + c0 + (tid < cn ? tid : 0),
                 tid < cn);
    } else if (tid < 2 * C && K.skey != nullptr) {
      const int j = tid - C;
      cp_async4(kb + 2 * C * 32 + C * 16 + j * 4,
                K.skey + c0 + (j < cn ? j : 0), j < cn);
    }
  };
  if (lo < hi) stage_chunk(0, lo);
  cp_async_commit();                          // group 2: the first chunk
  if (lo + C < hi) stage_chunk(1, lo + C);
  cp_async_commit();                          // group 3: the second

  // the box of the window's valid keys
  {
    float bx[6] = {kInf, kInf, kInf, -kInf, -kInf, -kInf};
    for (int p = lo + tid; p < hi; p += NT) {
      const float4 x = K.xyzv[p];
      if (x.w != 0.0f) {
        bx[0] = fminf(bx[0], x.x);
        bx[1] = fminf(bx[1], x.y);
        bx[2] = fminf(bx[2], x.z);
        bx[3] = fmaxf(bx[3], x.x);
        bx[4] = fmaxf(bx[4], x.y);
        bx[5] = fmaxf(bx[5], x.z);
      }
    }
    warp_box(bx);
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < 6; ++i) s_kbox[warp][i] = bx[i];
  }

  cp_async_wait<2>();                         // group 1 has landed
  __syncthreads();

  // ---- the bins any pair can take: per axis, the bins of the extreme
  //      relative positions of the two boxes (the bins are monotone in the
  //      relative position), as a mask of 16-row (axis, bin) tiles --------
  int blo[3] = {0, 0, 0}, bhi[3] = {-1, -1, -1};
  uint32_t tmask = 0u;
  if (tabs && lo < hi) {
    float bx[6] = {kInf, kInf, kInf, -kInf, -kInf, -kInf};
    float kx[6] = {kInf, kInf, kInf, -kInf, -kInf, -kInf};
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        bx[i] = i < 3 ? fminf(bx[i], s_rbox[w][i]) : fmaxf(bx[i], s_rbox[w][i]);
        kx[i] = i < 3 ? fminf(kx[i], s_kbox[w][i]) : fmaxf(kx[i], s_kbox[w][i]);
      }
    if (bx[0] <= bx[3] && kx[0] <= kx[3]) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        blo[ax] = table_bin<kSwin>(T, __fsub_rn(bx[ax], kx[ax + 3]));
        bhi[ax] = table_bin<kSwin>(T, __fsub_rn(bx[ax + 3], kx[ax]));
        for (int t16 = (ax * nb + blo[ax]) >> 4;
             t16 <= (ax * nb + bhi[ax]) >> 4; ++t16)
          tmask |= 1u << t16;
      }
    }
  }

  // ---- the rows' projections onto Tq and Tv: warps share the 8-column
  //      tiles; a warp loads a tile's B fragments once and takes every
  //      16-row tile of q and g --------------------------------------------
  if (tabs) {
    for (int u = warp; u < 2 * n16; u += NW) {
      if (!((tmask >> (u >> 1)) & 1u)) continue;
      const int n0 = u * 8, c = n0 + 2 * tg;
      uint32_t bq[2], bv[2];
      ldsm_x2(bq, row16(a_tq, n0 + (lane & 7), (lane >> 3) & 1));
      ldsm_x2(bv, row16(a_tv, n0 + (lane & 7), (lane >> 3) & 1));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t aq[4], ag[4];
        ldsm_x4(aq, row16(a_q, mt * 16 + (lane & 15), lane >> 4));
        ldsm_x4(ag, row16(a_g, mt * 16 + (lane & 15), lane >> 4));
        float pq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float pg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16_16816(pq, aq, bq);
        mma_bf16_16816(pg, ag, bv);
        float2* o0 = s_proj + (mt * 16 + g8) * ps + c;
        float2* o1 = o0 + 8 * ps;
        if (c < nb3) {
          o0[0] = make_float2(pq[0], pg[0]);
          o1[0] = make_float2(pq[2], pg[2]);
        }
        if (c + 1 < nb3) {
          o0[1] = make_float2(pq[1], pg[1]);
          o1[1] = make_float2(pq[3], pg[3]);
        }
      }
    }
  }

  // the pair phase's A fragments: this warp's 16 rows of q and g
  uint32_t qa[4], ga[4];
  ldsm_x4(qa, row16(a_q, pw_mt * 16 + (lane & 15), lane >> 4));
  ldsm_x4(ga, row16(a_g, pw_mt * 16 + (lane & 15), lane >> 4));
  float dq[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
  float acc_k[NKU][4];                        // dTk tiles of warps 4-7
#pragma unroll
  for (int u = 0; u < NKU; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[u][c] = 0.0f;

  // ---- 1. a chunk's keys (key buffer b) projected onto Tk: warps share
  //         the 8-column tiles, as the rows' projections --------------------
  auto key_projections = [&](int b) {
    const uint32_t a_k = sbase + L.kb + b * TcSmem<R>::kKeyBuf;
    for (int u = warp; u < 2 * n16; u += NW) {
      if (!((tmask >> (u >> 1)) & 1u)) continue;
      const int n0 = u * 8, c = n0 + 2 * tg;
      uint32_t bk[2];
      ldsm_x2(bk, row16(a_tk, n0 + (lane & 7), (lane >> 3) & 1));
#pragma unroll
      for (int mt = 0; mt < C / 16; ++mt) {
        uint32_t ak[4];
        ldsm_x4(ak, row16(a_k, mt * 16 + (lane & 15), lane >> 4));
        float pk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16_16816(pk, ak, bk);
        float* o0 = s_kp + (mt * 16 + g8) * ps + c;
        float* o1 = o0 + 8 * ps;
        if (c < nb3) {
          o0[0] = pk[0];
          o1[0] = pk[2];
        }
        if (c + 1 < nb3) {
          o0[1] = pk[1];
          o1[1] = pk[3];
        }
      }
    }
  };
  // the first chunk's (the rows' projections are done with Tq and Tv)
  cp_async_wait<1>();
  __syncthreads();
  if (tabs && lo < hi) key_projections(0);

  // Per chunk three barriers: (A) the chunk's key projections and keys are
  // in shared memory and the last chunk's products are done; (B) the
  // pairs are; (C) the masses and the next chunk's keys are. Phase 4 of a
  // chunk and phase 1 of the next run together. Three key buffers: the
  // chunk's, the next one's (loaded since the last chunk began) and the
  // one after, which starts loading now.
  int buf = 0;
  for (int c0 = lo; c0 < hi; c0 += C, buf = buf == 2 ? 0 : buf + 1) {
    const int cn = min(C, hi - c0);
    const int next = buf == 2 ? 0 : buf + 1;
    __syncthreads();                          // (A)
    if (c0 + 2 * C < hi) stage_chunk(next == 2 ? 0 : next + 1, c0 + 2 * C);
    cp_async_commit();
    const uint32_t a_k = sbase + L.kb + buf * TcSmem<R>::kKeyBuf;
    const uint32_t a_v = a_k + C * 32;
    const float4* s_xk = reinterpret_cast<const float4*>(
        base + L.kb + buf * TcSmem<R>::kKeyBuf + 2 * C * 32);
    const int* s_skey = reinterpret_cast<const int*>(s_xk + C);

    // ---- 2. pairs: 16 rows x 8 keys per tile --------------------------------
    if (pw_on) {
      // the chunk's keys that the tile's rows reach (warp-uniform)
      bool reach[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        reach[i] = rok[i] && rks[i] < c0 + cn && rke[i] > c0;
      unsigned jl = C, jh = 0u;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (reach[i]) {
          jl = min(jl, static_cast<unsigned>(max(rks[i] - c0, 0)));
          jh = max(jh, static_cast<unsigned>(min(rke[i] - c0, cn)));
        }
      const int jlo = static_cast<int>(__reduce_min_sync(0xffffffffu, jl));
      const int jhi = static_cast<int>(__reduce_max_sync(0xffffffffu, jh));
      if (lane == 0 && (warp * TPW) % KT == 0) {
        s_act[pw_mt][0] = jlo;
        s_act[pw_mt][1] = jhi;
      }
#pragma unroll
      for (int u = 0; u < TPW; ++u) {
        const int key0 = ((warp * TPW + u) % KT) * 8;
        const int t0 = pw_mt * 16 + g8;       // this lane's rows t0, t0 + 8
        uint32_t dlp[2] = {0u, 0u}, rp[2] = {0u, 0u};
        if (jlo < key0 + 8 && jhi > key0) {
          const uint32_t ka = row16(a_k, key0 + (lane & 7), (lane >> 3) & 1);
          uint32_t bk[2], bv[2], bkt[2];
          ldsm_x2(bk, ka);
          ldsm_x2(bv, row16(a_v, key0 + (lane & 7), (lane >> 3) & 1));
          ldsm_x2_trans(bkt, ka);
          float l4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          float gv4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16_16816(l4, qa, bk);
          mma_bf16_16816(gv4, ga, bv);
          // the lane's four pairs: rows t0 + 8i, keys key0 + 2tg + (e & 1)
          // (all four computed before any is stored, so that their loads
          // are in flight together)
          float dl4[4], r4[4];
          int bin4[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, j = key0 + 2 * tg + (e & 1), p = c0 + j;
            const int t = t0 + 8 * i;
            const float4 xk = s_xk[j];
            float l = l4[e], gv = gv4[e], r = 0.0f, dl = 0.0f;
            int packed = 0;
            if (rok[i] && p >= rks[i] && p < rke[i] && xk.w != 0.0f &&
                (K.skey == nullptr || s_skey[j] != rsk[i])) {
              if (tabs) {
                const float xkk[3] = {xk.x, xk.y, xk.z};
#pragma unroll
                for (int ax = 0; ax < 3; ++ax) {
                  const int bn =
                      table_bin<kSwin>(T, __fsub_rn(rx[i][ax], xkk[ax]));
                  const float2 pr = s_proj[t * ps + ax * nb + bn];
                  l += pr.x + s_kp[j * ps + ax * nb + bn];
                  gv += pr.y;
                  packed |= bn << (8 * ax);
                }
              }
              r = expf(l - rm[i]) / rden[i];
              dl = r * (gv - rgo[i]);
            }
            dl4[e] = dl;
            r4[e] = r;
            bin4[e] = packed;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = (t0 + 8 * (e >> 1)) * (C + 1) + key0 + 2 * tg +
                          (e & 1);
            s_dl[o] = dl4[e];
            s_r[o] = r4[e];
            s_bin[o] = bin4[e];
          }
          dlp[0] = pack_bf16(dl4[0], dl4[1]);
          dlp[1] = pack_bf16(dl4[2], dl4[3]);
          rp[0] = pack_bf16(r4[0], r4[1]);
          rp[1] = pack_bf16(r4[2], r4[3]);
          // dq += dl·K over the tile's 8 keys, channels 0-7 and 8-15
          mma_bf16_1688(dq[0], dlp, bkt[0]);
          mma_bf16_1688(dq[1], dlp, bkt[1]);
        }
        const int jw = key0 + 2 * tg;
        *reinterpret_cast<uint32_t*>(s_dl16 + t0 * (C + 8) + jw) = dlp[0];
        *reinterpret_cast<uint32_t*>(s_dl16 + (t0 + 8) * (C + 8) + jw) =
            dlp[1];
        *reinterpret_cast<uint32_t*>(s_r16 + t0 * (C + 8) + jw) = rp[0];
        *reinterpret_cast<uint32_t*>(s_r16 + (t0 + 8) * (C + 8) + jw) = rp[1];
      }
    }
    __syncthreads();

    // ---- 3. the bin masses, scatters in a fixed order: lanes NT - 3C on,
    //         one per (key, axis), walk the rows in order into Mk (over the
    //         bins pairs can take), then round it; the other lanes, one per
    //         (row, axis) and two per lane at 64 rows, walk the chunk's keys
    //         in order into Mq, Mr. A walk reads its entries 8 or 16 at a
    //         time (MassWalk) -----------------------------------------------
    if (tabs && tid >= NT - 3 * C) {
      const int kj = (tid - (NT - 3 * C)) / 3;
      const int ax = tid - (NT - 3 * C) - 3 * kj;
      float* mk = s_kp + kj * ps + ax * nb;
      for (int b = blo[ax]; b <= bhi[ax]; ++b) mk[b] = 0.0f;
      MassWalk<float> walk(mk);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (kj < s_act[mt][0] || kj >= s_act[mt][1]) continue;
        float dl[16];
        int bn[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          dl[u] = s_dl[(mt * 16 + u) * (C + 1) + kj];
          bn[u] = s_bin[(mt * 16 + u) * (C + 1) + kj];
        }
#pragma unroll
        for (int u = 0; u < 16; ++u)
          if (dl[u] != 0.0f) walk.add((bn[u] >> (8 * ax)) & 255, dl[u]);
      }
      walk.done();
      __nv_bfloat16* m16 = s_mk + kj * mks + ax * nb;
      for (int b = blo[ax]; b <= bhi[ax]; ++b)
        m16[b] = __float2bfloat16_rn(mk[b]);
    } else if (tabs) {
      for (int wk = tid; wk < 3 * R; wk += NT - 3 * C) {
        const int t = wk / 3, ax = wk - 3 * t;
        const int j0 = max(s_rk[t][0] - c0, 0);
        const int j1 = min(s_rk[t][1] - c0, cn);
        const float* pdl = s_dl + t * (C + 1);
        const float* pr = s_r + t * (C + 1);
        const int* pbin = s_bin + t * (C + 1);
        MassWalk<float2> walk(s_mass + t * ps + ax * nb);
        for (int j = j0; j < j1; j += 8) {
          float dl[8], r[8];
          int bn[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            dl[u] = r[u] = 0.0f;
            bn[u] = 0;
            if (j + u < j1) {
              dl[u] = pdl[j + u];
              r[u] = pr[j + u];
              bn[u] = pbin[j + u];
            }
          }
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (dl[u] != 0.0f || r[u] != 0.0f)
              walk.add((bn[u] >> (8 * ax)) & 255, make_float2(dl[u], r[u]));
        }
        walk.done();
      }
    }
    cp_async_wait<1>();                       // the next chunk has landed
    __syncthreads();                          // (C)

    // ---- 4. dk = dlᵀ·q + Mk·Tk (warps 0-3), dv = rᵀ·g (warps 4-7), one
    //         16-key x 8-channel tile each, out to the tile's key slots;
    //         warps 4-7 add Mkᵀ·k into their dTk tiles; then the next
    //         chunk's phase 1 (Mk's fp32 sums are dead) -------------------
    {
      const int w4 = warp & 3, km = w4 >> 1, nh = w4 & 1;
      const bool is_dk = warp < 4;
      const __nv_bfloat16* s_a = is_dk ? s_dl16 : s_r16;
      // two accumulators, the k-steps alternating between them, so that
      // two chains of dependent mma are in flight
      float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int k0 = 0; k0 < R; k0 += 16) {
        uint32_t a[4], b[2];
        ldsm_x4_trans(a, smem_addr(s_a + (k0 + (lane & 7) + ((lane >> 4) << 3))
                                            * (C + 8) +
                                   km * 16 + (((lane >> 3) & 1) << 3)));
        ldsm_x2_trans(b, row16(is_dk ? a_q : a_g, k0 + (lane & 15), nh));
        mma_bf16_16816(acc[(k0 >> 4) & 1], a, b);
      }
      if (is_dk && tabs) {
#pragma unroll
        for (int t16 = 0; t16 < NP_CAP / 16; ++t16) {
          if (t16 >= n16 || !((tmask >> t16) & 1u)) continue;
          uint32_t a[4], b[2];
          ldsm_x4(a, smem_addr(s_mk + (km * 16 + (lane & 15)) * mks +
                               t16 * 16 + ((lane >> 4) << 3)));
          ldsm_x2_trans(b, row16(a_tk, t16 * 16 + (lane & 15), nh));
          mma_bf16_16816(acc[t16 & 1], a, b);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[0][c] += acc[1][c];
      float* part = is_dk ? O.dk_part : O.dv_part;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = km * 16 + g8 + 8 * i;
        if (j < cn) {
          const size_t o = ((static_cast<size_t>(blk) * n_slots +
                             (c0 + j - slot0)) * h + head) * D + nh * 8 +
                           2 * tg;
          *reinterpret_cast<float2*>(part + o) =
              make_float2(acc[0][2 * i], acc[0][2 * i + 1]);
        }
      }
      if (!is_dk && tabs) {
#pragma unroll
        for (int u = 0; u < NKU; ++u) {
          const int unit = w4 + 4 * u, at = unit >> 1, uh = unit & 1;
          if (at >= n16 || !((tmask >> at) & 1u)) continue;
#pragma unroll
          for (int k0 = 0; k0 < C; k0 += 16) {
            uint32_t a[4], b[2];
            ldsm_x4_trans(a, smem_addr(
                                 s_mk + (k0 + (lane & 7) + ((lane >> 4) << 3))
                                            * mks +
                                 at * 16 + (((lane >> 3) & 1) << 3)));
            ldsm_x2_trans(b, row16(a_k, k0 + (lane & 15), uh));
            mma_bf16_16816(acc_k[u], a, b);
          }
        }
      }
    }
    if (tabs && c0 + C < hi) key_projections(next);
    // after the last chunk, Tq again in the key projections' place, for
    // Mq·Tq at the end of the block
    if (tabs && c0 + C >= hi)
      for (int i = tid; i < 2 * np; i += NT)
        stage_table(a_tq, T.tq, i >> 1, i & 1);
  }
  cp_async_commit();

  // ---- end of block: dq = Σ parts + Mq·Tq; dTq = Mqᵀ·q, dTv = Mrᵀ·g ------
  if (pw_on) {
    float* part = s_dqp + warp * 256;
#pragma unroll
    for (int nh = 0; nh < 2; ++nh) {
      part[g8 * 16 + nh * 8 + 2 * tg] = dq[nh][0];
      part[g8 * 16 + nh * 8 + 2 * tg + 1] = dq[nh][1];
      part[(g8 + 8) * 16 + nh * 8 + 2 * tg] = dq[nh][2];
      part[(g8 + 8) * 16 + nh * 8 + 2 * tg + 1] = dq[nh][3];
    }
  }
  if (tabs) {                                 // the masses rounded to bf16
    for (int t = 0; t < R; ++t)
      for (int ab = tid; ab < np; ab += NT) {
        if (!((tmask >> (ab >> 4)) & 1u)) continue;
        const float2 mv =
            ab < nb3 ? s_mass[t * ps + ab] : make_float2(0.0f, 0.0f);
        s_mq16[t * mks + ab] = __float2bfloat16_rn(mv.x);
        s_mr16[t * mks + ab] = __float2bfloat16_rn(mv.y);
      }
  }
  cp_async_wait<0>();                         // Tq (if a chunk ran)
  __syncthreads();
  if (warp < R / 8) {
    const int mt = warp >> 1, nh = warp & 1;
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    if (tabs) {                               // two chains of mma, as in 4.
#pragma unroll
      for (int t16 = 0; t16 < NP_CAP / 16; ++t16) {
        if (t16 >= n16 || !((tmask >> t16) & 1u)) continue;
        uint32_t a[4], b[2];
        ldsm_x4(a, smem_addr(s_mq16 + (mt * 16 + (lane & 15)) * mks +
                             t16 * 16 + ((lane >> 4) << 3)));
        ldsm_x2_trans(b, row16(a_tq, t16 * 16 + (lane & 15), nh));
        mma_bf16_16816(acc[t16 & 1], a, b);
      }
    }
    // then the pair phase's parts of the warps that took this 16-row
    // tile, in warp order
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[0][c] += acc[1][c];
    for (int w = 0; w < NW; ++w) {
      if (w * TPW >= NPT || (w * TPW) / KT != mt) continue;
      const float* part = s_dqp + w * 256 + nh * 8 + 2 * tg;
      acc[0][0] += part[g8 * 16];
      acc[0][1] += part[g8 * 16 + 1];
      acc[0][2] += part[(g8 + 8) * 16];
      acc[0][3] += part[(g8 + 8) * 16 + 1];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t o = (static_cast<size_t>(row0 + mt * 16 + g8 + 8 * i) * h +
                        head) * D + nh * 8 + 2 * tg;
      *reinterpret_cast<float2*>(O.dq + o) =
          make_float2(acc[0][2 * i] * scale, acc[0][2 * i + 1] * scale);
    }
  }
  if (!tabs) return;
  float* dst = O.dt_part + (static_cast<size_t>(blk) * h + head) * 3 * nb3 * D;
  // dTq (table 0) and dTv (table 2), one 16-row x 8-channel tile per unit
  for (int u = warp; u < 4 * n16; u += NW) {
    const int tb = u / (2 * n16), at = (u >> 1) - tb * n16, nh = u & 1;
    if (tabs_in[2 * tb] == nullptr) continue;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if ((tmask >> at) & 1u) {
      const __nv_bfloat16* ms = tb ? s_mr16 : s_mq16;
#pragma unroll
      for (int k0 = 0; k0 < R; k0 += 16) {
        uint32_t a[4], b[2];
        ldsm_x4_trans(a, smem_addr(ms + (k0 + (lane & 7) + ((lane >> 4) << 3))
                                            * mks +
                                   at * 16 + (((lane >> 3) & 1) << 3)));
        ldsm_x2_trans(b, row16(tb ? a_g : a_q, k0 + (lane & 15), nh));
        mma_bf16_16816(acc, a, b);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ab = at * 16 + g8 + 8 * i;
      if (ab < nb3)
        *reinterpret_cast<float2*>(dst + (2 * tb * nb3 + ab) * D + nh * 8 +
                                   2 * tg) =
            make_float2(acc[2 * i], acc[2 * i + 1]);
    }
  }
  // dTk (table 1) from the registers of warps 4-7
  if (warp >= 4 && T.tk != nullptr) {
#pragma unroll
    for (int u = 0; u < NKU; ++u) {
      const int unit = (warp & 3) + 4 * u, at = unit >> 1, uh = unit & 1;
      if (at >= n16) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ab = at * 16 + g8 + 8 * i;
        if (ab < nb3)
          *reinterpret_cast<float2*>(dst + (nb3 + ab) * D + uh * 8 + 2 * tg) =
              make_float2(acc_k[u][2 * i], acc_k[u][2 * i + 1]);
      }
    }
  }
}

}  // namespace stratified
