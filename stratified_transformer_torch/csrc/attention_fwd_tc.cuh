// The fast (bf16) form of the two stratified-attention forward kernels, on
// the tensor cores.
//
// Replaces, with the launchers of band_attention.cu and
// sparse_band_attention.cu, the Pallas TPU kernels _band_kernel and
// _sparse_kernel of stratified_transformer_tpu/ops/pallas/fused_attention.py
// at fast=True (:86, :303), the mode the shipped YAMLs select. It computes
// what the plain fast versions (ops/attention.py) compute, at the same
// rounding sites: q (scaled in fp32, then rounded), k, v and the
// tables are bf16, rounded so where the block stages them; p is rounded
// where it multiplies v, at the row's running maximum as of the end of its
// 32-key chunk (chunks counted from the window's first key, as the TPU
// kernel's w_chunk chunks and the plain fast versions' FAST_CHUNK); den and
// the bin masses sum the fp32 p; each mass is rounded once where it
// multiplies Tv; the logits, the cRPE lookups and every sum stay fp32.
// Masked logits never enter the softmax, and a row with no key gets m =
// -1e30, den = 0, acc = 0. Only the order of the fp32 sums differs.
//
// Both halves take the table terms in the projection form, as the TPU
// kernel does in both (fused_attention.py:117-132 and 340-347 for q·Tq,
// 177-186 and 392-397 for k·Tk, 240-244 and 451-456 for mass·Tv): each
// row's q is projected onto the 3·nb (axis, bin) rows of Tq once per block
// and each key of a chunk onto those of Tk once per chunk, so that a pair
// adds two looked-up numbers per axis; Tv enters through the rows' bin
// masses as Σ mass·Tv at the end of the block.
//
// What bounds it on the H100: bytes (PERF.md kernel table). The fast mode
// of the fp32 routine that it replaced ran q·k and p·v on fp32 FMA from
// bf16 values unpacked one by one and walked the bin masses with 32-step
// shuffle loops.
// Here every product with bf16 operands is an mma.sync.m16n8k16 with fp32
// accumulators:
//   Q·Kᵀ and P·V per chunk (p rounded to bf16 in registers, the C fragment
//   of the logits becoming the A fragment of P·V), the projections Q·Tqᵀ
//   (per block) and K·Tkᵀ (per chunk), and Σ mass·Tv at the end,
// with fragments read by ldmatrix from bf16 rows laid out without bank
// conflicts. The block stages its own operands from the fp32 tensors the
// model passes (the wrapper makes no copies: bf16 copies made by PyTorch
// ops cost more device time than the kernel saved, PERF.md §6): q and
// the tables Tq, Tk, Tv once per block, and each key chunk (k, v, the
// points, skey) from registers loaded while the chunk before it computes,
// into one of two buffers; every warp takes the block's key range from the
// rows' records itself, so the first chunk's loads start at once. The products over the table rows visit
// only the 16-row tiles of (axis, bin) that the block's pairs can reach:
// the bins are monotone in the relative position, so the bounding boxes of
// the block's rows and of its keys bound them (and where those bounds need
// no clip, the pairs' bins skip theirs).
//
// Block: 256 threads for 64 rows of a 128-row tile and one head; warp w
// owns 8 rows, half h = w / 4 of the 16-row tile w % 4, over the whole
// window (its lanes' rows in the C fragments; the tile's Q·Kᵀ is
// computed by both of its warps, each keeping its own rows). Per 32-key
// chunk:
//   A. the chunk's keys are staged; K·Tkᵀ into the key projections;
//   B. pass 1: Q·Kᵀ on the tensor cores, then per pair of the warp's rows
//      the mask, the bins and the six lookups (8-key tiles that none of
//      the warp's rows reaches are skipped);
//   C. the row's chunk maximum (quad shuffles); acc and den rescaled once
//      (the row's masses only when the maximum has grown by more than
//      kMassSpan since they last were: they sum p · exp(m - mref) and are
//      scaled to the final maximum at the end); p = exp(l - m); den += p;
//      acc += P·V on the tensor cores (the other rows of the A fragment
//      zero);
//   D. the bin masses, scatters in a fixed order (no float atomics): lane
//      tg < 3 of the row's four adds each of the chunk's keys in order into
//      its bin of axis tg, their p and bins by quad shuffles;
//   then the next chunk's keys go from registers to their buffer and the
//   one after that is loaded.
// One barrier before the chunks and two per chunk (the staged keys, the
// key projections); the rows are the warp's own from start to end, so the
// end of the block needs none. Each mma starts from zero and covers one
// 16-long step (16 keys, 16 channels, or 16 (axis, bin) rows); the sums
// across steps are fp32 adds (an mma's accumulator carried across steps
// rounded differently: PERF.md §6). acc sums the chunks' first and
// second 16 keys in two accumulators and mass·Tv in a third, added at the
// end of the block, and den likewise; every sum runs in a fixed order, so
// the kernel is deterministic.
#pragma once

#include <type_traits>

#include "attention_fwd_common.cuh"
#include "tensor_core.cuh"

namespace stratified {

constexpr int kFtRows = 64;            // rows per block
constexpr int kFtThreads = 256;        // a quarter of a q row each
constexpr int kFtMaxNb = 170;          // 3·nb tiles of 16 in a 32-bit mask
// how far (in logits) a row's running maximum may pass its masses'
// reference before they are rescaled (attention_fwd_block_tc)
constexpr float kMassSpan = 16.0f;

// Shared-memory layout of a block (byte offsets, each 16-byte aligned). nb3 = 3·nb (axis, bin) rows, np = nb3 rounded up to 16 (the
// tables' tiles), ps = np + 8, the stride of the fp32 per-row arrays: a
// tile's columns stay inside a row, and a half warp's 8-byte accesses to
// rows g .. g + 3 at column pairs 2 tg fall on distinct banks.
struct FtSmem {
  static constexpr int R = kFtRows;
  static constexpr int C = kFwdChunk;
  // one key buffer: k and v rows (row16), (x, y, z, valid), skey
  static constexpr int kKeyBuf = 2 * C * 32 + C * 16 + C * 4;
  int nb3, np, ps;
  int tk, tv, q, kb, qp, mass, kp, total;

  __host__ __device__ explicit FtSmem(int nb)
      : nb3(3 * nb), np((3 * nb + 15) & ~15), ps(((3 * nb + 15) & ~15) + 8) {
    int o = 0;
    tk = o;   o += np * 32;                        // Tk, Tv (row16)
    tv = o;   o += np * 32;
    q = o;    o += R * 32;                         // bf16 q (row16)
    kb = o;   o += 2 * kKeyBuf;                    // two key buffers
    qp = o;   o += R * ps * 4;                     // q·Tq [R][ps]
    mass = o; o += R * ps * 4;                     // Σ p per (axis, bin)
    // k·Tk [C][ps]; before the first chunk Tq (row16)
    kp = o;   o += C * ps * 4;
    total = o;
  }
  __host__ size_t bytes() const { return static_cast<size_t>(total); }
};

// The most table rows per axis (at most kFtMaxNb) for which a block fits
// in `room` bytes.
__host__ inline int ft_max_nb(size_t room) {
  int nb = kFtMaxNb;
  while (nb > 0 && FtSmem(nb).bytes() > room) --nb;
  return nb;
}

// Rows of `rs` floats from p that a float4 reads whole (16-byte aligned).
__host__ inline bool rows16(const float* p, int rs) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && rs % 4 == 0;
}

// Offset of half `half` of bf16 row `row` in row16 storage (row16 of a
// base of 0).
__device__ __forceinline__ int row16_off(int row, int half) {
  return static_cast<int>(row16(0u, row, half));
}

// The bin of one axis before its clips, as a float: rel_bin's floor (the
// bin in the full table) or swin_bin's sum. Where it lies in
// [max(0, bin_lo), min(nb_full, bin_lo + nb)) (`unclipped`), the bin in the
// slice is it less bin_lo.
template <bool kSwin>
__device__ __forceinline__ float raw_bin(const FwdTables& T, float rel) {
  if constexpr (kSwin) {
    return __fadd_rn(rintf(rel), static_cast<float>((T.nb_full + 1) / 2 - 1));
  } else {
    const float r = __fmul_rn(rintf(__fmul_rn(rel, 1e5f)), 1e-5f);
    return floorf(__fmul_rn(__fadd_rn(r, T.bin_offset), T.inv_quant));
  }
}

__device__ __forceinline__ bool unclipped(const FwdTables& T, float f) {
  return f >= static_cast<float>(max(0, T.bin_lo)) &&
         f < static_cast<float>(min(T.nb_full, T.bin_lo + T.nb));
}

// Table bin b of the head in the model's [nb_full][H][D][3] layout (the
// rows [bin_lo, bin_lo + nb)), rounded to bf16, into the three (axis, bin)
// rows a·nb + b of row16 storage at `dst` (zeros for an absent table). Its
// 12 float4 loads are issued together (attention_fwd_common.cuh: a bin's
// 3·D floats hold all three axes).
__device__ __forceinline__ void stage_table_bin(unsigned char* dst,
                                                const FwdTables& T,
                                                const float* t, int h,
                                                int head, int b) {
  constexpr int D = 16;
  float e[3 * D];
  if (t != nullptr) {
    const float4* src = table_row<D>(t, T.bin_lo + b, h, head);
#pragma unroll
    for (int f = 0; f < 3 * D / 4; ++f) {
      const float4 x = __ldg(src + f);
      e[4 * f] = x.x;
      e[4 * f + 1] = x.y;
      e[4 * f + 2] = x.z;
      e[4 * f + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int f = 0; f < 3 * D; ++f) e[f] = 0.0f;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint4 w;                          // channel c of axis a: e[3 c + a]
      const int c = 8 * half;
      w.x = pack_bf16(e[3 * c + a], e[3 * (c + 1) + a]);
      w.y = pack_bf16(e[3 * (c + 2) + a], e[3 * (c + 3) + a]);
      w.z = pack_bf16(e[3 * (c + 4) + a], e[3 * (c + 5) + a]);
      w.w = pack_bf16(e[3 * (c + 6) + a], e[3 * (c + 7) + a]);
      *reinterpret_cast<uint4*>(dst + row16_off(a * T.nb + b, half)) = w;
    }
}

// The rows nb3 .. np - 1 of the three tables' row16 storage at base + a0,
// a1, a2 zeroed, by the block's NT threads.
template <int NT>
__device__ __forceinline__ void zero_table_pad(unsigned char* base, int a0,
                                               int a1, int a2, int nb3,
                                               int np) {
  const int pad = 2 * (np - nb3);       // 16-byte halves per table
  for (int i = threadIdx.x; i < 3 * pad; i += NT) {
    const int t = i / pad, r = i - t * pad;
    *reinterpret_cast<uint4*>(base + (t == 0 ? a0 : (t == 1 ? a1 : a2)) +
                              row16_off(nb3 + (r >> 1), r & 1)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// The forward of rows [row0, row0 + 64), for the head blockIdx.y, over keys
// [win_lo, win_hi) ∩ the union of the rows' [key_lo, key_hi), in the fast
// form; the same operands as attention_fwd_block (q, k and v read at
// 16-byte aligned rows; q scaled by `scale` here). kSwin: Swin3D's bins
// (table_bin).
template <bool kSwin>
__device__ void attention_fwd_block_tc(const FwdQueries& Q, const FwdKeys& K,
                                       const FwdTables& T, const FwdOutputs& O,
                                       int h, int row0, int win_lo,
                                       int win_hi, float scale) {
  constexpr int D = 16;
  constexpr int R = kFtRows, C = kFwdChunk, NT = kFtThreads, NW = NT / 32;
  constexpr int MT = R / 16;                  // 16-row tiles
  static_assert(NT == 4 * R && NT == 8 * C && NW == 2 * MT,
                "a thread per quarter of a q row and of a chunk's k or v "
                "row; a warp per (row tile, half of its rows)");
  static_assert(kFtMaxNb <= 255 && (3 * kFtMaxNb + 15) / 16 <= 32,
                "bins are packed 8 bits per axis; tiles in a 32-bit mask");

  extern __shared__ __align__(16) uint4 ft_smem[];
  __shared__ float s_kbox[NW][6];

  const FtSmem L(T.nb);
  const int nb = T.nb, nb3 = L.nb3, np = L.np, ps = L.ps;
  const int n16 = np / 16;
  const bool tabs = nb > 0;
  unsigned char* base = reinterpret_cast<unsigned char*>(ft_smem);
  const uint32_t sbase = smem_addr(base);
  const uint32_t a_tq = sbase + L.kp, a_tk = sbase + L.tk;
  const uint32_t a_tv = sbase + L.tv, a_q = sbase + L.q;
  float* s_qp = reinterpret_cast<float*>(base + L.qp);
  float* s_mass = reinterpret_cast<float*>(base + L.mass);
  float* s_kp = reinterpret_cast<float*>(base + L.kp);

  const int head = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tg = lane & 3;    // fragment row / column pair
  const int mt = warp % MT, rh = warp / MT;   // row tile, its half
  const float kInf = __int_as_float(0x7f800000);

  // ---- every warp takes the block's key hull [lo, hi) and the box of its
  //      rows that have keys from all R rows' records (no shared memory,
  //      no barrier: the first chunk's loads start at once) --------------
  int lo = win_hi, hi = win_lo;
  float rbox[6] = {kInf, kInf, kInf, -kInf, -kInf, -kInf};
#pragma unroll
  for (int u = 0; u < R / 32; ++u) {
    const int row = row0 + lane + 32 * u;
    if (Q.valid[row] != 0) {
      const int ks = Q.key_lo[row], ke = Q.key_hi[row];
      if (ke > ks) {
        lo = min(lo, ks);
        hi = max(hi, ke);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float x = Q.xyz[row * 3 + a];
          rbox[a] = fminf(rbox[a], x);
          rbox[a + 3] = fmaxf(rbox[a + 3], x);
        }
      }
    }
  }
  lo = max(__reduce_min_sync(0xffffffffu, lo), win_lo);
  hi = min(__reduce_max_sync(0xffffffffu, hi), win_hi);
  warp_box(rbox);
  // the chunks start at multiples of C from win_lo (keys of the first chunk
  // below lo are staged and never reached)
  const int first = win_lo + ((lo - win_lo) & ~(C - 1));

  // A chunk's keys pass through registers: thread tid loads the quarter
  // kq of key kj's k (kwhich 0) or v row, and thread j < C key j's point
  // and skey; they are stored to a key buffer as bf16 while the next chunk
  // computes. ksrc: the row of key kj in the chunk after the one loading
  // (the far-key half reads its keys through K.src, one chunk ahead, so
  // that no load waits on its index).
  const int kj = tid >> 3, kwhich = (tid >> 2) & 1, kq = tid & 3;
  float4 kvr = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 xr = make_float4(0.f, 0.f, 0.f, 0.f);
  int sr = 0;
  auto key_src = [&](int p) {
    return p < hi ? (K.src != nullptr ? K.src[p] : p) : -1;
  };
  int ksrc = first < hi ? key_src(first + kj) : -1;
  auto load_chunk = [&](int c0) {
    kvr = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ksrc >= 0)
      kvr = *reinterpret_cast<const float4*>(
          (kwhich ? K.v : K.k) +
          static_cast<size_t>(ksrc) * (kwhich ? K.v_rs : K.k_rs) +
          head * D + 4 * kq);
    ksrc = key_src(c0 + C + kj);
    if (tid < C) {
      const int p = c0 + tid;
      xr = make_float4(0.f, 0.f, 0.f, 0.f);
      sr = 0;
      if (p < hi) {
        xr = make_float4(K.xyz[p * 3 + 0], K.xyz[p * 3 + 1],
                         K.xyz[p * 3 + 2], K.valid[p] ? 1.0f : 0.0f);
        sr = K.skey != nullptr ? K.skey[p] : 0;
      }
    }
  };
  auto store_chunk = [&](int b) {
    unsigned char* kb = base + L.kb + b * FtSmem::kKeyBuf;
    *reinterpret_cast<uint2*>(kb + kwhich * C * 32 + row16_off(kj, kq >> 1) +
                              (kq & 1) * 8) =
        make_uint2(pack_bf16(kvr.x, kvr.y), pack_bf16(kvr.z, kvr.w));
    if (tid < C) {
      reinterpret_cast<float4*>(kb + 2 * C * 32)[tid] = xr;
      reinterpret_cast<int*>(kb + 2 * C * 32 + C * 16)[tid] = sr;
    }
  };
  // the first chunk's loads in flight while q, the tables and the box of
  // the window's valid keys are staged, then its store and the second
  // chunk's loads
  if (first < hi) load_chunk(first);

  // ---- the rows' q (scaled in fp32, then rounded; a quarter row per
  //      thread); Tq (in the key projections' place), Tk and Tv; the masses
  //      at zero (entries no pair reaches, and the padding columns, stay 0)
  {
    const int t = tid >> 2, qq = tid & 3, row = row0 + t;
    const int src = Q.map != nullptr ? Q.map[row] : row;
    const float4 x = *reinterpret_cast<const float4*>(
        Q.q + static_cast<size_t>(src) * Q.q_rs + head * D + 4 * qq);
    *reinterpret_cast<uint2*>(base + L.q + row16_off(t, qq >> 1) +
                              (qq & 1) * 8) =
        make_uint2(pack_bf16(x.x * scale, x.y * scale),
                   pack_bf16(x.z * scale, x.w * scale));
  }
  if (tabs && lo < hi) {
    // (selected, not indexed: a runtime index would put the arrays in
    // local memory)
    for (int i = tid; i < 3 * nb; i += NT) {
      const int tb = i / nb;
      stage_table_bin(base + (tb == 0 ? L.kp : (tb == 1 ? L.tk : L.tv)), T,
                      tb == 0 ? T.tq : (tb == 1 ? T.tk : T.tv), h, head,
                      i - tb * nb);
    }
    zero_table_pad<NT>(base, L.kp, L.tk, L.tv, nb3, np);
    for (int i = tid; i < R * ps / 4; i += NT)
      reinterpret_cast<float4*>(s_mass)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  {
    float bx[6] = {kInf, kInf, kInf, -kInf, -kInf, -kInf};
    for (int p = lo + tid; p < hi; p += NT) {
      if (K.valid[p]) {
        const float x[3] = {K.xyz[p * 3], K.xyz[p * 3 + 1], K.xyz[p * 3 + 2]};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          bx[a] = fminf(bx[a], x[a]);
          bx[a + 3] = fmaxf(bx[a + 3], x[a]);
        }
      }
    }
    warp_box(bx);
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < 6; ++i) s_kbox[warp][i] = bx[i];
  }
  if (first < hi) {
    store_chunk(0);
    if (first + C < hi) load_chunk(first + C);
  }
  __syncthreads();

  // ---- the bins any pair can take: per axis, the bins of the extreme
  //      relative positions of the two boxes, as a mask of 16-row (axis,
  //      bin) tiles; and whether any pair's bin may need its clips ---------
  int blo[3] = {0, 0, 0}, bhi[3] = {-1, -1, -1};
  uint32_t tmask = 0u;
  bool clip = true;
  if (tabs && lo < hi) {
    const float* bx = rbox;
    float kx[6] = {kInf, kInf, kInf, -kInf, -kInf, -kInf};
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < 6; ++i)
        kx[i] = i < 3 ? fminf(kx[i], s_kbox[w][i]) : fmaxf(kx[i], s_kbox[w][i]);
    if (bx[0] <= bx[3] && kx[0] <= kx[3]) {
      clip = false;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float rlo = __fsub_rn(bx[ax], kx[ax + 3]);
        const float rhi = __fsub_rn(bx[ax + 3], kx[ax]);
        blo[ax] = table_bin<kSwin>(T, rlo);
        bhi[ax] = table_bin<kSwin>(T, rhi);
        clip |= !unclipped(T, raw_bin<kSwin>(T, rlo)) ||
                !unclipped(T, raw_bin<kSwin>(T, rhi));
        for (int t16 = (ax * nb + blo[ax]) >> 4;
             t16 <= (ax * nb + bhi[ax]) >> 4; ++t16)
          tmask |= 1u << t16;
      }
    }
  }

  // x rows (row16 at a_x, M tiles of 16) projected onto the table rows at
  // a_t into out [16 M][ps]: the warp's A fragments loaded once; warps
  // share the 8-column tiles, a tile's B fragment loaded once. Columns past
  // nb3 project zero rows into the rows' padding.
  auto project = [&](uint32_t a_x, auto m_tiles, uint32_t a_t, float* out) {
    constexpr int M = decltype(m_tiles)::value;
    uint32_t a[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
      ldsm_x4(a[m], row16(a_x, m * 16 + (lane & 15), lane >> 4));
    for (int u = warp; u < 2 * n16; u += NW) {
      if (!((tmask >> (u >> 1)) & 1u)) continue;
      uint32_t b[2];
      ldsm_x2(b, row16(a_t, u * 8 + (lane & 7), (lane >> 3) & 1));
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16_16816(d, a[m], b);
        float* o0 = out + (m * 16 + g8) * ps + u * 8 + 2 * tg;
        *reinterpret_cast<float2*>(o0) = make_float2(d[0], d[1]);
        *reinterpret_cast<float2*>(o0 + 8 * ps) = make_float2(d[2], d[3]);
      }
    }
  };

  // ---- the rows' projections onto Tq ----------------------------------
  if (tabs && lo < hi)
    project(a_q, std::integral_constant<int, MT>(), a_tq, s_qp);

  // this warp's row t (its lanes' row g of the tile's A and C fragments
  // when rh is 0, row g + 8 when rh is 1): key range, position, skey; the
  // A fragment of the tile's q rows
  const int t = mt * 16 + rh * 8 + g8, row = row0 + t;
  const float rx[3] = {Q.xyz[row * 3 + 0], Q.xyz[row * 3 + 1],
                       Q.xyz[row * 3 + 2]};
  // the row's key range, empty for an invalid row
  const bool rok = Q.valid[row] != 0;
  const int rks = rok ? Q.key_lo[row] : 0, rke = rok ? Q.key_hi[row] : 0;
  const int rsk = Q.skey != nullptr ? Q.skey[row] : 0;
  const float* qrow = s_qp + t * ps;
  float rm = kNegInf, rden[2] = {0.0f, 0.0f};
  // the masses sum p · exp(m - mref) for a reference mref <= m that moves
  // to m only when m passes it by more than kMassSpan (so that the sums
  // stay below e^kMassSpan per key), and are scaled to the row's final
  // maximum once, where each is rounded for mass·Tv
  float mref = kNegInf;
  uint32_t qa[4];
  ldsm_x4(qa, row16(a_q, mt * 16 + (lane & 15), lane >> 4));
  // acc of the tile's rows x the 16 channels (C fragments of two 8-channel
  // tiles) over the chunks' first (o[0]) and second (o[1]) 16 keys; only
  // this warp's rows are nonzero
  float o[2][2][4] = {};
  // lane tg < 3 walks axis tg of the row's masses; the bins of that axis
  // that pairs can take (selected, not indexed: a runtime index would put
  // blo and bhi in local memory)
  const bool walker = tabs && tg < 3;
  float* mrow = s_mass + t * ps + (tg < 3 ? tg : 0) * nb;
  const int wlo = tg == 0 ? blo[0] : (tg == 1 ? blo[1] : blo[2]);
  const int whi = tg == 0 ? bhi[0] : (tg == 1 ? bhi[1] : bhi[2]);

  int buf = 0;
  for (int c0 = first; c0 < hi; c0 += C, buf ^= 1) {
    const int cn = min(C, hi - c0);
    __syncthreads();                          // (A) this chunk is staged
    const uint32_t a_k = sbase + L.kb + buf * FtSmem::kKeyBuf;
    const uint32_t a_v = a_k + C * 32;
    const float4* s_xk = reinterpret_cast<const float4*>(
        base + L.kb + buf * FtSmem::kKeyBuf + 2 * C * 32);
    const int* s_skey = reinterpret_cast<const int*>(s_xk + C);

    // ---- A. the chunk's keys projected onto Tk (rows past cn project
    //         zeros nobody reads) -----------------------------------------
    if (tabs)
      project(a_k, std::integral_constant<int, C / 16>(), a_tk, s_kp);
    __syncthreads();                          // (B)

    // ---- B. pass 1: the logits of the row x the chunk's 32 keys, the
    //         lane's keys 8 nt + 2 tg + e of the C fragments; 8-key tiles
    //         that none of the warp's rows reaches are skipped -------------
    bool act[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      act[nt] = __any_sync(0xffffffffu, rks < rke && 8 * nt < cn &&
                                            rks < c0 + 8 * nt + 8 &&
                                            rke > c0 + 8 * nt);
    float l[4][2], pv[4][2];
    int bins[4][2];
    unsigned okm = 0u;
    float mx = kNegInf;
    // (an instantiation per kind of bin: the block's choice is uniform, and
    // a select between the two would compute both)
    auto pairs = [&](auto clipped) {
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        if (!(act[2 * kt] || act[2 * kt + 1])) continue;
        uint32_t bk[4];
        ldsm_x4(bk, row16(a_k, 16 * kt + (lane & 7) + ((lane >> 4) << 3),
                          (lane >> 3) & 1));
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int nt = 2 * kt + u;
          float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          const uint32_t b[2] = {bk[2 * u], bk[2 * u + 1]};
          mma_bf16_16816(sc, qa, b);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 8 * nt + 2 * tg + e, p = c0 + j;
            l[nt][e] = rh ? sc[2 + e] : sc[e];
            bins[nt][e] = 0;
            const float4 xk = s_xk[j];
            if (p >= rks && p < rke && xk.w != 0.0f &&
                (K.skey == nullptr || s_skey[j] != rsk)) {
              if (tabs) {
                const float xkk[3] = {xk.x, xk.y, xk.z};
                const float* krow = s_kp + j * ps;
                int packed = 0;
#pragma unroll
                for (int ax = 0; ax < 3; ++ax) {
                  const float rel = __fsub_rn(rx[ax], xkk[ax]);
                  int bn;
                  if constexpr (decltype(clipped)::value)
                    bn = table_bin<kSwin>(T, rel);
                  else
                    bn = static_cast<int>(raw_bin<kSwin>(T, rel)) - T.bin_lo;
                  const int ab = ax * nb + bn;
                  l[nt][e] += qrow[ab] + krow[ab];
                  packed |= bn << (8 * ax);
                }
                bins[nt][e] = packed;
              }
              okm |= 1u << (2 * nt + e);
              mx = fmaxf(mx, l[nt][e]);
            }
          }
        }
      }
    };
    if (clip)
      pairs(std::true_type());
    else
      pairs(std::false_type());

    // ---- C. the row's chunk maximum; acc, den and the masses rescaled
    //         once; p = exp(l - m); den += p; acc += P·V -----------------
    mx = group_max<4>(mx);
    if (mx > rm) {
      const float r = expf(rm - mx);          // 0 while the row had no key
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        rden[kt] *= r;
#pragma unroll
        for (int ct = 0; ct < 2; ++ct)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[kt][ct][e] *= r;
      }
      rm = mx;
      // the masses' reference follows only far behind
      if (rm - mref > kMassSpan) {
        if (walker && mref > kNegInf) {
          const float rr = expf(mref - rm);
          for (int b = wlo; b <= whi; ++b) mrow[b] *= rr;
        }
        mref = rm;
      }
    }
    const float ms = expf(rm - mref);         // p to the masses' scale
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = 0.0f;
        if (act[nt & ~1] || act[nt | 1])      // (the 16 keys' l are set)
          p = ((okm >> (2 * nt + e)) & 1u) ? expf(l[nt][e] - rm) : 0.0f;
        rden[nt >> 1] += p;
        pv[nt][e] = p;
      }
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      if (!(act[2 * kt] || act[2 * kt + 1])) continue;
      // P (rounded to bf16) as the A fragment of the 16-key step kt: this
      // warp's row, the tile's other rows zero
      const uint32_t p0 = pack_bf16(pv[2 * kt][0], pv[2 * kt][1]);
      const uint32_t p1 = pack_bf16(pv[2 * kt + 1][0], pv[2 * kt + 1][1]);
      const uint32_t pa[4] = {rh ? 0u : p0, rh ? p0 : 0u, rh ? 0u : p1,
                              rh ? p1 : 0u};
      uint32_t bv[4];
      ldsm_x4_trans(bv, row16(a_v, 16 * kt + (lane & 15), lane >> 4));
#pragma unroll
      for (int ct = 0; ct < 2; ++ct) {
        const uint32_t b[2] = {bv[2 * ct], bv[2 * ct + 1]};
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16_16816(d, pa, b);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[kt][ct][e] += d[e];
      }
    }

    // ---- D. the row's bin masses: lane tg < 3 adds the chunk's p into
    //         the masses of axis tg, one read-modify-write per key in key
    //         order (no branch: a masked pair adds an exact 0 to bin 0), the
    //         p and bins of the row's four lanes by quad shuffles ---------
    if (tabs) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (!act[nt]) continue;
#pragma unroll
        for (int src = 0; src < 4; ++src)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = __shfl_sync(0xffffffffu, pv[nt][e], src, 4);
            const int bn = __shfl_sync(0xffffffffu, bins[nt][e], src, 4);
            if (walker) mrow[(bn >> (8 * tg)) & 255] += p * ms;
          }
      }
    }

    // the next chunk's keys to its buffer (the one the chunk before this
    // one used), and the one after that into registers
    if (c0 + C < hi) {
      store_chunk(buf ^ 1);
      if (c0 + 2 * C < hi) load_chunk(c0 + 2 * C);
    }
  }

  // ---- end of block: Σ mass·Tv for the warp's rows (each mass scaled to
  //      the final maximum and rounded to bf16 once; the masses are the
  //      warp's own, Tv resident: no barrier); acc = (the chunks' first 16
  //      keys + their second 16) + mass·Tv --------------------------------
  float mtv[2][4] = {};
  if (tabs && lo < hi) {
    __syncwarp();                             // the row's lanes' last adds
    const float* mr = s_mass + t * ps;
    const float ef = expf(mref - rm);         // 1 for a row with no key
    for (int t16 = 0; t16 < n16; ++t16) {
      if (!((tmask >> t16) & 1u)) continue;
      // this warp's row of the tile's A fragment, the other rows zero (the
      // masses past nb3 are zero)
      const float2 ma = *reinterpret_cast<const float2*>(mr + t16 * 16 +
                                                         2 * tg);
      const float2 mb = *reinterpret_cast<const float2*>(mr + t16 * 16 +
                                                         2 * tg + 8);
      const uint32_t m0 = pack_bf16(ma.x * ef, ma.y * ef);
      const uint32_t m1 = pack_bf16(mb.x * ef, mb.y * ef);
      const uint32_t a[4] = {rh ? 0u : m0, rh ? m0 : 0u, rh ? 0u : m1,
                             rh ? m1 : 0u};
#pragma unroll
      for (int ct = 0; ct < 2; ++ct) {
        uint32_t b[2];
        ldsm_x2_trans(b, row16(a_tv, t16 * 16 + (lane & 15), ct));
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16_16816(d, a, b);
#pragma unroll
        for (int e = 0; e < 4; ++e) mtv[ct][e] += d[e];
      }
    }
  }
  // den per row: each 16-key half over the row's four lanes (a fixed
  // butterfly), the first half's then the second's
  const float den = group_sum<4>(rden[0]) + group_sum<4>(rden[1]);
  const int dst = Q.map != nullptr ? Q.map[row] : row;
  const size_t ro = static_cast<size_t>(dst) * h + head;
#pragma unroll
  for (int ct = 0; ct < 2; ++ct) {
    const float a0 = rh ? (o[0][ct][2] + o[1][ct][2]) + mtv[ct][2]
                        : (o[0][ct][0] + o[1][ct][0]) + mtv[ct][0];
    const float a1 = rh ? (o[0][ct][3] + o[1][ct][3]) + mtv[ct][3]
                        : (o[0][ct][1] + o[1][ct][1]) + mtv[ct][1];
    *reinterpret_cast<float2*>(O.acc + ro * D + ct * 8 + 2 * tg) =
        make_float2(a0, a1);
  }
  if (tg == 0) {
    O.m[ro] = rm;
    O.den[ro] = den;
  }
}

}  // namespace stratified
