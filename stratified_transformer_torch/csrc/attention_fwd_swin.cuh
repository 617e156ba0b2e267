// The band half's forward in the swin mode (Swin3D, rpe_mode
// "swin_window"), fp32: the routine of band_attention.cu's swin kernel.
//
// It computes what attention_fwd_block (attention_fwd_common.cuh) computes
// for the band half, with Swin3D's bins (swin_bin): for each query row the
// unnormalised softmax triple over the keys of its window, each logit
// q·k + Σ_a (q·Tq[b_a] + k·Tk[b_a]) and each value v + Σ_a Tv[b_a], b_a the
// pair's bin on axis a. A row sees only its own window (about 12 keys at
// S3DIS stage 0, up to some hundreds at stage 2), so the band half's
// projection form cost more than the pairs there: every row projected onto
// all 3·nb table rows, every key of a chunk too, a mass per (row, axis,
// bin) walked by one lane per axis and a Σ mass·Tv over all bins at the end
// (PERF.md, the swin forward's phase split). This routine works per pair:
//   - the head's tables are staged once per block, transposed to
//     [table][axis][bin][D] rows in shared memory; a pair takes k·Tk[b_a]
//     as a 16-long dot product and adds the three Tv rows to v, so there
//     are no masses, no walk, no key projections and no Σ mass·Tv;
//   - each row's q is projected once onto the 3·nb rows of Tq, so that a
//     pair looks its three q·Tq[b_a] up (a dot product per pair measured
//     slower, even at S3DIS stage 0's 12 keys a row: the projections keep
//     every thread busy, while the pairs' table reads are what a block
//     waits on; projecting each chunk's keys onto Tk as well gained
//     nothing);
//   - the key chunks (kSwinChunk keys: k, v and the points) arrive by
//     cp.async in two buffers, the next chunk issued right after the
//     chunk's one barrier; the keys' valid bytes, which cp.async does not
//     copy, go through a register one chunk ahead; the span of the rows'
//     keys is a per-warp reduction.
// Per chunk the LPR lanes of a row take every LPR-th key of the row's keys
// in the chunk, whole pairs per lane: pass 1 the logits into registers, the
// chunk's row max by shuffles, one rescale of the lanes' acc and den if it
// grew, pass 2 p = exp(l - m), den += p, acc += p (v + Σ_a Tv[b_a]). At the
// end the row's lanes add their parts by shuffles (a fixed butterfly). The
// lanes of a row lie RPW apart in their warp, so that the 8 lanes of a
// quarter-warp hold 8 rows at one key slot: rows of one window read the
// same k and v.
// Every sum runs in a fixed order and no two threads write one
// shared-memory address in a phase: no atomics, bit-identical launches.
// Positions may fall anywhere (swin_bin clips); the bins are as
// attention_fwd_block's, and only the order of the fp32 sums differs.
#pragma once

#include "attention_fwd_common.cuh"
#include "tensor_core.cuh"

namespace stratified {

constexpr int kSwinChunk = 32;      // keys per round
constexpr int kSwinThreads = 256;   // 8 warps per block

// Shared-memory layout of a block of R rows (offsets in 4-byte words, each
// array 16-byte aligned): the tables, the rows' scaled q, their projections
// onto Tq (odd stride 3·nb + 1 where nb is even) and two key buffers of
// kKeyBuf words, each k [C][S], v [C][S] and the points [C][4] (x, y, z,
// valid).
template <int R>
struct SwinSmem {
  static constexpr int C = kSwinChunk;
  static constexpr int S = kFwdRowStride;
  static constexpr int kKeyBuf = 2 * C * S + 4 * C;
  int nb3, ps;
  int tab, q, qp, keys, total;

  __host__ __device__ static int up4(int x) { return (x + 3) & ~3; }
  __host__ __device__ explicit SwinSmem(int nb)
      : nb3(3 * nb), ps(3 * nb + 1) {
    int o = 0;
    tab = o;  o += 3 * nb3 * S;           // Tq, Tk, Tv: [3][3·nb][S]
    q = o;    o += R * S;
    qp = o;   o += up4(R * ps);           // q·Tq [R][ps]
    keys = o; o += 2 * kKeyBuf;
    total = o;
  }
  __host__ size_t bytes() const {
    return sizeof(float) * static_cast<size_t>(total);
  }
};

// The most table rows per axis (at most kFwdMaxNb) for which a block of R
// rows fits in `room` bytes.
template <int R>
__host__ int swin_max_nb(size_t room) {
  int nb = kFwdMaxNb;
  while (nb > 0 && SwinSmem<R>(nb).bytes() > room) --nb;
  return nb;
}

// Sum / max over the N lanes of a row, which lie G lanes apart (a fixed
// butterfly: every lane of the row gets the same value).
template <int N, int G>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int s = G; s < G * N; s <<= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

template <int N, int G>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int s = G; s < G * N; s <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

// x · the 16-float shared-memory row r (16-byte aligned), in channel order.
template <int D>
__device__ __forceinline__ float dot_row(const float* x, const float* r) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    float t[4];
    lds4(r + c, t);
#pragma unroll
    for (int e = 0; e < 4; ++e) s = fmaf(x[c + e], t[e], s);
  }
  return s;
}

// The forward of rows [row0, row0 + R), for the head blockIdx.y, over keys
// [win_lo, win_hi) ∩ the union of the rows' [key_lo, key_hi), in Swin3D's
// bins (T: the whole table, bin_lo 0). The band half only: Q.map, Q.skey,
// K.src and K.skey are null. The rows of q, k and v start on 16 bytes.
template <int D, int R>
__device__ void attention_fwd_swin(const FwdQueries& Q, const FwdKeys& K,
                                   const FwdTables& T, const FwdOutputs& O,
                                   int h, int row0, int win_lo, int win_hi,
                                   float scale) {
  constexpr int NT = kSwinThreads;
  constexpr int NW = NT / 32;
  constexpr int C = kSwinChunk;
  constexpr int S = kFwdRowStride;
  constexpr int LPR = NT / R;           // lanes per row
  constexpr int RPW = 32 / LPR;         // rows per warp, lanes apart
  constexpr int KPL = C / LPR;          // keys per lane and chunk, at most
  constexpr int KB = SwinSmem<R>::kKeyBuf;
  static_assert(D == 16 && 2 * C * (D / 4) == NT,
                "one 16-byte copy of k or v a thread");
  static_assert(NT % R == 0 && LPR <= 32 && C % LPR == 0, "rows per block");

  extern __shared__ __align__(16) float smem[];
  __shared__ int s_span[2 * NW];        // each warp's keys: lo, hi
  const SwinSmem<R> L(T.nb);
  const int nb = T.nb, nb3 = L.nb3, ps = L.ps;
  const bool tabs = nb > 0;
  float* s_tab = smem + L.tab;
  float* s_q = smem + L.q;
  float* s_qp = smem + L.qp;

  const int head = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // ---- the rows' scaled q; the head's tables transposed into
  //      [table][axis][bin][D], a float4 of the model's layout a thread,
  //      loads issued together ------------------------------------------
  for (int i = tid; i < R * (D / 4); i += NT) {
    const int r = i / (D / 4), c4 = (i % (D / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(
        Q.q + static_cast<size_t>(row0 + r) * Q.q_rs + head * D + c4);
    *reinterpret_cast<float4*>(s_q + r * S + c4) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }
  {
    constexpr int F = 3 * D / 4;        // float4s per (table, bin)
    constexpr int U = 5;
    const float* tabs_in[3] = {T.tq, T.tk, T.tv};
    const int total = 3 * nb * F;
    for (int i0 = tid; i0 < total; i0 += U * NT) {
      float4 x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * NT, rb = i / F, tb = rb / nb;
        x[u] = i < total && tabs_in[tb] != nullptr
                   ? __ldg(table_row<D>(tabs_in[tb], rb - tb * nb, h, head) +
                           (i - rb * F))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * NT, rb = i / F, f = i - rb * F;
        if (i >= total) break;
        const int tb = rb / nb;
        float* dst = s_tab + (tb * nb3 + rb - tb * nb) * S;
        const float e[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int ca = 4 * f + w;     // channel ca / 3, axis ca % 3
          dst[(ca % 3) * nb * S + ca / 3] = e[w];
        }
      }
    }
  }

  // this thread's row and lane in it; the span of the warp's rows' keys
  const int t = warp * RPW + lane % RPW, sub = lane / RPW;
  const int row = row0 + t;
  const bool row_ok = Q.valid[row] != 0;
  const int ks = row_ok ? max(Q.key_lo[row], win_lo) : 0;
  const int ke = row_ok ? min(Q.key_hi[row], win_hi) : 0;
  {
    const bool any = ke > ks;
    const unsigned wlo = __reduce_min_sync(
        0xffffffffu, any ? static_cast<unsigned>(ks) : 0x7fffffffu);
    const unsigned whi = __reduce_max_sync(
        0xffffffffu, any ? static_cast<unsigned>(ke) : 0u);
    if (lane == 0) {
      s_span[2 * warp] = static_cast<int>(wlo);
      s_span[2 * warp + 1] = static_cast<int>(whi);
    }
  }
  __syncthreads();
  int lo = win_hi, hi = win_lo;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    lo = min(lo, s_span[2 * w]);
    hi = max(hi, s_span[2 * w + 1]);
  }

  // key chunk [c0, c0 + C) into key buffer b: k, v (16-byte copies) and the
  // points (4-byte) by cp.async; keys past hi are never read
  auto stage_chunk = [&](int b, int c0) {
    const int cn = min(C, hi - c0);
    float* kb = smem + L.keys + b * KB;
    {
      const int j = tid >> 3, which = (tid >> 2) & 1, c4 = (tid & 3) * 4;
      const bool full = j < cn;
      const size_t key = static_cast<size_t>(c0 + (full ? j : 0));
      cp_async16(smem_addr(kb + which * C * S + j * S + c4),
                 which ? K.v + key * K.v_rs + head * D + c4
                       : K.k + key * K.k_rs + head * D + c4,
                 full);
    }
    if (tid < 3 * C) {
      const int j = tid / 3, a = tid - 3 * j;
      cp_async4(smem_addr(kb + 2 * C * S + j * 4 + a),
                K.xyz + static_cast<size_t>(c0 + (j < cn ? j : 0)) * 3 + a,
                j < cn);
    }
  };
  int vnext = 0;
  if (lo < hi) {
    stage_chunk(0, lo);
    if (tid < C)
      smem[L.keys + 2 * C * S + tid * 4 + 3] =
          tid < hi - lo && K.valid[lo + tid] ? 1.0f : 0.0f;
  }
  cp_async_commit();

  if (tabs) {
    // the rows' projections onto Tq: a thread keeps one row's q in
    // registers and takes every (NT / R)-th table row
    const int tt = tid % R;
    float qr[D];
#pragma unroll
    for (int c = 0; c < D; c += 4) lds4(s_q + tt * S + c, qr + c);
    for (int ab = tid / R; ab < nb3; ab += NT / R)
      s_qp[tt * ps + ab] = dot_row<D>(qr, s_tab + ab * S);
  }
  float q[D];
#pragma unroll
  for (int c = 0; c < D; c += 4) lds4(s_q + t * S + c, q + c);
  const float xq[3] = {Q.xyz[row * 3 + 0], Q.xyz[row * 3 + 1],
                       Q.xyz[row * 3 + 2]};
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.0f;
  float m = kNegInf, den = 0.0f;

  int b = 0;                            // the key buffer of chunk c0
  for (int c0 = lo; c0 < hi; c0 += C, b ^= 1) {
    const int cn = min(C, hi - c0);
    const float* s_k = smem + L.keys + b * KB;
    const float* s_v = s_k + C * S;
    float* s_xk = smem + L.keys + b * KB + 2 * C * S;
    if (c0 != lo && tid < C) s_xk[tid * 4 + 3] = vnext ? 1.0f : 0.0f;
    cp_async_wait<0>();                 // this chunk has landed
    __syncthreads();
    // the next chunk into the other buffer, which the last chunk's passes
    // left before that barrier
    if (c0 + C < hi) {
      stage_chunk(b ^ 1, c0 + C);
      vnext = tid < min(C, hi - c0 - C) ? K.valid[c0 + C + tid] : 0;
    }
    cp_async_commit();

    // ---- pass 1: the logits of the row's keys in the chunk, nu key
    //      slots a lane: as many as the warp's longest row needs ----------
    const bool reach = ks < c0 + cn && ke > c0;
    const int rlo = reach ? max(ks - c0, 0) : 0;
    const int rhi = reach ? min(ke - c0, cn) : 0;
    const int nu = (static_cast<int>(__reduce_max_sync(
                        0xffffffffu, static_cast<unsigned>(rhi - rlo))) +
                    LPR - 1) / LPR;
    float l[KPL];
    int pk[KPL];
    unsigned ok = 0u;
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      if (u >= nu) break;
      const int j = rlo + sub + u * LPR;
      l[u] = 0.0f;
      pk[u] = 0;
      if (j < rhi) {
        float xk[4];
        lds4(s_xk + j * 4, xk);
        if (xk[3] != 0.0f) {
          float kc[D];
#pragma unroll
          for (int c = 0; c < D; c += 4) lds4(s_k + j * S + c, kc + c);
          float s = 0.0f;
#pragma unroll
          for (int c = 0; c < D; ++c) s = fmaf(q[c], kc[c], s);
          if (tabs) {
            int packed = 0;
#pragma unroll
            for (int ax = 0; ax < 3; ++ax) {
              const int bn = table_bin<true>(T, __fsub_rn(xq[ax], xk[ax]));
              const int ab = ax * nb + bn;
              packed |= bn << (8 * ax);
              s += s_qp[t * ps + ab] + dot_row<D>(kc, s_tab + (nb3 + ab) * S);
            }
            pk[u] = packed;
          }
          l[u] = s;
          ok |= 1u << u;
          mx = fmaxf(mx, s);
        }
      }
    }

    // ---- the chunk's row max; rescale the row's state once --------------
    mx = row_max<LPR, RPW>(mx);
    if (mx > m) {
      const float r = expf(m - mx);     // 0 while the row has no key yet
      den *= r;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] *= r;
      m = mx;
    }

    // ---- pass 2: p, den, acc += p (v + Σ_a Tv[b_a]) --------------------
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      if (u >= nu) break;
      if ((ok >> u) & 1u) {
        const int j = rlo + sub + u * LPR;
        const float p = expf(l[u] - m);
        den += p;
        float vc[D];
#pragma unroll
        for (int c = 0; c < D; c += 4) lds4(s_v + j * S + c, vc + c);
        if (tabs) {
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            const float* rv =
                s_tab + (2 * nb3 + ax * nb + ((pk[u] >> (8 * ax)) & 255)) * S;
#pragma unroll
            for (int c = 0; c < D; c += 4) {
              float tv[4];
              lds4(rv + c, tv);
#pragma unroll
              for (int e = 0; e < 4; ++e) vc[c + e] += tv[e];
            }
          }
        }
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] = fmaf(p, vc[c], acc[c]);
      }
    }
  }

  // ---- end of block: the row's lanes add their parts ---------------------
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = row_sum<LPR, RPW>(acc[c]);
  den = row_sum<LPR, RPW>(den);
  if (sub == 0) {
    const size_t o = static_cast<size_t>(row) * h + head;
    float4* out = reinterpret_cast<float4*>(O.acc + o * D);
#pragma unroll
    for (int c = 0; c < D; c += 4)
      out[c / 4] = make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
    O.m[o] = m;
    O.den[o] = den;
  }
}

}  // namespace stratified
