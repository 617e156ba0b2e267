// Shared device code of the two stratified-attention forward kernels.
//
// Both kernels give one block of 256 threads to each (row slice, head): a
// slice is R consecutive query rows of a 128-row tile, and it sees the
// tile's window of keys (the 128-row tile stays semantic). They run the same
// routine (attention_fwd_block) and differ in which keys a tile sees and in
// the form of the cRPE table terms (kProj).
//
// A row's logit against key j adds q·Tq[b_a] and k_j·Tk[b_a] over the three
// axes a (b_a the pair's bin on axis a), and its value adds Σ_a Tv[b_a].
//   kProj (band half): the projection form of the TPU kernel
//     (fused_attention.py:117-132,177-186,205-246). Each row's q is
//     projected onto the 3·nb rows of Tq once per block, and each key of a
//     chunk onto those of Tk once per chunk, so a pair reads two numbers per
//     axis. Tv goes through bin masses: per row and (axis, bin) the sum of
//     the row's softmax weights p, added once at the end as Σ mass·Tv.
//   !kProj (far-key half): the per-pair form, three d-long dot products per
//     table and pair and the three Tv rows added to v. A row has at most
//     sparse_cap far keys (48 for S3DIS, 64 for ScanNet), fewer than the
//     ~nb at which projecting it onto 3·nb table rows would cost less.
// The band half's swin mode runs a routine of its own
// (attention_fwd_swin.cuh).
//
// Per key chunk (kFwdChunk keys staged in shared memory): the LPR = 256 / R
// lanes of a row take every LPR-th key of the row's own keys in the chunk,
// whole pairs per lane. Pass 1 computes the logits into registers, the
// row's lanes take the chunk's max by shuffles, and the row's state (its
// lanes' partial acc and den, and its masses) is rescaled once if the max
// grew. Pass 2 forms p = exp(l - m), den += p and acc += p·v. With masses,
// lane a < 3 of the row then walks the row's keys of the chunk in order
// (their p and bins reach it by shuffles) and adds p into the row's mass of
// axis a, one read-modify-write per run of keys in one bin. At the end the
// row's lanes add their parts by shuffles (a fixed butterfly).
// The tables stay in the model's [nb_full][H][D][3] layout: the projections
// read a bin's 3·D floats (all three axes) as float4s through the read-only
// cache; the per-pair form stages the head's tables transposed into shared
// memory once per block.
// This routine is the fp32 form (the TPU kernels at fast=False); the fast
// (bf16) forms run attention_fwd_block_tc (attention_fwd_tc.cuh).
// No two threads write one shared-memory address in a phase, and every sum
// runs in a fixed order: no atomics on data, bit-identical launches.
#pragma once

#include "attention_common.cuh"

namespace stratified {

constexpr int kFwdChunk = 32;     // keys per round
constexpr int kFwdThreads = 256;  // 8 warps per block
// floats per staged q/k/v row and per table row: 16-byte rows whose float4
// reads by 8 neighbouring rows fall on distinct banks
constexpr int kFwdRowStride = 20;
// table rows per axis: the three bins of a pair are packed 8 bits each
constexpr int kFwdMaxNb = 256;

// Query side, in the kernel's row order: q rows of q_rs floats (head stride
// D, channel stride 1; pre-scaling by `scale` happens in the kernel); row r
// reads q row map[r] and writes output row map[r] (map null: row r).
// key_lo/key_hi bound each row's keys; skey (null for the band half)
// excludes keys of the row's own small window.
struct FwdQueries {
  const float* q;
  int q_rs;
  const int32_t* map;
  const float* xyz;      // [N,3] in the kernel's row order
  const uint8_t* valid;
  const int32_t* key_lo;
  const int32_t* key_hi;
  const int32_t* skey;
};

// Key side: key slot p reads k/v row src[p] (src null: row p; src[p] < 0:
// an empty slot, never unmasked), rows of k_rs / v_rs floats; [K,3] xyz,
// [K] valid, [K] skey or null.
struct FwdKeys {
  const float* k;
  int k_rs;
  const float* v;
  int v_rs;
  const int32_t* src;
  const float* xyz;
  const uint8_t* valid;
  const int32_t* skey;
};

// cRPE tables in the model's layout, [nb_full][H][D][3] (each may be null),
// of which rows [bin_lo, bin_lo + nb) are read: the stratified bins of
// rel_bin (bin_offset, inv_quant), or in the swin mode (kSwin) Swin3D's
// window-quantized bins of swin_bin (the coordinates are the points'
// quantized positions, bin_lo 0, nb = nb_full; table_bin).
struct FwdTables {
  const float* tq;
  const float* tk;
  const float* tv;
  int nb;
  int bin_lo;
  int nb_full;
  float bin_offset;
  float inv_quant;
};

// acc [N,H,D], m [N,H], den [N,H], rows as FwdQueries::map.
struct FwdOutputs {
  float* acc;
  float* m;
  float* den;
};

// Shared-memory layout of a block of R rows (offsets in 4-byte words, each
// array 16-byte aligned). Per-row arrays of (axis, bin) entries have an odd
// stride (3·nb + 1) so that neighbouring rows fall on other banks.
template <int R, bool kProj>
struct FwdSmem {
  static constexpr int C = kFwdChunk;
  static constexpr int S = kFwdRowStride;
  int nb3, ps;
  int tab, q, k, v, xk, skey, qp, mass, kp, total;

  __host__ __device__ static int up4(int x) { return (x + 3) & ~3; }
  __host__ __device__ explicit FwdSmem(int nb) : nb3(3 * nb), ps(3 * nb + 1) {
    int o = 0;
    tab = o;                              // per-pair form: Tq, Tk, Tv
    if (!kProj) o += 3 * nb3 * S;         // [3][3·nb][S]
    q = o;    o += R * S;                 // the rows' scaled q
    k = o;    o += C * S;
    v = o;    o += C * S;
    xk = o;   o += 4 * C;                 // xyz, valid
    skey = o; o += C;
    qp = mass = kp = o;
    if (kProj) {
      qp = o;   o += up4(R * ps);         // q·Tq [R][ps]
      mass = o; o += up4(R * ps);         // Σ p per (axis, bin) [R][ps]
      kp = o;   o += up4(C * ps);         // k·Tk [C][ps]
    }
    total = o;
  }
  __host__ size_t bytes() const {
    return sizeof(float) * static_cast<size_t>(total);
  }
};

// The most table rows per axis (at most kFwdMaxNb) for which a block of R
// rows fits in `room` bytes.
template <int R, bool kProj>
__host__ int fwd_max_nb(size_t room) {
  int nb = kFwdMaxNb;
  while (nb > 0 && FwdSmem<R, kProj>(nb).bytes() > room) --nb;
  return nb;
}

// The 3·D floats of one bin and head of a table in the model's
// [nb_full][H][D][3] layout (channel-major, the three axes interleaved), as
// float4s read through the read-only cache.
template <int D>
__device__ __forceinline__ const float4* table_row(const float* t, int bin,
                                                   int h, int head) {
  return reinterpret_cast<const float4*>(
      t + (static_cast<size_t>(bin) * h + head) * 3 * D);
}

// x · T[bin][:, a] for the three axes a at once, from one table_row.
template <int D>
__device__ __forceinline__ void project3(const float4* row, const float* x,
                                         float* out) {
#pragma unroll
  for (int f = 0; f < 3 * D / 4; ++f) {
    const float4 v = __ldg(row + f);
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int ca = 4 * f + w;         // channel ca / 3, axis ca % 3
      out[ca % 3] = fmaf(x[ca / 3], e[w], out[ca % 3]);
    }
  }
}

// The forward of rows [row0, row0 + R), for the head blockIdx.y, over keys
// [win_lo, win_hi) ∩ the union of the rows' [key_lo, key_hi).
template <int D, int R, bool kProj>
__device__ void attention_fwd_block(const FwdQueries& Q, const FwdKeys& K,
                                    const FwdTables& T, const FwdOutputs& O,
                                    int h, int row0, int win_lo, int win_hi,
                                    float scale) {
  constexpr int NT = kFwdThreads;
  constexpr int C = kFwdChunk;
  constexpr int S = kFwdRowStride;
  constexpr int LPR = NT / R;           // lanes per row
  constexpr int KPL = C / LPR;          // keys per lane and chunk, at most
  static_assert(D % 4 == 0 && D <= S, "rows are read as float4");
  static_assert(NT % R == 0 && LPR <= 32 && C % LPR == 0, "rows per block");
  // the projection form takes Tv through the bin masses, the per-pair form
  // adds the Tv rows to v per pair
  static_assert(!kProj || LPR >= 4, "the mass walk takes a lane per axis");

  extern __shared__ __align__(16) float smem[];
  __shared__ int s_lo, s_hi;
  const FwdSmem<R, kProj> L(T.nb);
  const int nb = T.nb, nb3 = L.nb3, ps = L.ps;
  const bool tabs = nb > 0;
  float* s_tab = smem + L.tab;
  float* s_q = smem + L.q;
  float* s_k = smem + L.k;
  float* s_v = smem + L.v;
  float* s_xk = smem + L.xk;
  int* s_skey = reinterpret_cast<int*>(smem + L.skey);
  float* s_qp = smem + L.qp;
  float* s_mass = smem + L.mass;
  float* s_kp = smem + L.kp;

  const int head = blockIdx.y;
  const int tid = threadIdx.x;

  // ---- the rows' scaled q; per-pair form: the head's tables transposed
  //      into [table][axis][bin][D]; loads issued four at a time ----------
  for (int i0 = tid; i0 < R * D; i0 += 4 * NT) {
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * NT;
      x[u] = 0.0f;
      if (i < R * D) {
        const int t = i / D, c = i - t * D;
        const int r = row0 + t;
        const int src = Q.map != nullptr ? Q.map[r] : r;
        x[u] = Q.q[static_cast<size_t>(src) * Q.q_rs + head * D + c];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * NT;
      if (i < R * D) s_q[(i / D) * S + i % D] = x[u] * scale;
    }
  }
  if (!kProj && tabs) {
    // a thread per (table, bin): its 12 float4s loaded together, then
    // stored to the three axes' rows
    const float* tabs_in[3] = {T.tq, T.tk, T.tv};
    for (int rb = tid; rb < 3 * nb; rb += NT) {
      const int tb = rb / nb, b = rb - tb * nb;
      float4 x[3 * D / 4];
#pragma unroll
      for (int f = 0; f < 3 * D / 4; ++f)
        x[f] = tabs_in[tb] != nullptr
                   ? __ldg(table_row<D>(tabs_in[tb], T.bin_lo + b, h, head) + f)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float* dst = s_tab + (tb * nb3 + b) * S;
#pragma unroll
      for (int f = 0; f < 3 * D / 4; ++f) {
        const float e[4] = {x[f].x, x[f].y, x[f].z, x[f].w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int ca = 4 * f + w;     // channel ca / 3, axis ca % 3
          dst[(ca % 3) * nb * S + ca / 3] = e[w];
        }
      }
    }
  }
  if (kProj) {
    for (int i = tid; i < R * ps; i += NT) s_mass[i] = 0.0f;
  }
  if (tid == 0) {
    s_lo = win_hi;
    s_hi = win_lo;
  }
  __syncthreads();

  const int t = tid / LPR, sub = tid % LPR;
  const int row = row0 + t;
  const bool row_ok = Q.valid[row] != 0;
  const int ks = row_ok ? Q.key_lo[row] : 0;
  const int ke = row_ok ? Q.key_hi[row] : 0;
  const int skey = Q.skey != nullptr ? Q.skey[row] : 0;
  if (sub == 0 && row_ok && ke > ks) {
    atomicMin(&s_lo, ks);
    atomicMax(&s_hi, ke);
  }
  float q[D];
#pragma unroll
  for (int c = 0; c < D; c += 4) lds4(s_q + t * S + c, q + c);
  const float xq[3] = {Q.xyz[row * 3 + 0], Q.xyz[row * 3 + 1],
                       Q.xyz[row * 3 + 2]};
  if (kProj && tabs) {
    // the rows' projections onto Tq: a thread keeps one row's q in
    // registers and takes every (NT / R)-th bin, all three axes at once
    const int tt = tid % R;
    float qr[D];
#pragma unroll
    for (int c = 0; c < D; c += 4) lds4(s_q + tt * S + c, qr + c);
    for (int b = tid / R; b < nb; b += NT / R) {
      float pr[3] = {0.0f, 0.0f, 0.0f};
      if (T.tq != nullptr)
        project3<D>(table_row<D>(T.tq, T.bin_lo + b, h, head), qr, pr);
#pragma unroll
      for (int a = 0; a < 3; ++a) s_qp[tt * ps + a * nb + b] = pr[a];
    }
  }
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.0f;
  float m = kNegInf, den = 0.0f;
  __syncthreads();
  const int lo = max(s_lo, win_lo);
  const int hi = min(s_hi, win_hi);
  const int ks_w = max(ks, lo);         // the row's first key in the window

  for (int c0 = lo; c0 < hi; c0 += C) {
    const int cn = min(C, hi - c0);
    for (int i0 = tid; i0 < cn * D; i0 += 2 * NT) {
      float kx[2], vx[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u * NT;
        kx[u] = vx[u] = 0.0f;
        if (i < cn * D) {
          const int j = i / D, c = i - j * D;
          const int src = K.src != nullptr ? K.src[c0 + j] : c0 + j;
          if (src >= 0) {
            kx[u] = K.k[static_cast<size_t>(src) * K.k_rs + head * D + c];
            vx[u] = K.v[static_cast<size_t>(src) * K.v_rs + head * D + c];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u * NT;
        if (i < cn * D) {
          s_k[(i / D) * S + i % D] = kx[u];
          s_v[(i / D) * S + i % D] = vx[u];
        }
      }
    }
    for (int j = tid; j < cn; j += NT) {
      const int p = c0 + j;
      s_xk[j * 4 + 0] = K.xyz[p * 3 + 0];
      s_xk[j * 4 + 1] = K.xyz[p * 3 + 1];
      s_xk[j * 4 + 2] = K.xyz[p * 3 + 2];
      s_xk[j * 4 + 3] = K.valid[p] ? 1.0f : 0.0f;
      s_skey[j] = K.skey != nullptr ? K.skey[p] : 0;
    }
    __syncthreads();

    if (kProj) {
      // the chunk's keys projected onto Tk: a thread keeps one key in
      // registers and takes every (NT / C)-th bin, all three axes at once
      if (tabs && (tid & (C - 1)) < cn) {
        const int j = tid & (C - 1);
        float kr[D];
#pragma unroll
        for (int c = 0; c < D; c += 4) lds4(s_k + j * S + c, kr + c);
        for (int b = tid / C; b < nb; b += NT / C) {
          float pr[3] = {0.0f, 0.0f, 0.0f};
          if (T.tk != nullptr)
            project3<D>(table_row<D>(T.tk, T.bin_lo + b, h, head), kr, pr);
#pragma unroll
          for (int a = 0; a < 3; ++a) s_kp[j * ps + a * nb + b] = pr[a];
        }
      }
      __syncthreads();
    }

    // ---- pass 1: the logits of the row's keys in the chunk --------------
    const bool reach = row_ok && ks_w < c0 + cn && ke > c0;
    const int rlo = reach ? max(ks_w - c0, 0) : 0;
    const int rhi = reach ? min(ke - c0, cn) : 0;
    float l[KPL];
    int pk[KPL];
    unsigned ok = 0u;
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      const int j = rlo + sub + u * LPR;
      l[u] = 0.0f;
      pk[u] = 0;
      if (j < rhi) {
        float xk[4];
        lds4(s_xk + j * 4, xk);
        if (xk[3] != 0.0f && (K.skey == nullptr || s_skey[j] != skey)) {
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
              const int bn = table_bin<false>(T, __fsub_rn(xq[ax], xk[ax]));
              packed |= bn << (8 * ax);
              if (kProj) {
                s += s_qp[t * ps + ax * nb + bn] + s_kp[j * ps + ax * nb + bn];
              } else {
                const float* rq = s_tab + (ax * nb + bn) * S;
                const float* rk = s_tab + (nb3 + ax * nb + bn) * S;
                float sq = 0.0f, sk = 0.0f;
#pragma unroll
                for (int c = 0; c < D; c += 4) {
                  float tq[4], tk[4];
                  lds4(rq + c, tq);
                  lds4(rk + c, tk);
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    sq = fmaf(q[c + e], tq[e], sq);
                    sk = fmaf(kc[c + e], tk[e], sk);
                  }
                }
                s += sq + sk;
              }
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
    mx = group_max<LPR>(mx);
    if (mx > m) {
      const float r = expf(m - mx);     // 0 while the row has no key yet
      den *= r;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] *= r;
      if (kProj && tabs && m > kNegInf) {
        for (int ab = sub; ab < nb3; ab += LPR) s_mass[t * ps + ab] *= r;
      }
      m = mx;
    }

    // ---- pass 2: p, den, acc (p replaces the logit in l[u]) ------------
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      const int j = rlo + sub + u * LPR;
      float p = 0.0f;
      if (j < rhi && ((ok >> u) & 1u)) {
        p = expf(l[u] - m);
        den += p;
        float vc[D];
#pragma unroll
        for (int c = 0; c < D; c += 4) lds4(s_v + j * S + c, vc + c);
        if (!kProj && tabs) {
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            const float* rv = s_tab +
                (2 * nb3 + ax * nb + ((pk[u] >> (8 * ax)) & 255)) * S;
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
      l[u] = p;
    }

    if (kProj && tabs) {
      // the row's masses: lane ax of the row takes the chunk's keys of the
      // row in order (p and bins by shuffles from the lanes that own them)
      // and adds a run of keys in one bin with one read-modify-write
      __syncwarp();                     // after the rescale of the masses
      const int kmax = static_cast<int>(__reduce_max_sync(
          0xffffffffu, static_cast<unsigned>(rhi - rlo)));
      const int first = (tid & 31) & ~(LPR - 1);
      float* mrow = s_mass + t * ps + (sub < 3 ? sub : 0) * nb;
      float run = 0.0f;
      int cur = -1;
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        if (u * LPR >= kmax) break;
#pragma unroll
        for (int s2 = 0; s2 < LPR; ++s2) {
          const float p = __shfl_sync(0xffffffffu, l[u], first + s2);
          const int pb = __shfl_sync(0xffffffffu, pk[u], first + s2);
          if (sub < 3 && p != 0.0f) {
            const int idx = (pb >> (8 * sub)) & 255;
            if (idx == cur) {
              run += p;
            } else {
              if (cur >= 0) mrow[cur] += run;
              cur = idx;
              run = p;
            }
          }
        }
      }
      if (sub < 3 && cur >= 0) mrow[cur] += run;
    }
    __syncthreads();
  }

  // ---- end of block: the projection form's Tv term Σ mass·Tv (each lane
  //      every LPR-th bin), then the row's lanes add their parts -----------
  if (kProj && T.tv != nullptr) {
    for (int b = sub; b < nb; b += LPR) {
      const float mv[3] = {s_mass[t * ps + b], s_mass[t * ps + nb + b],
                           s_mass[t * ps + 2 * nb + b]};
      if (mv[0] != 0.0f || mv[1] != 0.0f || mv[2] != 0.0f) {
        const float4* tv = table_row<D>(T.tv, T.bin_lo + b, h, head);
#pragma unroll
        for (int f = 0; f < 3 * D / 4; ++f) {
          const float4 x = __ldg(tv + f);
          const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int ca = 4 * f + w;   // channel ca / 3, axis ca % 3
            acc[ca / 3] = fmaf(mv[ca % 3], e[w], acc[ca / 3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = group_sum<LPR>(acc[c]);
  den = group_sum<LPR>(den);
  if (sub == 0) {
    const int dst = Q.map != nullptr ? Q.map[row] : row;
    const size_t o = static_cast<size_t>(dst) * h + head;
    float4* out = reinterpret_cast<float4*>(O.acc + o * D);
#pragma unroll
    for (int c = 0; c < D; c += 4)
      out[c / 4] = make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
    O.m[o] = m;
    O.den[o] = den;
  }
}

}  // namespace stratified
