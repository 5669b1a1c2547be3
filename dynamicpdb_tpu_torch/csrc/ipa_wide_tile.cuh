// The tile machinery of the four IPA kernels on the TF32 tensor cores at
// the widths past ipa_tile.cuh's limits (C > 256, Pq*3 > 32, Pv*3 > 48 or
// Dz > 32): the forward (ipa_attention_wide_tc_fwd.cu) and the three
// kernels of the backward (ipa_attention_wide_tc_bwd.cu: dq, dk/dv, pair).
// It reuses ipa_tile.cuh's width-free pieces (the Layout, fragment loads
// and splits, qk_partial, the exchange slots, ipa_logit) and replaces what
// that header sizes for C <= 256 and Dz <= 32.
//
// Why another layout. ipa_tile.cuh gives each 16-row query tile four
// channel-quarter warps that hold their quarter of q (and in the backward
// of g_o) as A fragments and of o as accumulators: 64 registers of 255 at
// C = 256. At C = 384 that is 96, and the kernels already sit at 255, so
// they would spill; at Dz = 64 its pair_z tiles (32 rows x 16 keys x Dz,
// 131 KB) and C = 384's double-buffered key tiles (99 KB) do not fit 227
// KB together. Here a block owns ONE 16-row query tile (dk/dv: one 16-key
// tile) and splits C over EIGHT warps (channel slices of CQ = 8 NT
// channels, NT = 4 up to C = 256 and 6 up to 384): a warp holds 24
// registers of q and 24 of o at C = 384, and the block's rows' pair_z
// step is 16 rows x 16 keys (66 KB at Dz = 64). The price: 16 rows a
// block, so each block walks the keys for half as many rows, and the
// exchange sums eight partial products, not four.
//
// Widths: C % 4 == 0 up to 384, Pq*3 <= 40, Pv*3 <= 56 (the 36 and 54 of
// no_qk_points 12 and no_v_points 18 padded to multiples of 8), Dz <= 64.
// Every loop runs to a compile-time bound; channels past C, point columns
// past Pq*3 and Pv*3 and pair channels past Dz are zeros in shared memory
// and in the fragments. Strides read by fragment loads are 4 mod 8 floats
// (Cs = 8 CQ + 4, 44, 60, 24, 20, 68, 516, 1028), so a warp's 32 lanes hit
// 32 banks; dk/dv's pair_z tiles are XOR-swizzled instead.
//
// One logit. logit_ij = c_qk q_i.k_j + c_b bias_ijh - 0.5 w_h dist_ij
// + inf (m_i m_j - 1), built by all four kernels with the same code: each
// warp's slice of q.k^T by ipa_tc::qk_partial, the slices summed in one
// fixed order (xsum8), the distance by row_norms, key_norms and
// point_dist, the terms added by ipa_tc::ipa_logit. The dk/dv kernel
// computes the tile transposed (keys x rows) with the passes of each
// product in mma3t's order, so each element comes from the same products
// in the same order. The backward's a_ij is therefore exp(l - lse) of the
// forward's own logit, on pad rows too.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "ipa_tile.cuh"

namespace ipa_wtc {

using ipa_tc::Carver;
using ipa_tc::KeyTile;
using ipa_tc::Layout;
using ipa_tc::at_rows;
using ipa_tc::atk;
using ipa_tc::atq;
using ipa_tc::bfrag_cols;
using ipa_tc::bfrag_rows;
using ipa_tc::deal;
using ipa_tc::ipa_logit;
using ipa_tc::load_afrag;
using ipa_tc::qk_partial;
using ipa_tc::smem_afrag;
using ipa_tc::split4;
using ipa_tc::split_ctile;
using ipa_tc::xput;
using ipa_tc::xset;
using ipa_tc::xval;

constexpr int kWarps = 8;             // channel slices of the one row tile
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;             // query rows per block
constexpr int kKeys = 16;             // keys per step: 2 score n-tiles
constexpr int kMaxC = 384;            // C <= 384: CQ <= 48 per warp
constexpr int kMaxNT = kMaxC / 64;    // 8-channel tiles per warp
constexpr int kMaxP3q = 40;           // Pq <= 13: 5 k-steps of qp.kp
constexpr int kMaxP3v = 56;           // Pv <= 18: 7 n-tiles of p.vp
constexpr int kMaxDz = 64;            // 8 pair channels per warp (pair)
constexpr int kBS = kKeys + 8;        // bias tile row stride
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90
constexpr float kNegInit = -1e30f;    // running-max start, as the TPU kernel

constexpr int kKQ = kMaxP3q / 8;
constexpr int kNV = kMaxP3v / 8;
constexpr int kP3qs = kMaxP3q + 4;
constexpr int kP3vs = kMaxP3v + 4;

// Exchange slots ([value][lane], 8 floats a lane): each warp's slice of
// q.k^T, the point distances, then the backward's slices of g_o.v^T and
// its small products. The forward carves the first kFwdSlots.
enum Slot { kQK = 0, kDist = 8, kGV = 9, kGVP = 17, kGPZ = 18, kSlots = 19 };
constexpr int kFwdSlots = kDist + 1;
// dq and dk/dv take the pair term in two channel halves: kGPZ, kGPZ + 1
constexpr int kBwdSlots = kSlots + 1;
constexpr int kSlotFloats = 8 * 32;

// NT of the kernel instance that takes C
inline int tiles_for(int C) { return C <= 256 ? 4 : kMaxNT; }

inline Layout make_layout(int Nq, int Nk, int H, int C, int P3q, int P3v,
                          int Dz, float c_qk, float c_b, float inf,
                          bool pz_aligned) {
  Layout L;
  L.Nq = Nq, L.Nk = Nk, L.H = H, L.C = C, L.P3q = P3q, L.P3v = P3v, L.Dz = Dz;
  L.CQ = 8 * tiles_for(C);
  L.Cs = kWarps * L.CQ + 4;
  L.pz_vec = Dz % 4 == 0 && pz_aligned;
  L.c_qk = c_qk, L.c_b = c_b, L.inf = inf;
  return L;
}

inline bool layout_ok(int Nq, int Nk, int H, int C, int P3q, int P3v,
                      int Dz) {
  return Nq >= 1 && Nk >= 1 && H >= 1 && H <= 65535 && C >= 4 &&
         C % 4 == 0 && C <= kMaxC && P3q >= 1 && P3q <= kMaxP3q &&
         P3v >= 1 && P3v <= kMaxP3v && Dz >= 1 && Dz <= kMaxDz;
}

__host__ __device__ inline KeyTile wide_key_tile(Carver& c,
                                                 const Layout& L) {
  KeyTile t;
  t.k = c.take((size_t)kKeys * L.Cs);
  t.v = c.take((size_t)kKeys * L.Cs);
  t.kp = c.take((size_t)kKeys * kP3qs);
  t.vp = c.take((size_t)kKeys * kP3vs);
  t.km = c.take(kKeys);
  t.bias = c.take((size_t)kRows * kBS);
  return t;
}

// Two key tiles (double-buffered key steps), the key points' norms and the
// exchange of `slots` slots.
struct Common {
  float* kt;
  size_t tile_floats;
  float* ksq;  // [kKeys]: |kp|^2 of the step, warp 0 only
  float* xch;  // [slots][kSlotFloats]
  __host__ __device__ void carve(Carver& c, const Layout& L, int slots) {
    Carver one(nullptr);
    wide_key_tile(one, L);
    tile_floats = one.n;
    kt = c.take(2 * tile_floats);
    ksq = c.take(kKeys);
    xch = c.take((size_t)slots * kSlotFloats);
  }
  __device__ KeyTile tile(int b, const Layout& L) const {
    Carver c(kt + b * tile_floats);
    return wide_key_tile(c, L);
  }
};

// Zero the channels [C, 8 CQ) of k and v and the point columns past P3q
// and P3v of both key tiles once (cp.async never writes them).
__device__ void zero_padding(const Common& s, const Layout& L) {
  const int pc = kWarps * L.CQ - L.C;
  const int pq = kMaxP3q - L.P3q, pv = kMaxP3v - L.P3v;
  for (int b = 0; b < 2; ++b) {
    const KeyTile t = s.tile(b, L);
    if (pc)
      deal(kKeys, pc, threadIdx.x, kThreads, [&](int r, int x) {
        t.k[r * L.Cs + L.C + x] = 0.f;
        t.v[r * L.Cs + L.C + x] = 0.f;
      });
    if (pq)
      deal(kKeys, pq, threadIdx.x, kThreads,
           [&](int r, int x) { t.kp[r * kP3qs + L.P3q + x] = 0.f; });
    if (pv)
      deal(kKeys, pv, threadIdx.x, kThreads,
           [&](int r, int x) { t.vp[r * kP3vs + L.P3v + x] = 0.f; });
  }
}

// The key step at j0 of (f, h) into tile t, with the bias tile of the
// block's rows i0.. i0 + 15, by the whole block, as one cp.async group
// (committed even when empty). Keys past Nk and rows past Nq zero-filled.
__device__ void fetch_key_step(const KeyTile& t,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ kp,
                               const float* __restrict__ vp,
                               const float* __restrict__ kmask,
                               const float* __restrict__ bias, int f, int h,
                               int i0, int j0, bool any, const Layout& L) {
  const int tid = threadIdx.x;
  if (any) {
    const int nk = min(kKeys, L.Nk - j0);
    deal(kKeys, L.C / 4, tid, kThreads, [&](int r, int c4) {
      const bool ok = r < nk;
      const size_t src = ok ? atk(L, f, j0 + r, h, L.C, 4 * c4) : 0;
      cp_async16(t.k + r * L.Cs + 4 * c4, k + src, ok);
      cp_async16(t.v + r * L.Cs + 4 * c4, v + src, ok);
    });
    deal(kKeys, L.P3q, tid, kThreads, [&](int r, int x) {
      const bool ok = r < nk;
      cp_async4(t.kp + r * kP3qs + x,
                kp + (ok ? atk(L, f, j0 + r, h, L.P3q, x) : 0), ok);
    });
    deal(kKeys, L.P3v, tid, kThreads, [&](int r, int x) {
      const bool ok = r < nk;
      cp_async4(t.vp + r * kP3vs + x,
                vp + (ok ? atk(L, f, j0 + r, h, L.P3v, x) : 0), ok);
    });
    if (tid < kKeys) {
      const bool ok = tid < nk;
      cp_async4(t.km + tid, kmask + (ok ? (size_t)f * L.Nk + j0 + tid : 0),
                ok);
    }
    {  // kRows * kKeys == kThreads: one bias element a thread
      const int r = tid / kKeys, c = tid % kKeys, i = i0 + r;
      const bool ok = i < L.Nq && c < nk;
      cp_async4(t.bias + r * kBS + c,
                bias + (ok ? ((size_t)i * L.Nk + j0 + c) * L.H + h : 0), ok);
    }
  }
  cp_async_commit();
}

// A pair warp's pair_z tile row in the row-stationary kernels (forward and
// dq): [key][32 channels].
constexpr int kPZh = kKeys * 32 + 4;

// pair_z rows r0.. r0 + 7, keys j0.. j0 + 15 and channels c0.. c0 + 31
// into dst [8][kPZh], by one warp, as one cp.async group; zeros past Nq,
// Nk and Dz.
__device__ void fetch_pz(float* dst, const float* __restrict__ pz, int r0,
                         int j0, int c0, const Layout& L) {
  const int lane = threadIdx.x & 31;
  const int nk = min(kKeys, L.Nk - j0);
  for (int r = 0; r < 8; ++r) {
    const int i = r0 + r;
    const float* src = pz + ((size_t)min(i, L.Nq - 1) * L.Nk + j0) * L.Dz;
    float* d = dst + r * kPZh;
    if (L.pz_vec) {
      for (int e = lane; e < kKeys * 8; e += 32) {
        const int key = e >> 3, x = 4 * (e & 7);
        const bool ok = i < L.Nq && key < nk && c0 + x < L.Dz;
        cp_async16(d + key * 32 + x, ok ? src + key * L.Dz + c0 + x : pz, ok);
      }
    } else {
      for (int e = lane; e < kKeys * 32; e += 32) {
        const int key = e >> 5, x = e & 31;
        const bool ok = i < L.Nq && key < nk && c0 + x < L.Dz;
        cp_async4(d + key * 32 + x, ok ? src + key * L.Dz + c0 + x : pz, ok);
      }
    }
  }
  cp_async_commit();
}

// Rows i0.. i0 + 15 of the (f, h) rows of a query-side [F, Nq, H, D]
// tensor into dst [kRows][stride], columns [0, width) with zeros past D
// and past Nq, by the whole block; not committed.
__device__ void fetch_row_block(float* dst, int stride, int width,
                                const float* __restrict__ x, int f, int h,
                                int i0, int D, const Layout& L) {
  deal(kRows, width, threadIdx.x, kThreads, [&](int r, int c) {
    const int i = i0 + r;
    const bool ok = i < L.Nq && c < D;
    cp_async4(dst + r * stride + c, x + (ok ? atq(L, f, i, h, D, c) : 0), ok);
  });
}

// |qp|^2 of rows g and g + 8 from this lane's A fragments of qp (zero past
// P3q), summed over the quad.
__device__ __forceinline__ void row_norms(float (&qsq)[2],
                                          const float (&qpa)[kKQ][4]) {
  qsq[0] = qsq[1] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKQ; ++ks) {
    qsq[0] += qpa[ks][0] * qpa[ks][0] + qpa[ks][2] * qpa[ks][2];
    qsq[1] += qpa[ks][1] * qpa[ks][1] + qpa[ks][3] * qpa[ks][3];
  }
  qsq[0] = quad_sum(qsq[0]);
  qsq[1] = quad_sum(qsq[1]);
}

// |kp|^2 of 16 keys (kp: [kKeys][kP3qs], zero past P3q) into ksq, by
// lanes 0..15 of one warp (the caller orders the reads with __syncwarp).
__device__ __forceinline__ void key_norms(float* ksq, const float* kp) {
  const int lane = threadIdx.x & 31;
  if (lane < kKeys) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxP3q; ++c)  // zero past P3q
      s += kp[lane * kP3qs + c] * kp[lane * kP3qs + c];
    ksq[lane] = s;
  }
}

// |kp|^2 of the step's keys
__device__ __forceinline__ void key_norms(float* ksq, const KeyTile& t) {
  key_norms(ksq, t.kp);
}

// dist[nt] = |qp_i|^2 + |kp_j|^2 - 2 qp_i.kp_j for the step's keys, the
// cross term on the tensor cores (3xTF32).
__device__ __forceinline__ void point_dist(float (&dist)[2][4],
                                           const float (&qpa)[kKQ][4],
                                           const float (&qsq)[2],
                                           const float* ksq,
                                           const KeyTile& t) {
  const int t4 = threadIdx.x & 3;
  float cross[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) cross[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKQ; ++ks) {
    uint32_t ah[4], al[4];
    split4(qpa[ks], ah, al);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t bh[2], bl[2];
      bfrag_rows(t.kp, kP3qs, n, 8 * ks, bh, bl);
      mma3(cross[n], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dist[n][e] = qsq[e >> 1] + ksq[8 * n + 2 * t4 + (e & 1)] -
                   2.f * cross[n][e];
}

// g_opt . vp^T of the block's 16 rows (sgopt: [kRows][kP3vs], zeros past
// Pv*3) and the step's keys in kt, 3xTF32, into slot kGVP.
__device__ __forceinline__ void gopt_vp(float* xch, const float* sgopt,
                                        const KeyTile& kt) {
  float gvp[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gvp[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kNV; ++ks) {
    float a[4];
    smem_afrag(a, sgopt, kP3vs, 8 * ks);
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t bh[2], bl[2];
      bfrag_rows(kt.vp, kP3vs, n, 8 * ks, bh, bl);
      mma3(gvp[n], ah, al, bh, bl);
    }
  }
  xput(xch, kGVP, gvp);
}

// A pair warp's sums part[jj] of row g + 8 rr (over this lane's pair
// channels) for the step's 16 keys, reduce-scattered over the quad: keys
// (jj & 7) < 4 to lanes t < 2 and the rest to t >= 2, then odd key pairs
// to odd t; each lane writes the keys of its fragment to slot s.
__device__ __forceinline__ void quad_scatter(float* xch, int s, int rr,
                                             const float (&part)[kKeys]) {
  const int t = threadIdx.x & 3;
  const bool lo2 = t < 2, even = (t & 1) == 0;
  float hf[8];
#pragma unroll
  for (int sl = 0; sl < 8; ++sl) {
    const int kl = sl < 4 ? sl : sl + 4, kh = kl + 4;
    const float send = lo2 ? part[kh] : part[kl];
    const float recv = __shfl_xor_sync(0xffffffffu, send, 2);
    hf[sl] = (lo2 ? part[kl] : part[kh]) + recv;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int sl = u < 2 ? u : u + 2, sh = sl + 2;
    const float send = even ? hf[sh] : hf[sl];
    const float recv = __shfl_xor_sync(0xffffffffu, send, 1);
    // key 8 (u / 2) + 2 t + u % 2 of row g + 8 rr
    xset(xch, s, u >> 1, 2 * rr + (u & 1), (even ? hf[sl] : hf[sh]) + recv);
  }
}

// The sum of the eight warps' slices of slot s (kQK or kGV), in the same
// order in every warp and both kernels.
__device__ __forceinline__ float xsum8(const float* xch, int s, int n,
                                       int e) {
  return ((xval(xch, s, n, e) + xval(xch, s + 1, n, e)) +
          (xval(xch, s + 2, n, e) + xval(xch, s + 3, n, e))) +
         ((xval(xch, s + 4, n, e) + xval(xch, s + 5, n, e)) +
          (xval(xch, s + 6, n, e) + xval(xch, s + 7, n, e)));
}

// The logit of rows g, g + 8 and keys 8 n + 2 t + {0, 1} of the step in
// kt from the exchange (slot kQK: the q.k^T slices, kDist: the distance).
__device__ __forceinline__ float tile_logit(const float* xch,
                                            const KeyTile& kt, int n, int e,
                                            const float (&qm)[2], float w,
                                            const Layout& L) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = e >> 1, c = 8 * n + 2 * t + (e & 1);
  return ipa_logit(xsum8(xch, kQK, n, e), kt.bias[(g + 8 * r) * kBS + c],
                   xval(xch, kDist, n, e), qm[r], kt.km[c], w, L);
}

}  // namespace ipa_wtc
