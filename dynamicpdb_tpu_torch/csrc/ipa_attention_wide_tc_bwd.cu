// Invariant Point Attention backward, the pair kernel, for sm_90a, on the
// TF32 tensor cores, at the widths past ipa_attention_bwd.cu's limits
// (C > 256, Pq*3 > 32, Pv*3 > 48 or Dz > 32) up to C = 384, Pq*3 = 40,
// Pv*3 = 56, Dz = 64 (ipa_wide_tile.cuh); past those the CUDA-core kernel
// (ipa_attention_wide_bwd.cu kernel C) takes them.
//
// Replaces the Pallas TPU kernel dynamicpdb_tpu/ops/pallas/ipa_attention.py
// _bwd_pair_kernel (:338), launched by the custom VJP (_ipa_attention_bwd
// :563) through _fused_ipa_backward (:369). Per (i, j) of Nq query rows
// against Nk keys, from the forward's saved row log-sum-exp and the row
// constant D_i = <g_out, out>_i:
//
//   logit_ij  = c_qk q_i.k_j + c_b bias_ijh - 0.5 w_h dist_ij
//               + inf (m_i m_j - 1)
//   a_ij      = exp(logit_ij - lse_i)
//   dl_ij     = a_ij (g_o_i.v_j + g_opt_i.vp_j + g_pair_i.pz_ij - D_i)
//   dbias_ijh = c_b sum_f dl_ij                  [Nq, Nk, H]
//   dpz_ij    = sum_{f,h} a_ij g_pair_i          [Nq, Nk, Dz]
//
// The logit comes from ipa_wide_tile.cuh's code, the wide tensor-core
// forward's (ipa_attention_wide_tc_fwd.cu), so a_ij is that forward's
// softmax. The wide route's dq and dk/dv kernels stay on the CUDA cores
// (ipa_attention_wide_bwd.cu) with a logit built in another order. Every
// output element has one writer (no atomics): the (head, frame) axis the
// TPU kernel walks in order is a loop inside the block. Rows past Nq and
// keys past Nk get a = dl = 0; pad rows (mask 0) are computed as the
// reference does. A rectangular call's dbias and dpz rows equal the square
// call's rows bit for bit.
//
// Bound on an H100 at wide-model (F=2, N=256, H=8, C=384, Pq=12, Pv=12,
// Dz=64; chip_smoke.ipa_bwd_cost, bounds): about 1,950 FLOP per
// (f, h, i, j) (the tile recompute and the pair sums), 2.05 GFLOP, 79% of
// it in q.k^T and g_o.v^T, against 66.4 MB of compulsory traffic. Every
// operation on the CUDA cores: 0.0305 ms; the products on the TF32 tensor
// cores in three passes: 0.0125 ms of arithmetic, so the bytes bound it,
// 0.0198 ms at 3.35 TB/s.
//
// Passes. q.k^T, g_o.v^T (C wide), qp.kp^T and g_opt.vp^T on the tensor
// cores in three passes (3xTF32, mma3); the pair term g_pair_i.pz_ij (a
// different matrix per query row) and dpz += a_ij g_pair_i (a rank-1
// update per (f, h)) on the CUDA cores in float32. 3xTF32 keeps BWD_RTOL on
// dbias and dpz at these widths, one pass misses it
// (tests/test_torch_ipa_precision.py).
//
// Layout: one block per (16 query rows, 16 keys), grid (ceil(Nk/16),
// ceil(Nq/16)), 256 blocks at wide-model; inside, the (head, frame) loop,
// the frame fastest. Eight warps split C in slices (ipa_wide_tile.cuh):
// warp w holds its slice of q and g_o as A fragments (24 registers each at
// C = 384), loaded from L2 for the next (f, h) as soon as this one's
// products have read them. Per (f, h) each warp computes its slices of
// q.k^T and g_o.v^T, warp 0 the point distances, warp 1 g_opt.vp^T,
// warps 2 and 3 the pair term of rows g and g + 8 (all Dz channels, a
// reduce-scatter over the quad); the exchange (one block barrier) gives
// every warp a and dl of its 8 elements; warp 0 keeps dbias over the
// frames in registers and writes it once per head, warp w keeps dpz of
// its 8 elements for pair channels 8 w.. 8 w + 7 in registers (64 a lane)
// and writes it once. The key tile of the next (f, h) (k, v, their
// points, key mask, bias) and the rows' points come by cp.async into the
// other of two buffers; the block's pair_z tile (16 rows x 16 keys x Dz)
// once. Shared memory at C = 384: 214,464 bytes (two key tiles 115,840,
// pair_z 65,792, exchange 19,456, points 13,312), one block an SM; ptxas:
// 254 registers at C = 384 (250 at C <= 256), no spills. What this does
// about the CUDA-core kernel's limits:
//   1. the attention recomputed per element on the CUDA cores (two C-long
//      dot products a thread): the C-wide products are mma tiles, split
//      over eight warps;
//   2. one pass per (h, f) with both tiles restaged and two block barriers:
//      the next (f, h)'s key tile arrives by cp.async while the block
//      computes, one block barrier an (f, h) and one exchange; q and g_o are
//      not staged;
//   3. each element's pair_z row read from L2 on every (h, f): the block's
//      pair_z tile staged once by 16-byte cp.async, read from shared
//      memory;
//   4. dpz accumulated per element in shared memory: in registers;
//   5. ipa_attention_bwd.cu kernel C's own limits (registers at C = 384,
//      64 dpz registers a lane at Dz = 32 already): eight channel slices,
//      each owning 8 of Dz <= 64 pair channels.
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "ipa_wide_tile.cuh"

namespace {

using namespace ipa_wtc;

constexpr int kPZs = kKeys * kMaxDz + 4;  // a pair_z tile row: [key][64]

struct Inputs {
  const float *q, *k, *v, *qp, *kp, *vp, *bias, *pz, *mask, *kmask, *hw,
      *lse, *dvec, *go, *gopt, *gpair;
};

struct SmemP {
  Common c;
  float* qp;    // [2][kRows][kP3qs]: the (f, h)'s query points, and
  float* gopt;  // [2][kRows][kP3vs]: their cotangents, with the key tiles
  float* pz;    // [kRows][kPZs]: the block's pair_z tile
  __host__ __device__ size_t carve(float* base, const Layout& L) {
    Carver cv(base);
    c.carve(cv, L, kSlots);
    qp = cv.take((size_t)2 * kRows * kP3qs);
    gopt = cv.take((size_t)2 * kRows * kP3vs);
    pz = cv.take((size_t)kRows * kPZs);
    return cv.n;
  }
};

// The block's pair_z tile (rows i0.. i0 + 15, keys j0.. j0 + 15, all kMaxDz
// channels) into dst, by the whole block; zeros past Nq, Nk and Dz; not
// committed.
__device__ void fetch_pz_tile(float* dst, const float* __restrict__ pz,
                              int i0, int j0, const Layout& L) {
  const int nk = min(kKeys, L.Nk - j0);
  const int per = L.pz_vec ? kMaxDz / 4 : kMaxDz;  // copies a (row, key)
  deal(kRows * kKeys, per, threadIdx.x, kThreads, [&](int rk, int c) {
    const int r = rk / kKeys, key = rk % kKeys, i = i0 + r;
    const int x = L.pz_vec ? 4 * c : c;
    const bool ok = i < L.Nq && key < nk && x < L.Dz;
    const float* src =
        ok ? pz + ((size_t)i * L.Nk + j0 + key) * L.Dz + x : pz;
    float* d = dst + r * kPZs + key * kMaxDz + x;
    if (L.pz_vec)
      cp_async16(d, src, ok);
    else
      cp_async4(d, src, ok);
  });
}

// Each warp's share of the products of the block's rows and the (f, h)'s
// key tile kt, into the exchange: its slices of q.k^T and g_o.v^T (qa,
// goa: raw A fragments, 3xTF32); warp 0 the point distances and warp 1
// g_opt.vp^T (sqp, sgopt: the rows' points and their cotangents in shared
// memory); warps 2 and 3 the pair term g_pair_i.pz_ij of rows g + 8 rr on
// the CUDA cores (gp: the lane's pair channels t + 4 m of g_pair_i): lane
// (g, t) sums its channels for all 16 keys, then a reduce-scatter over the
// quad hands each lane the keys of its fragment. read(0) runs once qa is
// read and read(1) once goa is.
template <int NT, typename Read>
__device__ __forceinline__ void tile_products(
    float* xch, float* sksq, const float (&qa)[NT][4],
    const float (&goa)[NT][4], const float* sqp, const float* sgopt,
    const float* spz, const float (&gp)[kMaxDz / 4], const KeyTile& kt,
    int col, int w, Read read, const Layout& L) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  {
    float x[2][4];
    qk_partial<NT>(
        x,
        [&](int ks, float (&a)[4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qa[ks][e];
        },
        kt.k, col, L);
    read(0);
    xput(xch, kQK + w, x);
    qk_partial<NT>(
        x,
        [&](int ks, float (&a)[4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = goa[ks][e];
        },
        kt.v, col, L);
    read(1);
    xput(xch, kGV + w, x);
  }
  if (w == 0) {
    float qpa[kKQ][4], qsq[2], dist[2][4];
#pragma unroll
    for (int ks = 0; ks < kKQ; ++ks) smem_afrag(qpa[ks], sqp, kP3qs, 8 * ks);
    row_norms(qsq, qpa);
    key_norms(sksq, kt);
    __syncwarp();
    point_dist(dist, qpa, qsq, sksq, kt);
    xput(xch, kDist, dist);
  } else if (w == 1) {
    // g_opt . vp^T, 3xTF32
    float gvp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) gvp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kNV; ++ks) {  // zeros past Pv*3
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
  } else if (w < 4) {
    // g_pair_i . pz_ij of row g + 8 rr: sums over this lane's pair
    // channels, then a reduce-scatter over the quad: keys (jj & 7) < 4 to
    // lanes t < 2 and the rest to t >= 2, then odd key pairs to odd t
    const int rr = w & 1;
    float part[kKeys];
    const float* z = spz + (8 * rr + g) * kPZs + t;  // zeros past Dz
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      float a = 0.f;
#pragma unroll
      for (int m = 0; m < kMaxDz / 4; ++m)
        a = fmaf(gp[m], z[jj * kMaxDz + 4 * m], a);
      part[jj] = a;
    }
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
      xset(xch, kGPZ, u >> 1, 2 * rr + (u & 1),
           (even ? hf[sl] : hf[sh]) + recv);
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
ipa_wtc_bwd_pair_kernel(Inputs in, Layout L, int F,
                        float* __restrict__ dbias, float* __restrict__ dpz) {
  extern __shared__ float4 smem4[];
  SmemP s;
  s.carve(reinterpret_cast<float*>(smem4), L);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kKeys, i0 = blockIdx.y * kRows;
  const int col = w * L.CQ;
  const bool pz_warp = w == 2 || w == 3;
  const int rr = w & 1;  // warps 2, 3: pair rows g + 8 rr
  const int n_it = F * L.H;  // (h, f), the frame fastest

  // the (f, h) of iteration `it`'s key tile and rows' points into buffer
  // it & 1, as one cp.async group (committed even when empty)
  auto fetch = [&](int it, bool any) {
    const int hh = it / F, ff = it - hh * F, b = it & 1;
    if (any) {
      fetch_row_block(s.qp + b * kRows * kP3qs, kP3qs, kMaxP3q, in.qp, ff,
                      hh, i0, L.P3q, L);
      fetch_row_block(s.gopt + b * kRows * kP3vs, kP3vs, kMaxP3v, in.gopt,
                      ff, hh, i0, L.P3v, L);
    }
    fetch_key_step(s.c.tile(b, L), in.k, in.v, in.kp, in.vp, in.kmask,
                   in.bias, ff, hh, i0, j0, any, L);
  };
  float qa[NT][4], goa[NT][4];  // this warp's slice of q and g_o
  auto load_q = [&](float (&x)[NT][4], const float* src, int it) {
    const int hh = it / F, ff = it - hh * F;
#pragma unroll
    for (int ks = 0; ks < NT; ++ks)
      load_afrag(x[ks], src, L, L.Nq, ff, hh, i0, L.C, col + 8 * ks, L.C);
  };
  // the (f, h) of iteration it's row operands: g_pair of the pair rows
  // (channels t + 4 m) and of rows g, g + 8 (channels 8 w + m), mask, lse, D
  float gp[kMaxDz / 4], gq[2][8], qm[2], lse[2], dvec[2];
  auto load_small = [&](int it) {
    const int h = it / F, f = it - h * F;
    if (pz_warp) {
      const int i = i0 + g + 8 * rr;
#pragma unroll
      for (int m = 0; m < kMaxDz / 4; ++m) {
        const int d = t + 4 * m;
        gp[m] = (i < L.Nq && d < L.Dz) ? in.gpair[atq(L, f, i, h, L.Dz, d)]
                                       : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + g + 8 * r;
      const bool ok = i < L.Nq;
      qm[r] = ok ? in.mask[(size_t)f * L.Nq + i] : 0.f;
      lse[r] = ok ? in.lse[((size_t)f * L.H + h) * L.Nq + i] : 0.f;
      dvec[r] = ok ? in.dvec[((size_t)f * L.H + h) * L.Nq + i] : 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int d = 8 * w + m;
        gq[r][m] =
            (ok && d < L.Dz) ? in.gpair[atq(L, f, i, h, L.Dz, d)] : 0.f;
      }
    }
  };

  zero_padding(s.c, L);
  fetch_pz_tile(s.pz, in.pz, i0, j0, L);  // once, with the first group
  fetch(0, true);
  load_q(qa, in.q, 0);
  load_q(goa, in.go, 0);
  load_small(0);

  // dpz of this lane's 8 elements for pair channels 8 w + m; dbias (over
  // the frames, warp 0)
  float dpa[2][4][8], dba[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dba[n][e] = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) dpa[n][e][m] = 0.f;
    }

  for (int it = 0; it < n_it; ++it) {
    const int h = it / F, f = it - h * F;
    const KeyTile kt = s.c.tile(it & 1, L);
    // this (f, h)'s tile has landed, and every warp is done with the last
    // (f, h), its buffer and the exchange
    cp_async_wait<0>();
    __syncthreads();
    fetch(it + 1, it + 1 < n_it);

    const float hw = in.hw[h];
    const int b = it & 1;
    const bool more = it + 1 < n_it;
    // the next (f, h)'s q and g_o as soon as this one's are read
    tile_products<NT>(s.c.xch, s.c.ksq, qa, goa, s.qp + b * kRows * kP3qs,
                      s.gopt + b * kRows * kP3vs, s.pz, gp, kt, col, w,
                      [&](int which) {
                        if (more) load_q(which ? goa : qa,
                                         which ? in.go : in.q, it + 1);
                      },
                      L);
    __syncthreads();  // the exchange

    // a and dl of rows g, g + 8 and keys j0 + 8 n + 2 t + {0, 1}; every
    // warp computes the same values; 0 past Nq and past Nk
    float a[2][4], dl[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = 8 * n + 2 * t + (e & 1);
        const bool valid = i0 + g + 8 * r < L.Nq && j0 + c < L.Nk;
        const float l = tile_logit(s.c.xch, kt, n, e, qm, hw, L);
        const float av = expf(l - lse[r]);
        const float v =
            av * ((xsum8(s.c.xch, kGV, n, e) + xval(s.c.xch, kGVP, n, e) +
                   xval(s.c.xch, kGPZ, n, e)) -
                  dvec[r]);
        a[n][e] = valid ? av : 0.f;
        dl[n][e] = valid ? v : 0.f;
      }
    if (w == 0) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dba[n][e] += dl[n][e];
      if (f == F - 1) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + g + 8 * (e >> 1);
            const int j = j0 + 8 * n + 2 * t + (e & 1);
            if (i < L.Nq && j < L.Nk)
              dbias[((size_t)i * L.Nk + j) * L.H + h] = L.c_b * dba[n][e];
            dba[n][e] = 0.f;
          }
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int m = 0; m < 8; ++m)
          dpa[n][e][m] = fmaf(a[n][e], gq[e >> 1][m], dpa[n][e][m]);
    if (more) load_small(it + 1);
  }

  // epilogue: dpz of rows g, g + 8 and keys 8 n + 2 t + {0, 1}
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1), j = j0 + 8 * n + 2 * t + (e & 1);
      if (i >= L.Nq || j >= L.Nk) continue;
      float* out = dpz + ((size_t)i * L.Nk + j) * L.Dz;
#pragma unroll
      for (int m = 0; m < 8; ++m)
        if (8 * w + m < L.Dz) out[8 * w + m] = dpa[n][e][m];
    }
}

size_t smem_bytes(const Layout& L) {
  SmemP none;
  return none.carve(nullptr, L) * sizeof(float);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = the
// launch was accepted). Arguments and layouts as ipa_attention_bwd_pair's
// (ipa_attention_bwd.cu): the 16 backward inputs (points [F, rows, H, P*3],
// lse and D [F, H, Nq], g_pair [F, Nq, H, Dz]), then dbias [Nq, Nk, H] and
// dpz [Nq, Nk, Dz]. All float32 and contiguous; q, k, v, g_o 16-byte
// aligned; C divisible by 4 and at most 384, Pq*3 <= 40, Pv*3 <= 56,
// Dz <= 64.
extern "C" int ipa_attention_wide_tc_bwd_pair(
    const float* q, const float* k, const float* v, const float* q_pts,
    const float* k_pts, const float* v_pts, const float* bias,
    const float* pair_z, const float* mask, const float* key_mask,
    const float* head_weights, const float* lse, const float* dvec,
    const float* g_o, const float* g_opt, const float* g_pair, float* dbias,
    float* dpz, int F, int Nq, int Nk, int H, int C, int Pq, int Pv, int Dz,
    float c_qk, float c_b, float inf, int device, cudaStream_t stream) {
  const Inputs in{q,     k,        v,            q_pts, k_pts, v_pts,
                  bias,  pair_z,   mask,         key_mask,
                  head_weights,    lse,          dvec,  g_o,   g_opt,
                  g_pair};
  if (F < 1 || F > 65535 || !layout_ok(Nq, Nk, H, C, 3 * Pq, 3 * Pv, Dz) ||
      (Nq + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const Layout L =
      make_layout(Nq, Nk, H, C, 3 * Pq, 3 * Pv, Dz, c_qk, c_b, inf,
                  (reinterpret_cast<uintptr_t>(pair_z) & 15) == 0);
  const size_t smem = smem_bytes(L);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto kernel = tiles_for(C) == kMaxNT ? ipa_wtc_bwd_pair_kernel<kMaxNT>
                                       : ipa_wtc_bwd_pair_kernel<4>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Nk + kKeys - 1) / kKeys, (Nq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(in, L, F, dbias, dpz);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block (bytes) of the pair kernel at these
// widths.
extern "C" long long ipa_attention_wide_tc_bwd_smem(int C, int Pq, int Pv,
                                                    int Dz) {
  return (long long)smem_bytes(make_layout(1, 1, 1, C, 3 * Pq, 3 * Pv, Dz,
                                           0.f, 0.f, 0.f, true));
}

extern "C" const char* ipa_attention_wide_tc_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
