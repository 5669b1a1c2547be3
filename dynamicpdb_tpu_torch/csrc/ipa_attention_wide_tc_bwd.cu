// Invariant Point Attention backward for sm_90a, three kernels on the TF32
// tensor cores, at the widths past ipa_attention_bwd.cu's limits (C > 256,
// Pq*3 > 32, Pv*3 > 48 or Dz > 32) up to C = 384, Pq*3 = 40, Pv*3 = 56,
// Dz = 64 (ipa_wide_tile.cuh); past those the CUDA-core kernels
// (ipa_attention_wide_bwd.cu) take them.
//
// Replaces the three Pallas TPU kernels of
// dynamicpdb_tpu/ops/pallas/ipa_attention.py that the custom VJP
// (_ipa_attention_bwd :563) launches through _fused_ipa_backward (:369),
// which name no width limit, at model.ipa.c_z = 256 (Dz = 64), c_hidden =
// 384 (C = 384), no_qk_points = 12 (Pq*3 = 36), no_v_points = 18
// (Pv*3 = 54):
//
//   kernel A  ipa_wtc_bwd_dq_kernel    <- _bwd_dq_kernel   (:259, call :413)
//   kernel B  ipa_wtc_bwd_dkv_kernel   <- _bwd_dkv_kernel  (:297, call :445)
//   kernel C  ipa_wtc_bwd_pair_kernel  <- _bwd_pair_kernel (:338, call :480)
//
// Each recomputes the attention tile of Nq query rows against Nk keys, as
// _tile_a_dl (:240) does, from the forward's saved row log-sum-exp and the
// row constant D_i = <g_out, out>_i:
//
//   logit_ij  = c_qk q_i.k_j + c_b bias_ijh - 0.5 w_h dist_ij
//               + inf (m_i m_j - 1)
//   a_ij      = exp(logit_ij - lse_i)
//   dl_ij     = a_ij (g_o_i.v_j + g_opt_i.vp_j + g_pair_i.pz_ij - D_i)
//
// and accumulates
//
//   A, per (f, h, i):  dq_i   = c_qk sum_j dl_ij k_j             [C]
//                      dqp_i  = -w_h (sum_j dl_ij qp_i - sum_j dl_ij kp_j)
//                      dhw_i  = sum_j -0.5 dist_ij dl_ij   (summed over f, i
//                                                           by the caller)
//   B, per (f, h, j):  dk_j   = c_qk sum_i dl_ij q_i             [C]
//                      dkp_j  = -w_h (sum_i dl_ij kp_j - sum_i dl_ij qp_i)
//                      dv_j   = sum_i a_ij g_o_i                 [C]
//                      dvp_j  = sum_i a_ij g_opt_i
//   C, per (i, j):     dbias_ijh = c_b sum_f dl_ij               [Nq, Nk, H]
//                      dpz_ij    = sum_{f,h} a_ij g_pair_i       [Nq, Nk, Dz]
//
// All three build the logit with ipa_wide_tile.cuh's code, the wide
// tensor-core forward's (ipa_attention_wide_tc_fwd.cu): each warp's slice
// of q.k^T by qk_partial (B: transposed, in mma3t's pass order), the
// slices summed by xsum8, the distance by row_norms, key_norms and the
// same cross product, the terms added by ipa_logit. So a_ij is that
// forward's softmax, on pad rows too. Every output element has one writer
// (no atomics): the axis the TPU kernel walks in order is a loop inside the
// block. Rows past Nq and keys past Nk get a = dl = 0; pad rows (mask 0)
// are computed as the reference does (inf = 1e5, no key skipped). A
// rectangular call's dq, dqp, dhw, dbias and dpz rows equal the square
// call's rows bit for bit; its dk, dkp, dv, dvp are the sums over its rows.
//
// Passes. Every product of C, Pq*3 or Pv*3 terms (q.k^T, g_o.v^T, qp.kp^T,
// g_opt.vp^T, and A's dl.k, dl.kp, B's dl^T.q, dl^T.qp, a^T.g_o,
// a^T.g_opt) runs on the tensor cores in three passes of operands split
// into a TF32 high and low part (3xTF32, tf32_mma.cuh split, mma3); one
// pass misses BWD_RTOL at these widths (tests/test_torch_ipa_precision.py).
// The pair terms, a different matrix per query row (g_pair_i.pz_ij, and C's
// dpz += a_ij g_pair_i), run on the CUDA cores in float32.
//
// Kernel A (dq). Bound on an H100 at wide-model (F=2, N=256, H=8, C=384,
// Pq=12, Pv=12, Dz=64; chip_smoke.ipa_bwd_cost, bounds): about 2,670 FLOP
// per (f, h, i, j), 2.80 GFLOP, 99% of it in products (87% C wide), against
// 54.4 MB of compulsory traffic. Every operation on the CUDA cores:
// 0.0417 ms; the products on the TF32 tensor cores in three passes:
// 0.0171 ms, arithmetic.
// Layout: the forward's, row-stationary: one block of eight warps per
// (16 query rows, head, frame), head fastest on the grid (H, F,
// ceil(Nq/16)): 256 blocks at wide-model. Warp w holds its channel slice
// of q and g_o as A fragments and of dq as accumulators (24 registers each
// at C = 384). Per 16-key step each warp computes its slices of q.k^T and
// g_o.v^T, warp 0 the point distances (the rows' qp in registers, as the
// forward), warp 1 g_opt.vp^T, warps 4-7 the pair term of rows
// g + 8 (w & 1) over pair channels 32 ((w >> 1) & 1) + t + 4 m (the
// forward's pair warps and pair_z tiles, one slot per channel half); after
// the exchange (one block barrier) every warp holds the same a and dl,
// and dl leaves the accumulators as the A fragment of dq += dl.k over the
// warp's channels; warp 1 adds dl.kp and the row sums, warp 0 the dhw
// sums. Key steps (k, v, points, key mask, bias) come by cp.async into the
// other of two buffers; each pair warp fetches its 8 rows x 16 keys x 32
// channels of pair_z, reads it and refetches the next step's. What this
// does about the CUDA-core kernel A's limits:
//   1. one thread per (row, key) element with two C-long dot products
//      (q.k, g_o.v) on the CUDA cores: mma tiles, split over eight warps;
//   2. dl.k on the CUDA cores and dq accumulated in shared memory: dl's
//      accumulators become dq's A fragments, dq stays in mma accumulators;
//   3. synchronous loads: cp.async into the other of two buffers, two block
//      barriers a 16-key step (its top and the exchange);
//   4. pair_z read per element from L2: 16-byte cp.async into shared
//      memory, each pair warp's rows as one group, refetched once read.
// Shared memory at C = 384: 206,272 bytes (two key tiles 115,840, pair
// tiles 66,048, exchange 20,480, g_opt rows 3,840), one block an SM;
// ptxas: 253 registers at C = 384 (224 at C <= 256), no spills.
//
// Kernel B (dk/dv). Bound at wide-model: about 3,500 FLOP per element, 3.67
// GFLOP, 99.6% of it in products, against 61.2 MB: 0.0548 ms on the CUDA
// cores, 0.0224 ms with the products on the tensor cores (arithmetic).
// Layout: key-stationary, the dq layout turned around: one block of eight
// warps per (16 keys, head, frame), head fastest on the grid (H, F,
// ceil(Nk/16)), walking the query rows 16 at a time. Warp w holds its
// channel slice of the block's k and v as A fragments and of dk and dv as
// mma accumulators (24 registers each at C = 384). Per row step each warp
// computes its slices of the transposed tile k.q^T and v.g_o^T (keys x
// rows: keys the M operand, in mma3t's pass order), warp 0 the point
// distances, warp 1 vp.g_opt^T, warps 2-5 the pair term of keys
// g + 8 ((w - 2) & 1) over pair channel half (w - 2) >> 1 (all 16 rows,
// 16-byte reads of an XOR-swizzled tile); after the exchange a^T and dl^T
// sit in accumulators in the layout of the next products' A fragments
// (rows as the permuted depth), so dk += dl^T.q and dv += a^T.g_o read
// only q and g_o from shared memory; warp 6 adds dl^T.qp and the column
// sums, warp 7 a^T.g_opt. The row steps (q, g_o, their points, g_pair, lse,
// D, the row mask and the bias tile [16 rows][16 keys]) come by cp.async
// into the other of two buffers; each pair warp fetches its 16 rows x 8
// keys x 32 channels of pair_z, reads it and refetches. What this does
// about the CUDA-core kernel B's limits:
//   1. the four C-wide products (k.q^T, v.g_o^T, dl^T.q, a^T.g_o) per
//      element on the CUDA cores: mma tiles over eight channel slices;
//   2. dk and dv accumulated in shared memory: in mma accumulators;
//   3. synchronous loads: the row steps double-buffered by cp.async, two
//      block barriers a step;
//   4. pair_z read per element: staged by 16-byte cp.async, refetched
//      once read.
// Shared memory is the limit: two row steps of q and g_o take 99 KB at
// C = 384 and the step's pair_z 65.5 KB, so k and v wait in registers
// (96 a lane with dk and dv), not shared memory as v does in
// ipa_attention_bwd.cu kernel B. 217,152 bytes at C = 384 (two row steps
// 124,288, pair tiles 65,536, exchange 20,480, key points 6,784), one block
// an SM; ptxas: 251 registers at C = 384 (232 at C <= 256), no spills.
//
// Kernel C (pair). Bound at wide-model: about 1,950 FLOP per element, 2.05
// GFLOP, 79% of it in q.k^T and g_o.v^T, against 66.4 MB: 0.0305 ms on the
// CUDA cores; the products on the tensor cores: 0.0125 ms of arithmetic,
// so the bytes bound it, 0.0198 ms at 3.35 TB/s.
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
// about the CUDA-core kernel C's limits:
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
//
// Times on the card, the A/B against the CUDA-core kernels and where the
// time goes (tools/bench_ipa.py --ablate): PERF.md section 6.
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "ipa_wide_tile.cuh"

namespace {

using namespace ipa_wtc;

struct Inputs {
  const float *q, *k, *v, *qp, *kp, *vp, *bias, *pz, *mask, *kmask, *hw,
      *lse, *dvec, *go, *gopt, *gpair;
};

// The pair term's two channel halves, summed in one order by A and B.
__device__ __forceinline__ float pair_term(const float* xch, int n, int e) {
  return xval(xch, kGPZ, n, e) + xval(xch, kGPZ + 1, n, e);
}

// ---------------------------------------------------------------------------
// kernel A: dq, dqp, dhw rows. grid (H, F, ceil(Nq/16))
// ---------------------------------------------------------------------------
struct SmemA {
  Common c;
  float* gopt;  // [kRows][kP3vs]: the block's rows' g_opt
  float* pz;    // [4 pair warps][8 rows][kPZh]
  __host__ __device__ size_t carve(float* base, const Layout& L) {
    Carver cv(base);
    c.carve(cv, L, kBwdSlots);
    gopt = cv.take((size_t)kRows * kP3vs);
    pz = cv.take((size_t)4 * 8 * kPZh);
    return cv.n;
  }
};

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
ipa_wtc_bwd_dq_kernel(Inputs in, Layout L, float* __restrict__ dq,
                      float* __restrict__ dqp, float* __restrict__ dhw_rows) {
  extern __shared__ float4 smem4[];
  SmemA s;
  s.carve(reinterpret_cast<float*>(smem4), L);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, f = blockIdx.y, i0 = blockIdx.z * kRows;
  const int col = w * L.CQ;  // first channel of this warp
  const bool pair_warp = w >= 4;
  const int rr = w & 1, c0 = 32 * ((w >> 1) & 1);  // pair rows, channels
  const float hw = in.hw[h];
  const int n_steps = (L.Nk + kKeys - 1) / kKeys;
  float* spz = s.pz + (w & 3) * 8 * kPZh;  // warps 4-7

  zero_padding(s.c, L);
  // the rows' g_opt joins the first key step's group
  fetch_row_block(s.gopt, kP3vs, kMaxP3v, in.gopt, f, h, i0, L.P3v, L);
  fetch_key_step(s.c.tile(0, L), in.k, in.v, in.kp, in.vp, in.kmask,
                 in.bias, f, h, i0, 0, true, L);
  if (pair_warp) fetch_pz(spz, in.pz, i0 + 8 * rr, 0, c0, L);

  float qa[NT][4], goa[NT][4];  // this warp's slice of q and g_o
#pragma unroll
  for (int ks = 0; ks < NT; ++ks) {
    load_afrag(qa[ks], in.q, L, L.Nq, f, h, i0, L.C, col + 8 * ks, L.C);
    load_afrag(goa[ks], in.go, L, L.Nq, f, h, i0, L.C, col + 8 * ks, L.C);
  }
  // warp 0: the rows' qp (the distances, as the forward holds them);
  // warp 1: sum_j dl_ij kp_j
  float pts[kKQ][4], qsq[2];
  if (w == 0) {
#pragma unroll
    for (int ks = 0; ks < kKQ; ++ks)
      load_afrag(pts[ks], in.qp, L, L.Nq, f, h, i0, L.P3q, 8 * ks, L.P3q);
    row_norms(qsq, pts);
  } else {
#pragma unroll
    for (int n = 0; n < kKQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pts[n][e] = 0.f;
  }
  float gp[8];  // pair warps: g_pair of row g + 8 rr, channels c0 + t + 4 m
  if (pair_warp) {
    const int i = i0 + g + 8 * rr;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int d = c0 + t + 4 * m;
      gp[m] = (i < L.Nq && d < L.Dz) ? in.gpair[atq(L, f, i, h, L.Dz, d)]
                                     : 0.f;
    }
  }
  float qm[2], lse[2], dvec[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    const bool ok = i < L.Nq;
    qm[r] = ok ? in.mask[(size_t)f * L.Nq + i] : 0.f;
    lse[r] = ok ? in.lse[((size_t)f * L.H + h) * L.Nq + i] : 0.f;
    dvec[r] = ok ? in.dvec[((size_t)f * L.H + h) * L.Nq + i] : 0.f;
  }

  float acc[NT][4], sums[2] = {0.f, 0.f};  // sums: warp 0 dhw, warp 1 rows
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const int j0 = step * kKeys;
    const KeyTile kt = s.c.tile(step & 1, L);
    // this step's key tile has landed (the pair warps' pair_z may still be
    // on its way), and every warp is done with the last step, its buffer
    // and the exchange
    if (pair_warp)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    fetch_key_step(s.c.tile((step + 1) & 1, L), in.k, in.v, in.kp, in.vp,
                   in.kmask, in.bias, f, h, i0, j0 + kKeys,
                   step + 1 < n_steps, L);

    // each warp's share of the tile's products into the exchange
    {
      float x[2][4];
      qk_partial<NT>(
          x,
          [&](int ks, float (&a)[4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = qa[ks][e];
          },
          kt.k, col, L);
      xput(s.c.xch, kQK + w, x);
      qk_partial<NT>(
          x,
          [&](int ks, float (&a)[4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = goa[ks][e];
          },
          kt.v, col, L);
      xput(s.c.xch, kGV + w, x);
    }
    if (w == 0) {
      float dist[2][4];
      key_norms(s.c.ksq, kt);
      __syncwarp();
      point_dist(dist, pts, qsq, s.c.ksq, kt);
      xput(s.c.xch, kDist, dist);
    } else if (w == 1) {
      gopt_vp(s.c.xch, s.gopt, kt);
    } else if (pair_warp) {
      // g_pair_i . pz_ij of row g + 8 rr over this warp's channel half:
      // sums over this lane's channels, then a reduce-scatter over the quad
      cp_async_wait<1>();  // this step's pair_z (the next key tile may wait)
      __syncwarp();
      float part[kKeys];
      const float* z = spz + g * kPZh + t;  // zeros past Dz
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        float a = 0.f;
#pragma unroll
        for (int m = 0; m < 8; ++m) a = fmaf(gp[m], z[jj * 32 + 4 * m], a);
        part[jj] = a;
      }
      __syncwarp();  // every lane has read the rows
      if (step + 1 < n_steps)
        fetch_pz(spz, in.pz, i0 + 8 * rr, j0 + kKeys, c0, L);
      quad_scatter(s.c.xch, kGPZ + (c0 != 0), rr, part);
    }
    __syncthreads();  // the exchange

    // dl of rows g, g + 8 and keys j0 + 8 n + 2 t + {0, 1}; every warp
    // computes the same values; 0 past Nq and past Nk
    float dl[2][4];
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
                   pair_term(s.c.xch, n, e)) -
                  dvec[r]);
        dl[n][e] = valid ? v : 0.f;
        if (w == 0)
          sums[r] += -0.5f * xval(s.c.xch, kDist, n, e) * dl[n][e];
        else if (w == 1)
          sums[r] += dl[n][e];
      }

    // dq += dl . k over this warp's channels, 3xTF32
    uint32_t dh[2][4], dlo[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) split_ctile(dl[ks], dh[ks], dlo[ks]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t bh[2], bl[2];
        bfrag_cols(kt.k, L.Cs, ks, col + 8 * n, bh, bl);
        mma3(acc[n], dh[ks], dlo[ks], bh, bl);
      }
    }
    if (w == 1) {
      // sum_j dl_ij kp_j, 3xTF32 (zeros past Pq*3)
#pragma unroll
      for (int n = 0; n < kKQ; ++n) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t bh[2], bl[2];
          bfrag_cols(kt.kp, kP3qs, ks, 8 * n, bh, bl);
          mma3(pts[n], dh[ks], dlo[ks], bh, bl);
        }
      }
    }
  }

  // epilogue: rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    const float sum = quad_sum(sums[r]);
    if (i >= L.Nq) continue;
    if (w == 0 && t == 0) dhw_rows[((size_t)f * L.H + h) * L.Nq + i] = sum;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = col + 8 * n + 2 * t;
      if (c < L.C)
        *reinterpret_cast<float2*>(dq + atq(L, f, i, h, L.C, c)) =
            make_float2(L.c_qk * acc[n][2 * r], L.c_qk * acc[n][2 * r + 1]);
    }
    if (w == 1) {
#pragma unroll
      for (int n = 0; n < kKQ; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t + e;
          if (c < L.P3q) {
            const size_t x = atq(L, f, i, h, L.P3q, c);
            dqp[x] = -hw * (sum * in.qp[x] - pts[n][2 * r + e]);
          }
        }
    }
  }
}

// ---------------------------------------------------------------------------
// kernel B: dk, dkp, dv, dvp. grid (H, F, ceil(Nk/16))
// ---------------------------------------------------------------------------
constexpr int kRBw = kKeys + 4;     // bias tile row stride: 4 mod 16
constexpr int kGPs = kMaxDz + 4;    // g_pair row stride
constexpr int kPZB = kRows * 8 * 32;  // a pair warp's [16 rows][8 keys][32]

// A pair warp's pair_z tile stores its 16-byte chunks XOR-swizzled: chunk
// x of (row r, key kk) at chunk x ^ pz_swz(r, kk). A quarter warp's 16-byte
// reads (lanes g = 0, 1 and t = 0..3 reading rows 2t + e of key g) then
// fall in 8 distinct bank groups (as ipa_attention_bwd.cu kernel B's).
__host__ __device__ inline int pz_swz(int r, int kk) {
  return (kk + 2 * (r >> 1)) & 7;
}

__host__ __device__ inline int pz_index(int r, int kk, int d) {
  return r * 8 * 32 + kk * 32 + 4 * ((d >> 2) ^ pz_swz(r, kk)) + (d & 3);
}

// One step's query rows; two of them double-buffer the steps.
struct RowStep {
  float *q, *go;           // [kRows][Cs]
  float *qp;               // [kRows][kP3qs]
  float *gopt;             // [kRows][kP3vs]
  float *gpair;            // [kRows][kGPs]
  float *lse, *dvec, *qm;  // [kRows]
  float *bias;             // [kRows][kRBw]: the block's 16 keys
};

__host__ __device__ inline RowStep row_step(Carver& c, const Layout& L) {
  RowStep r;
  r.q = c.take((size_t)kRows * L.Cs);
  r.go = c.take((size_t)kRows * L.Cs);
  r.qp = c.take((size_t)kRows * kP3qs);
  r.gopt = c.take((size_t)kRows * kP3vs);
  r.gpair = c.take((size_t)kRows * kGPs);
  r.lse = c.take(kRows);
  r.dvec = c.take(kRows);
  r.qm = c.take(kRows);
  r.bias = c.take((size_t)kRows * kRBw);
  return r;
}

struct SmemB {
  float *kp, *vp;   // [kKeys][kP3qs], [kKeys][kP3vs]: the block's keys
  float *km, *ksq;  // [kKeys]
  float* rows;      // two row steps of row_floats each
  size_t row_floats;
  float* pz;        // [4 pair warps][kPZB]
  float* qsq;       // [kRows]: |qp|^2 of the step's rows
  float* xch;       // [kBwdSlots][kSlotFloats]
  __host__ __device__ size_t carve(float* base, const Layout& L) {
    Carver c(base);
    kp = c.take((size_t)kKeys * kP3qs);
    vp = c.take((size_t)kKeys * kP3vs);
    km = c.take(kKeys);
    ksq = c.take(kKeys);
    Carver one(nullptr);
    row_step(one, L);
    row_floats = one.n;
    rows = c.take(2 * row_floats);
    pz = c.take((size_t)4 * kPZB);
    qsq = c.take(kRows);
    xch = c.take((size_t)kBwdSlots * kSlotFloats);
    return c.n;
  }
  __device__ RowStep step(int b, const Layout& L) const {
    Carver c(rows + b * row_floats);
    return row_step(c, L);
  }
};

// Zero what cp.async never writes and the products read: channels
// [C, 8 CQ) of both steps' q and g_o, point columns past P3q and P3v, pair
// channels past Dz of g_pair (the pair_z fetches zero-fill their own).
__device__ void zero_padding_b(const SmemB& s, const Layout& L) {
  const int tid = threadIdx.x;
  const int pc = kWarps * L.CQ - L.C;
  const int pq = kMaxP3q - L.P3q, pv = kMaxP3v - L.P3v, pd = kMaxDz - L.Dz;
  if (pq)
    deal(kKeys, pq, tid, kThreads,
         [&](int r, int x) { s.kp[r * kP3qs + L.P3q + x] = 0.f; });
  if (pv)
    deal(kKeys, pv, tid, kThreads,
         [&](int r, int x) { s.vp[r * kP3vs + L.P3v + x] = 0.f; });
  for (int b = 0; b < 2; ++b) {
    const RowStep rs = s.step(b, L);
    if (pc)
      deal(kRows, pc, tid, kThreads, [&](int r, int x) {
        rs.q[r * L.Cs + L.C + x] = 0.f;
        rs.go[r * L.Cs + L.C + x] = 0.f;
      });
    if (pq)
      deal(kRows, pq, tid, kThreads,
           [&](int r, int x) { rs.qp[r * kP3qs + L.P3q + x] = 0.f; });
    if (pv)
      deal(kRows, pv, tid, kThreads,
           [&](int r, int x) { rs.gopt[r * kP3vs + L.P3v + x] = 0.f; });
    if (pd)
      deal(kRows, pd, tid, kThreads,
           [&](int r, int x) { rs.gpair[r * kGPs + L.Dz + x] = 0.f; });
  }
}

// The block's keys j0.. j0 + 15 of (f, h): key points, value points and key
// mask, zero past Nk; not committed (the first row step's commit takes
// them).
__device__ void fetch_block_keys(const SmemB& s, const Inputs& in, int f,
                                 int h, int j0, const Layout& L) {
  const int tid = threadIdx.x;
  const int nk = min(kKeys, L.Nk - j0);
  deal(kKeys, L.P3q, tid, kThreads, [&](int r, int x) {
    const bool ok = r < nk;
    cp_async4(s.kp + r * kP3qs + x,
              in.kp + (ok ? atk(L, f, j0 + r, h, L.P3q, x) : 0), ok);
  });
  deal(kKeys, L.P3v, tid, kThreads, [&](int r, int x) {
    const bool ok = r < nk;
    cp_async4(s.vp + r * kP3vs + x,
              in.vp + (ok ? atk(L, f, j0 + r, h, L.P3v, x) : 0), ok);
  });
  if (tid < kKeys) {
    const bool ok = tid < nk;
    cp_async4(s.km + tid, in.kmask + (ok ? (size_t)f * L.Nk + j0 + tid : 0),
              ok);
  }
}

// The query rows i0.. i0 + 15 of (f, h) into rs, by the whole block, as one
// cp.async group (committed even when empty): q and g_o (16-byte copies),
// their points, g_pair, lse, D, the row mask and the bias tile [rows][the
// block's keys]; zeros past Nq and Nk.
__device__ void fetch_row_step(const RowStep& rs, const Inputs& in, int f,
                               int h, int i0, int j0, bool any,
                               const Layout& L) {
  const int tid = threadIdx.x;
  if (any) {
    const int nr = min(kRows, L.Nq - i0);  // real rows of the step
    deal(kRows, L.C / 4, tid, kThreads, [&](int r, int c4) {
      const bool ok = r < nr;
      const size_t src = ok ? atq(L, f, i0 + r, h, L.C, 4 * c4) : 0;
      cp_async16(rs.q + r * L.Cs + 4 * c4, in.q + src, ok);
      cp_async16(rs.go + r * L.Cs + 4 * c4, in.go + src, ok);
    });
    deal(kRows, L.P3q, tid, kThreads, [&](int r, int x) {
      const bool ok = r < nr;
      cp_async4(rs.qp + r * kP3qs + x,
                in.qp + (ok ? atq(L, f, i0 + r, h, L.P3q, x) : 0), ok);
    });
    deal(kRows, L.P3v, tid, kThreads, [&](int r, int x) {
      const bool ok = r < nr;
      cp_async4(rs.gopt + r * kP3vs + x,
                in.gopt + (ok ? atq(L, f, i0 + r, h, L.P3v, x) : 0), ok);
    });
    deal(kRows, L.Dz, tid, kThreads, [&](int r, int x) {
      const bool ok = r < nr;
      cp_async4(rs.gpair + r * kGPs + x,
                in.gpair + (ok ? atq(L, f, i0 + r, h, L.Dz, x) : 0), ok);
    });
    if (tid < kRows) {
      const bool ok = tid < nr;
      const size_t row = ok ? ((size_t)f * L.H + h) * L.Nq + i0 + tid : 0;
      cp_async4(rs.lse + tid, in.lse + row, ok);
      cp_async4(rs.dvec + tid, in.dvec + row, ok);
      cp_async4(rs.qm + tid,
                in.mask + (ok ? (size_t)f * L.Nq + i0 + tid : 0), ok);
    }
    {  // kRows * kKeys == kThreads: one bias element a thread
      const int nk = min(kKeys, L.Nk - j0);
      const int r = tid / kKeys, c = tid % kKeys;
      const bool ok = r < nr && c < nk;
      cp_async4(rs.bias + r * kRBw + c,
                in.bias + (ok ? ((size_t)(i0 + r) * L.Nk + j0 + c) * L.H + h
                              : 0),
                ok);
    }
  }
  cp_async_commit();
}

// pair_z rows i0.. i0 + 15, keys jb.. jb + 7 and channels c0.. c0 + 31 into
// dst (pz_index), by one warp, as one cp.async group; zeros past Nq, Nk and
// Dz.
__device__ void fetch_pz_keys(float* dst, const float* __restrict__ pz,
                              int i0, int jb, int c0, const Layout& L) {
  const int lane = threadIdx.x & 31;
  if (L.pz_vec) {
    for (int e = lane; e < kRows * 8 * 8; e += 32) {
      const int r = e >> 6, kk = (e >> 3) & 7, x = 4 * (e & 7);
      const int i = i0 + r, j = jb + kk;
      const bool ok = i < L.Nq && j < L.Nk && c0 + x < L.Dz;
      cp_async16(dst + pz_index(r, kk, x),
                 ok ? pz + ((size_t)i * L.Nk + j) * L.Dz + c0 + x : pz, ok);
    }
  } else {
    for (int e = lane; e < kRows * 8 * 32; e += 32) {
      const int r = e >> 8, kk = (e >> 5) & 7, x = e & 31;
      const int i = i0 + r, j = jb + kk;
      const bool ok = i < L.Nq && j < L.Nk && c0 + x < L.Dz;
      cp_async4(dst + pz_index(r, kk, x),
                ok ? pz + ((size_t)i * L.Nk + j) * L.Dz + c0 + x : pz, ok);
    }
  }
  cp_async_commit();
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
ipa_wtc_bwd_dkv_kernel(Inputs in, Layout L, float* __restrict__ dk,
                       float* __restrict__ dkp, float* __restrict__ dv,
                       float* __restrict__ dvp) {
  extern __shared__ float4 smem4[];
  SmemB s;
  s.carve(reinterpret_cast<float*>(smem4), L);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, f = blockIdx.y, j0 = blockIdx.z * kKeys;
  const int col = w * L.CQ;  // first channel of this warp
  const bool pair_warp = w >= 2 && w < 6;
  const int rr = (w - 2) & 1, half = (w - 2) >> 1;  // pair keys, channels
  const float hw = in.hw[h];
  const int n_steps = (L.Nq + kRows - 1) / kRows;
  float* spz = s.pz + (pair_warp ? w - 2 : 0) * kPZB;  // warps 2-5
  const int swz = pz_swz(2 * t, g);  // of every row this lane reads

  zero_padding_b(s, L);
  fetch_block_keys(s, in, f, h, j0, L);
  fetch_row_step(s.step(0, L), in, f, h, 0, j0, true, L);
  if (pair_warp) fetch_pz_keys(spz, in.pz, 0, j0 + 8 * rr, 32 * half, L);

  // this warp's slice of the block's k and v, as A fragments
  float ka[NT][4], va[NT][4];
#pragma unroll
  for (int ks = 0; ks < NT; ++ks) {
    load_afrag(ka[ks], in.k, L, L.Nk, f, h, j0, L.C, col + 8 * ks, L.C);
    load_afrag(va[ks], in.v, L, L.Nk, f, h, j0, L.C, col + 8 * ks, L.C);
  }

  // dk and dv of keys g, g + 8 over this warp's channels; pacc: dl^T.qp in
  // warp 6, a^T.g_opt in warp 7
  float dka[NT][4], dva[NT][4], pacc[kNV][4];
  float colsum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < kNV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) pacc[n][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const int i0 = step * kRows;
    const RowStep rs = s.step(step & 1, L);
    // this step's rows have landed (the pair warps' pair_z may still be on
    // its way), and every warp is done with the last step, its buffer and
    // the exchange
    if (pair_warp)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    fetch_row_step(s.step((step + 1) & 1, L), in, f, h, i0 + kRows, j0,
                   step + 1 < n_steps, L);

    // each warp's share of the transposed tile (keys g, g + 8 x rows
    // 8 n + 2 t + {0, 1}) into the exchange
    {
      float x[2][4];
      qk_partial<NT, true>(
          x,
          [&](int ks, float (&a)[4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = ka[ks][e];
          },
          rs.q, col, L);
      xput(s.xch, kQK + w, x);
      qk_partial<NT, true>(
          x,
          [&](int ks, float (&a)[4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = va[ks][e];
          },
          rs.go, col, L);
      xput(s.xch, kGV + w, x);
    }
    if (w == 0) {
      // dist = |qp_i|^2 + |kp_j|^2 - 2 kp_j.qp_i, the norms by the
      // forward's code (rows: row_norms, keys: key_norms)
      if (step == 0) key_norms(s.ksq, s.kp);
      float qpa[kKQ][4], qsq[2];
#pragma unroll
      for (int ks = 0; ks < kKQ; ++ks)
        smem_afrag(qpa[ks], rs.qp, kP3qs, 8 * ks);
      row_norms(qsq, qpa);
      if (t == 0) {
        s.qsq[g] = qsq[0];
        s.qsq[g + 8] = qsq[1];
      }
      __syncwarp();
      float cross[2][4], dist[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) cross[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKQ; ++ks) {
        float a[4];
        smem_afrag(a, s.kp, kP3qs, 8 * ks);
        uint32_t ah[4], al[4];
        split4(a, ah, al);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t bh[2], bl[2];
          bfrag_rows(rs.qp, kP3qs, n, 8 * ks, bh, bl);
          mma3t(cross[n], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dist[n][e] = s.qsq[8 * n + 2 * t + (e & 1)] +
                       s.ksq[g + 8 * (e >> 1)] - 2.f * cross[n][e];
      xput(s.xch, kDist, dist);
    } else if (w == 1) {
      // vp . g_opt^T, 3xTF32
      float gvp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) gvp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kNV; ++ks) {  // zeros past Pv*3
        float a[4];
        smem_afrag(a, s.vp, kP3vs, 8 * ks);
        uint32_t ah[4], al[4];
        split4(a, ah, al);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t bh[2], bl[2];
          bfrag_rows(rs.gopt, kP3vs, n, 8 * ks, bh, bl);
          mma3t(gvp[n], ah, al, bh, bl);
        }
      }
      xput(s.xch, kGVP, gvp);
    } else if (pair_warp) {
      // g_pair_i . pz_ij of key g + 8 rr and rows 8 n + 2 t + e over this
      // warp's channel half, 16-byte reads
      cp_async_wait<1>();  // this step's pair_z (the next rows may wait)
      __syncwarp();
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * n + 2 * t + e;
          const float4* gp4 = reinterpret_cast<const float4*>(
              rs.gpair + r * kGPs + 32 * half);
          const float* z = spz + r * 8 * 32 + g * 32;
          float acc = 0.f;
#pragma unroll
          for (int x = 0; x < 8; ++x) {  // zeros past Dz
            const float4 p = gp4[x];
            const float4 q = *reinterpret_cast<const float4*>(
                z + 4 * (x ^ swz));
            acc = fmaf(p.x, q.x, acc);
            acc = fmaf(p.y, q.y, acc);
            acc = fmaf(p.z, q.z, acc);
            acc = fmaf(p.w, q.w, acc);
          }
          xset(s.xch, kGPZ + half, n, 2 * rr + e, acc);
        }
      __syncwarp();  // every lane has read the tile
      if (step + 1 < n_steps)
        fetch_pz_keys(spz, in.pz, i0 + kRows, j0 + 8 * rr, 32 * half, L);
    }
    __syncthreads();  // the exchange

    // a^T and dl^T of keys g, g + 8 and rows 8 n + 2 t + {0, 1}; every
    // warp computes the same values; 0 past Nq and past Nk
    float a[2][4], dl[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = g + 8 * (e >> 1), r = 8 * n + 2 * t + (e & 1);
        const bool valid = i0 + r < L.Nq && j0 + kr < L.Nk;
        const float l =
            ipa_logit(xsum8(s.xch, kQK, n, e), rs.bias[r * kRBw + kr],
                      xval(s.xch, kDist, n, e), rs.qm[r], s.km[kr], hw, L);
        const float av = expf(l - rs.lse[r]);
        const float v =
            av * ((xsum8(s.xch, kGV, n, e) + xval(s.xch, kGVP, n, e) +
                   pair_term(s.xch, n, e)) -
                  rs.dvec[r]);
        a[n][e] = valid ? av : 0.f;
        dl[n][e] = valid ? v : 0.f;
        if (w == 6) colsum[e >> 1] += dl[n][e];
      }

    // dk += dl^T . q and dv += a^T . g_o over this warp's channels, the
    // rows as permuted depth, 3xTF32
    uint32_t dh[2][4], dlo[2][4], ah[2][4], alo[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      split_ctile(dl[ks], dh[ks], dlo[ks]);
      split_ctile(a[ks], ah[ks], alo[ks]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t bh[2], bl[2];
        bfrag_cols(rs.q, L.Cs, ks, col + 8 * n, bh, bl);
        mma3(dka[n], dh[ks], dlo[ks], bh, bl);
        bfrag_cols(rs.go, L.Cs, ks, col + 8 * n, bh, bl);
        mma3(dva[n], ah[ks], alo[ks], bh, bl);
      }
    }
    if (w == 6) {
      // sum_i dl_ij qp_i (zeros past Pq*3)
#pragma unroll
      for (int n = 0; n < kKQ; ++n)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t bh[2], bl[2];
          bfrag_cols(rs.qp, kP3qs, ks, 8 * n, bh, bl);
          mma3(pacc[n], dh[ks], dlo[ks], bh, bl);
        }
    } else if (w == 7) {
      // sum_i a_ij g_opt_i (zeros past Pv*3)
#pragma unroll
      for (int n = 0; n < kNV; ++n)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t bh[2], bl[2];
          bfrag_cols(rs.gopt, kP3vs, ks, 8 * n, bh, bl);
          mma3(pacc[n], ah[ks], alo[ks], bh, bl);
        }
    }
  }

  // epilogue: keys g, g + 8 of the block
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = g + 8 * r, j = j0 + kr;
    const float cs = quad_sum(colsum[r]);
    if (j >= L.Nk) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = col + 8 * n + 2 * t;
      if (c < L.C) {
        const size_t x = atk(L, f, j, h, L.C, c);
        *reinterpret_cast<float2*>(dk + x) =
            make_float2(L.c_qk * dka[n][2 * r], L.c_qk * dka[n][2 * r + 1]);
        *reinterpret_cast<float2*>(dv + x) =
            make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
      }
    }
    if (w == 6) {
#pragma unroll
      for (int n = 0; n < kKQ; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t + e;
          if (c < L.P3q)
            dkp[atk(L, f, j, h, L.P3q, c)] =
                -hw * (cs * s.kp[kr * kP3qs + c] - pacc[n][2 * r + e]);
        }
    } else if (w == 7) {
#pragma unroll
      for (int n = 0; n < kNV; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t + e;
          if (c < L.P3v) dvp[atk(L, f, j, h, L.P3v, c)] = pacc[n][2 * r + e];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// kernel C: dbias [Nq, Nk, H], dpz [Nq, Nk, Dz]. grid (ceil(Nk/16),
// ceil(Nq/16))
// ---------------------------------------------------------------------------
constexpr int kPZs = kKeys * kMaxDz + 4;  // a pair_z tile row: [key][64]

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
    gopt_vp(xch, sgopt, kt);
  } else if (w < 4) {
    // g_pair_i . pz_ij of row g + 8 rr: sums over this lane's pair
    // channels, then a reduce-scatter over the quad
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
    quad_scatter(xch, kGPZ, rr, part);
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

template <typename Smem>
size_t smem_bytes(const Layout& L) {
  Smem none;
  return none.carve(nullptr, L) * sizeof(float);
}

}  // namespace

// Each launcher runs its kernel on `stream` and returns cudaGetLastError()
// (0 = the launch was accepted). Arguments and layouts as
// ipa_attention_bwd.cu's launchers: the 16 backward inputs (q, g_o
// [F, Nq, H, C], k, v [F, Nk, H, C], points [F, rows, H, P*3], bias
// [Nq, Nk, H], pair_z [Nq, Nk, Dz], mask [F, Nq], key_mask [F, Nk],
// head_weights [H], lse and D [F, H, Nq], g_pair [F, Nq, H, Dz]), then
// the outputs: A dq like q, dqp like q_pts, dhw_rows [F, H, Nq]; B dk, dv
// like k, dkp like k_pts, dvp like v_pts (sums over the Nq rows); C dbias
// [Nq, Nk, H], dpz [Nq, Nk, Dz]. All float32 and contiguous; q, k, v, g_o
// 16-byte aligned; C divisible by 4 and at most 384, Pq*3 <= 40,
// Pv*3 <= 56, Dz <= 64.
#define IPA_BWD_INPUTS                                                       \
  const float *q, const float *k, const float *v, const float *q_pts,        \
      const float *k_pts, const float *v_pts, const float *bias,             \
      const float *pair_z, const float *mask, const float *key_mask,         \
      const float *head_weights, const float *lse, const float *dvec,        \
      const float *g_o, const float *g_opt, const float *g_pair
#define IPA_BWD_SHAPES                                                       \
  int F, int Nq, int Nk, int H, int C, int Pq, int Pv, int Dz, float c_qk,  \
      float c_b, float inf, int device, cudaStream_t stream
// Packs the inputs, checks the widths, makes the layout L and the kernel
// instance for C (NT 6 or 4) of `kern`, sets its shared memory (smem bytes
// of `Smem`) and selects the device.
#define IPA_BWD_PREPARE(kern, Smem)                                          \
  const Inputs in{q,     k,        v,            q_pts, k_pts, v_pts,       \
                  bias,  pair_z,   mask,         key_mask,                   \
                  head_weights,    lse,          dvec,  g_o,   g_opt,        \
                  g_pair};                                                   \
  if (F < 1 || F > 65535 || !layout_ok(Nq, Nk, H, C, 3 * Pq, 3 * Pv, Dz) || \
      (Nq + kRows - 1) / kRows > 65535 || (Nk + kKeys - 1) / kKeys > 65535)  \
    return (int)cudaErrorInvalidValue;                                       \
  const Layout L =                                                           \
      make_layout(Nq, Nk, H, C, 3 * Pq, 3 * Pv, Dz, c_qk, c_b, inf,          \
                  (reinterpret_cast<uintptr_t>(pair_z) & 15) == 0);          \
  const size_t smem = smem_bytes<Smem>(L);                                   \
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;            \
  cudaError_t err = cudaSetDevice(device);                                   \
  if (err != cudaSuccess) return (int)err;                                   \
  auto kernel = tiles_for(C) == kMaxNT ? kern<kMaxNT> : kern<4>;             \
  err = cudaFuncSetAttribute(                                                \
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);       \
  if (err != cudaSuccess) return (int)err;

extern "C" int ipa_attention_wide_tc_bwd_dq(IPA_BWD_INPUTS, float* dq,
                                            float* dqp, float* dhw_rows,
                                            IPA_BWD_SHAPES) {
  IPA_BWD_PREPARE(ipa_wtc_bwd_dq_kernel, SmemA)
  const dim3 grid(H, F, (Nq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(in, L, dq, dqp, dhw_rows);
  return (int)cudaGetLastError();
}

extern "C" int ipa_attention_wide_tc_bwd_dkv(IPA_BWD_INPUTS, float* dk,
                                             float* dkp, float* dv,
                                             float* dvp, IPA_BWD_SHAPES) {
  IPA_BWD_PREPARE(ipa_wtc_bwd_dkv_kernel, SmemB)
  const dim3 grid(H, F, (Nk + kKeys - 1) / kKeys);
  kernel<<<grid, kThreads, smem, stream>>>(in, L, dk, dkp, dv, dvp);
  return (int)cudaGetLastError();
}

extern "C" int ipa_attention_wide_tc_bwd_pair(IPA_BWD_INPUTS, float* dbias,
                                              float* dpz, IPA_BWD_SHAPES) {
  IPA_BWD_PREPARE(ipa_wtc_bwd_pair_kernel, SmemP)
  const dim3 grid((Nk + kKeys - 1) / kKeys, (Nq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(in, L, F, dbias, dpz);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block (bytes) of kernel 0 (A, dq), 1 (B, dk/dv)
// or 2 (C, pair) at these widths.
extern "C" long long ipa_attention_wide_tc_bwd_smem(int which, int C, int Pq,
                                                    int Pv, int Dz) {
  const Layout L =
      make_layout(1, 1, 1, C, 3 * Pq, 3 * Pv, Dz, 0.f, 0.f, 0.f, true);
  switch (which) {
    case 0: return (long long)smem_bytes<SmemA>(L);
    case 1: return (long long)smem_bytes<SmemB>(L);
    case 2: return (long long)smem_bytes<SmemP>(L);
    default: return -1;
  }
}

extern "C" const char* ipa_attention_wide_tc_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
