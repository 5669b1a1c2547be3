// Invariant Point Attention backward, flash style, for sm_90a; kernel A (dq)
// on the TF32 tensor cores.
//
// Replaces the three Pallas TPU kernels of
// dynamicpdb_tpu/ops/pallas/ipa_attention.py that the custom VJP
// (_ipa_attention_bwd :563) launches through _fused_ipa_backward (:369):
//
//   kernel A  ipa_bwd_dq_kernel    <- _bwd_dq_kernel   (:259)
//   kernel B  ipa_bwd_dkv_kernel   <- _bwd_dkv_kernel  (:297)
//   kernel C  ipa_bwd_pair_kernel  <- _bwd_pair_kernel (:338)
//
// Each kernel recomputes the attention tile from the forward's saved row
// log-sum-exp (never a fresh softmax, so the gradient is that of the
// forward that ran) and the row constant D_i = <g_out, out>_i that the
// caller computes:
//
//   logit_ij = c_qk q_i.k_j + c_b bias_ijh - 0.5 w_h dist_ij + inf (m_i m_j - 1)
//   dist_ij  = |qp_i|^2 + |kp_j|^2 - 2 qp_i.kp_j
//   a_ij     = exp(logit_ij - lse_i)
//   ds_ij    = g_o_i.v_j + g_opt_i.vp_j + sum_d g_pair_id pz_ijd
//   dl_ij    = a_ij (ds_ij - D_i)
//
// and accumulates
//
//   A, per (f, h, i):  dq_i   = c_qk sum_j dl_ij k_j
//                      dqp_i  = -w_h (sum_j dl_ij qp_i - sum_j dl_ij kp_j)
//                      dhw_i  = sum_j -0.5 dist_ij dl_ij     (summed over f, i
//                                                              by the caller)
//   B, per (f, h, j):  dk_j   = c_qk sum_i dl_ij q_i
//                      dkp_j  = -w_h (sum_i dl_ij kp_j - sum_i dl_ij qp_i)
//                      dv_j   = sum_i a_ij g_o_i
//                      dvp_j  = sum_i a_ij g_opt_i
//   C, per (i, j):     dbias_ijh = c_b sum_f dl_ij          (for every h)
//                      dpz_ij    = sum_{f,h} a_ij g_pair_i
//
// The logit is built in the same order of operations in all four IPA kernels
// (ipa_tile.cuh ipa_logit; element() below), so the a_ij recomputed here
// agrees with the forward's softmax as far as the two computations of q.k
// and qp.kp do: A computes both with the forward's own tensor-core code, to
// the bit; B and C on the CUDA cores, to float32 rounding.
//
// Bound on an H100 (2 FLOP per multiply-add): the tile recompute costs
// about 1,220 FLOP per (f, h, i, j) element (q.k and g_o.v over C, the
// point and pair terms); A adds about 560, B about 1,150, C about 65. At
// the release shapes (F=2, N=256, H=8, C=256, Pq=8, Pv=12, Dz=32) that is
// 1.87, 2.48 and 1.35 GFLOP, against 30-40 MB of compulsory traffic each.
// On the CUDA cores (67 TFLOP/s float32) about 28, 37 and 20 us. With the
// products on the TF32 tensor cores (495 TFLOP/s) in three passes and the
// rest on the CUDA cores: 11.5, 15.2 and 12.0 us (the last the bytes;
// chip_smoke.ipa_bwd_cost, bounds).
//
// On the TPU the last grid axis runs in order and the kernels accumulate in
// scratch across it. Here that axis becomes a loop inside one block, so
// every output element is written by exactly one block: no atomics, and
// the result is the same from run to run.
//
// Kernel A (dq) runs on the tensor cores in the forward's layout
// (ipa_tile.cuh; its header below). Passes: q.k^T, g_o.v^T and dl.k (C
// wide, 86% of A's operations), qp.kp^T (24), g_opt.vp^T (36) and dl.kp
// (24) all in three TF32 passes (3xTF32: every operand is float32; at the
// release widths one pass misses BWD_RTOL x max|dq| = 3.3e-4 by 8x, three
// land at 1.4e-5, tests/test_torch_ipa_precision.py); the pair term
// g_pair_i.pz_ij, a different matrix per query row, on the CUDA cores. What
// the layout does about the CUDA-core version's limits:
//   1. one thread per (row, key) element with two 256-long dot products
//      alone: the three C-wide products are mma tiles, the A fragments of q
//      and g_o held in registers, dl straight from its accumulators;
//   2. dq += dl.k on the CUDA cores: on the tensor cores;
//   3. synchronous loads: k, v, their points, the key mask and the bias
//      tile come by cp.async into the other of two buffers, one block
//      barrier a step; pair_z by cp.async in the warp that reads it;
//   4. strided bias reads: the head is the fastest grid axis, so the H
//      blocks of a query tile share each sector of the [N, N, H] bias in L2;
//   5. spills: dq lives in mma accumulators, 32 registers a warp; ptxas
//      250 registers at C = 256 (168 at C <= 32), no spills; 184,192 bytes
//      of shared memory, one block of 8 warps an SM.
//
// Kernels B and C are the first version (correctness first, CUDA cores):
//   * Both work on 16 x 16 element tiles with one thread per (query row,
//     key) element: 256 threads. The 16 query rows (q, g_o, their points,
//     g_pair, lse, D) and the 16 key rows (k, v, their points) are staged
//     in shared memory, rows padded to C+4 floats so the float4 reads of a
//     quarter warp fall on distinct banks.
//   * B: one block per (16 keys, head, frame), looping over query tiles;
//     dk, dv and the point sums accumulate in shared memory.
//   * C: one block per (16 query rows, 16 keys), looping over heads and,
//     inside, frames; the tile's pair_z rows are staged once, dpz
//     accumulates in shared memory per element, dbias in a register per
//     head.
// In all three, rows and keys past N (the ragged last tile) are loaded as
// zeros and their elements forced to a = dl = 0, so N need not divide the
// tile. Pad rows (mask 0) are computed exactly as the reference does.
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "ipa_tile.cuh"  // kernel A's layout; cp.async, mma, split

namespace {

constexpr int kTile = 16;                  // query rows and keys per tile
constexpr int kThreads = kTile * kTile;    // one thread per element
constexpr int kWide = 4;                   // rows per work item of the C-wide sums

static_assert(kTile == 16, "row reductions use 16-lane shuffles");

__host__ __device__ inline int padded_c(int C) { return C + 4; }
__host__ __device__ inline int padded_odd(int p) { return p | 1; }

struct Dims {
  int F, N, H, C, Cs, P3q, P3qs, P3v, P3vs, Dz, Dzs;
  float c_qk, c_b, inf;
};

using ipa_tc::Carver;  // bump allocator over dynamic shared memory

// 16 query rows of one (frame, head): the operands of the element and of
// the row-side sums.
struct RowTile {
  float *q, *go;           // [16][Cs]
  float *qp;               // [16][P3qs]
  float *gopt;             // [16][P3vs]
  float *gpair;            // [16][Dzs]
  float *qsq, *qm, *lse, *dvec;  // [16]
  __host__ __device__ void carve(Carver& c, const Dims& d) {
    q = c.take(kTile * d.Cs);
    go = c.take(kTile * d.Cs);
    qp = c.take(kTile * d.P3qs);
    gopt = c.take(kTile * d.P3vs);
    gpair = c.take(kTile * d.Dzs);
    qsq = c.take(kTile);
    qm = c.take(kTile);
    lse = c.take(kTile);
    dvec = c.take(kTile);
  }
};

// 16 key rows of one (frame, head).
struct KeyTile {
  float *k, *v;            // [16][Cs]
  float *kp;               // [16][P3qs]
  float *vp;               // [16][P3vs]
  float *ksq, *km;         // [16]
  __host__ __device__ void carve(Carver& c, const Dims& d) {
    k = c.take(kTile * d.Cs);
    v = c.take(kTile * d.Cs);
    kp = c.take(kTile * d.P3qs);
    vp = c.take(kTile * d.P3vs);
    ksq = c.take(kTile);
    km = c.take(kTile);
  }
};

struct Inputs {
  const float *q, *k, *v, *qp, *kp, *vp, *bias, *pz, *mask, *hw, *lse, *dvec,
      *go, *gopt, *gpair;
};

// element (f, n, h, x) of a [F, N, H, D] tensor
__device__ inline size_t at(const Dims& d, int f, int n, int h, int D, int x) {
  return (((size_t)f * d.N + n) * d.H + h) * D + x;
}

// rows n0..n0+15 of a [F, N, H, D] tensor at (f, h) into dst[r * ds + x],
// zeros past N; float4 copies (D divisible by 4, 16-byte aligned rows)
__device__ void load_rows4(float* dst, int ds, const float* src, const Dims& d,
                           int f, int h, int n0, int D) {
  const int D4 = D / 4;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = threadIdx.x; e < kTile * D4; e += kThreads) {
    const int r = e / D4, x4 = e % D4, n = n0 + r;
    reinterpret_cast<float4*>(dst + r * ds)[x4] =
        n < d.N ? reinterpret_cast<const float4*>(src + at(d, f, n, h, D, 0))[x4]
                : zero4;
  }
}

__device__ void load_rows(float* dst, int ds, const float* src, const Dims& d,
                          int f, int h, int n0, int D) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, x = e % D, n = n0 + r;
    dst[r * ds + x] = n < d.N ? src[at(d, f, n, h, D, x)] : 0.f;
  }
}

__device__ float sum_sq(const float* p, int n) {
  float s = 0.f;
  for (int x = 0; x < n; ++x) s += p[x] * p[x];
  return s;
}

// Stage the query rows i0.. of (f, h). The caller synchronises.
__device__ void load_row_tile(RowTile& t, const Inputs& in, const Dims& d,
                              int f, int h, int i0) {
  load_rows4(t.q, d.Cs, in.q, d, f, h, i0, d.C);
  load_rows4(t.go, d.Cs, in.go, d, f, h, i0, d.C);
  load_rows(t.qp, d.P3qs, in.qp, d, f, h, i0, d.P3q);
  load_rows(t.gopt, d.P3vs, in.gopt, d, f, h, i0, d.P3v);
  load_rows(t.gpair, d.Dzs, in.gpair, d, f, h, i0, d.Dz);
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x, i = i0 + r;
    const bool ok = i < d.N;
    t.qm[r] = ok ? in.mask[(size_t)f * d.N + i] : 0.f;
    t.lse[r] = ok ? in.lse[((size_t)f * d.H + h) * d.N + i] : 0.f;
    t.dvec[r] = ok ? in.dvec[((size_t)f * d.H + h) * d.N + i] : 0.f;
  }
}

__device__ void load_key_tile(KeyTile& t, const Inputs& in, const Dims& d,
                              int f, int h, int j0) {
  load_rows4(t.k, d.Cs, in.k, d, f, h, j0, d.C);
  load_rows4(t.v, d.Cs, in.v, d, f, h, j0, d.C);
  load_rows(t.kp, d.P3qs, in.kp, d, f, h, j0, d.P3q);
  load_rows(t.vp, d.P3vs, in.vp, d, f, h, j0, d.P3v);
  if (threadIdx.x < kTile) {
    const int j = j0 + threadIdx.x;
    t.km[threadIdx.x] = j < d.N ? in.mask[(size_t)f * d.N + j] : 0.f;
  }
}

// |qp|^2 and |kp|^2 of the staged rows; after a sync that follows the loads.
__device__ void tile_norms(RowTile* rt, KeyTile* kt, const Dims& d) {
  const int t = threadIdx.x;
  if (rt && t < kTile) rt->qsq[t] = sum_sq(rt->qp + t * d.P3qs, d.P3q);
  if (kt && t >= 32 && t < 32 + kTile)
    kt->ksq[t - 32] = sum_sq(kt->kp + (t - 32) * d.P3qs, d.P3q);
}

struct Elem {
  float a, dl, dist;
};

// The (row r, key jr) element of the staged tiles; pz_ij points at the
// Dz pair channels of (i, j) (global or shared memory).
__device__ Elem element(const RowTile& rt, const KeyTile& kt, int r, int jr,
                        bool valid, float bias_ij, const float* pz_ij,
                        float w, const Dims& d) {
  Elem e{0.f, 0.f, 0.f};
  if (!valid) return e;
  const float4* q4 = reinterpret_cast<const float4*>(rt.q + r * d.Cs);
  const float4* k4 = reinterpret_cast<const float4*>(kt.k + jr * d.Cs);
  const float4* g4 = reinterpret_cast<const float4*>(rt.go + r * d.Cs);
  const float4* v4 = reinterpret_cast<const float4*>(kt.v + jr * d.Cs);
  float qk = 0.f, gv = 0.f;
  for (int c4 = 0; c4 < d.C / 4; ++c4) {
    const float4 a = q4[c4], b = k4[c4];
    qk = fmaf(a.x, b.x, qk);
    qk = fmaf(a.y, b.y, qk);
    qk = fmaf(a.z, b.z, qk);
    qk = fmaf(a.w, b.w, qk);
    const float4 g = g4[c4], vv = v4[c4];
    gv = fmaf(g.x, vv.x, gv);
    gv = fmaf(g.y, vv.y, gv);
    gv = fmaf(g.z, vv.z, gv);
    gv = fmaf(g.w, vv.w, gv);
  }
  float cross = 0.f;
  for (int x = 0; x < d.P3q; ++x)
    cross = fmaf(rt.qp[r * d.P3qs + x], kt.kp[jr * d.P3qs + x], cross);
  float gvp = 0.f;
  for (int x = 0; x < d.P3v; ++x)
    gvp = fmaf(rt.gopt[r * d.P3vs + x], kt.vp[jr * d.P3vs + x], gvp);
  float gpz = 0.f;
  for (int x = 0; x < d.Dz; ++x)
    gpz = fmaf(rt.gpair[r * d.Dzs + x], pz_ij[x], gpz);
  // the forward kernel's order of operations
  e.dist = rt.qsq[r] + kt.ksq[jr] - 2.f * cross;
  float l = d.c_qk * qk;
  l += d.c_b * bias_ij;
  l += -0.5f * w * e.dist;
  l += d.inf * (rt.qm[r] * kt.km[jr] - 1.f);
  e.a = expf(l - rt.lse[r]);
  e.dl = e.a * ((gv + gvp + gpz) - rt.dvec[r]);
  return e;
}

__device__ inline float sum16(float x) {
  for (int off = kTile / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// kernel A: dq, dqp, dhw rows, on the tensor cores. grid (H, F, ceil(N/32))
// ---------------------------------------------------------------------------
// The forward's layout (ipa_tile.cuh): a block of eight warps owns 32 query
// rows of one (f, h), four warps per 16-row tile splitting its C channels in
// quarters. A warp keeps its quarter of q and of g_o as A fragments (32
// registers each at C = 256; the query points and g_opt wait in shared
// memory) and per 16-key step computes its quarter of q.k^T and of g_o.v^T
// (3xTF32); quarter 0 adds qp.kp^T (dist), quarter 1
// g_opt.vp^T, quarters 2 and 3 the pair term g_pair_i.pz_ij of rows g and
// g + 8 on the CUDA cores (lane (g, t) sums its pair channels t + 4m for all
// 16 keys, then a reduce-scatter over the quad hands each lane the keys of
// its fragment). After the exchange all four warps hold a and dl of the
// tile; dl leaves its accumulators as the A fragment of dq += dl.k (each
// warp its quarter of the channels, 3xTF32) and, in quarter 1, of dl.kp;
// quarter 0 keeps the row sums of dl and of -0.5 dist dl.
struct SmemA {
  ipa_tc::Common c;
  float* qp;      // [kRows][kP3qs]: the block's query points
  float* gopt;    // [kRows][kP3vs]: and their cotangents
  float* rowsum;  // [kRows]
  __host__ __device__ size_t carve(float* base, const ipa_tc::Layout& L) {
    ipa_tc::Carver cv(base);
    c.carve(cv, L);
    qp = cv.take((size_t)ipa_tc::kRows * ipa_tc::kP3qs);
    gopt = cv.take((size_t)ipa_tc::kRows * ipa_tc::kP3vs);
    rowsum = cv.take(ipa_tc::kRows);
    return cv.n;
  }
};

template <int NT>
__global__ void __launch_bounds__(ipa_tc::kThreads, 1)
ipa_bwd_dq_kernel(Inputs in, ipa_tc::Layout L, float* __restrict__ dq,
                  float* __restrict__ dqp, float* __restrict__ dhw_rows) {
  namespace tc = ipa_tc;
  using tc::kKeys;
  using tc::kKQ;
  using tc::kNV;
  extern __shared__ float4 smem4[];
  SmemA s;
  s.carve(reinterpret_cast<float*>(smem4), L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = warp >> 2, qt = warp & 3;  // query tile, channel quarter
  const int h = blockIdx.x, f = blockIdx.y, i0 = blockIdx.z * tc::kRows;
  const int r0 = i0 + 16 * tile;
  const int col = qt * L.CQ;
  const int rr = qt & 1;  // quarters 2, 3: pair rows g + 8 rr
  const bool pair_warp = qt >= 2;
  const float w = in.hw[h];
  const int n_steps = (L.N + kKeys - 1) / kKeys;
  float* xch = s.c.xch + tile * tc::kXchFloats;
  float* sksq = s.c.ksq + tile * kKeys;
  float* spz = s.c.pz + (16 * tile + 8 * rr) * tc::kPZs;

  const float* sqp = s.qp + 16 * tile * tc::kP3qs;  // this tile's rows
  const float* sgopt = s.gopt + 16 * tile * tc::kP3vs;

  tc::zero_padding(s.c, L);
  // the block's query points and their cotangents join the first group
  tc::fetch_rows(s.qp, tc::kP3qs, tc::kMaxP3q, in.qp, f, h, i0, L.P3q, L);
  tc::fetch_rows(s.gopt, tc::kP3vs, tc::kMaxP3v, in.gopt, f, h, i0, L.P3v, L);
  tc::fetch_keys(s.c.tile(0, L), in.k, in.v, in.kp, in.vp, in.mask, in.bias,
                 f, h, i0, 0, true, L);
  if (pair_warp) tc::fetch_pz(spz, in.pz, r0 + 8 * rr, 0, L);

  // the tile's rows in registers
  float qa[NT][4], goa[NT][4];
#pragma unroll
  for (int ks = 0; ks < NT; ++ks) {
    tc::load_afrag(qa[ks], in.q, L, f, h, r0, L.C, col + 8 * ks, L.C);
    tc::load_afrag(goa[ks], in.go, L, f, h, r0, L.C, col + 8 * ks, L.C);
  }
  float gp[tc::kMaxDz / 4];  // zeros past Dz
  if (pair_warp) {
    const int i = r0 + g + 8 * rr;
#pragma unroll
    for (int m = 0; m < tc::kMaxDz / 4; ++m) {
      const int d = t + 4 * m;
      gp[m] = (i < L.N && d < L.Dz) ? in.gpair[tc::at(L, f, i, h, L.Dz, d)]
                                    : 0.f;
    }
  }
  float qm[2], lse[2], dvec[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g + 8 * r;
    const bool ok = i < L.N;
    qm[r] = ok ? in.mask[(size_t)f * L.N + i] : 0.f;
    lse[r] = ok ? in.lse[((size_t)f * L.H + h) * L.N + i] : 0.f;
    dvec[r] = ok ? in.dvec[((size_t)f * L.H + h) * L.N + i] : 0.f;
  }

  float acc[NT][4], dlkp[kKQ][4];
  float rowsum[2] = {0.f, 0.f}, dhw[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < kKQ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dlkp[n][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const int j0 = step * kKeys;
    const tc::KeyTile kt = s.c.tile(step & 1, L);
    if (pair_warp)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    tc::fetch_keys(s.c.tile((step + 1) & 1, L), in.k, in.v, in.kp, in.vp,
                   in.mask, in.bias, f, h, i0, j0 + kKeys, step + 1 < n_steps,
                   L);

    // each warp's share of the products into the exchange
    {
      float x[2][4];
      tc::qk_partial<NT>(
          x,
          [&](int ks, float (&a)[4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = qa[ks][e];
          },
          kt.k, col, L);
      tc::xput(xch, tc::kQK + qt, x);
      tc::qk_partial<NT>(
          x,
          [&](int ks, float (&a)[4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = goa[ks][e];
          },
          kt.v, col, L);
      tc::xput(xch, tc::kGV + qt, x);
    }
    if (qt == 0) {
      float qpa[kKQ][4], qsq[2], dist[2][4];
#pragma unroll
      for (int ks = 0; ks < kKQ; ++ks)
        tc::smem_afrag(qpa[ks], sqp, tc::kP3qs, 8 * ks);
      tc::row_norms(qsq, qpa);
      tc::key_norms(sksq, kt, L);
      __syncwarp();
      tc::point_dist(dist, qpa, qsq, sksq, kt, L);
      tc::xput(xch, tc::kDist, dist);
    } else if (qt == 1) {
      // g_opt . vp^T, 3xTF32
      float gvp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) gvp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kNV; ++ks) {  // zeros past Pv*3
        float a[4];
        tc::smem_afrag(a, sgopt, tc::kP3vs, 8 * ks);
        uint32_t ah[4], al[4];
        tc::split4(a, ah, al);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t bh[2], bl[2];
          tc::bfrag_rows(kt.vp, tc::kP3vs, n, 8 * ks, bh, bl);
          mma3(gvp[n], ah, al, bh, bl);
        }
      }
      tc::xput(xch, tc::kGVP, gvp);
    } else {
      // g_pair_i . pz_ij of row g + 8 rr: sums over this lane's pair
      // channels, then a reduce-scatter over the quad: keys (jj & 7) < 4 to
      // lanes t < 2 and the rest to t >= 2, then odd key pairs to odd t
      cp_async_wait<1>();  // this step's pair_z rows (the key tile may wait)
      __syncwarp();
      float part[kKeys];
      const float* z = spz + g * tc::kPZs + t;  // zeros past Dz
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        float a = 0.f;
#pragma unroll
        for (int m = 0; m < tc::kMaxDz / 4; ++m)
          a = fmaf(gp[m], z[jj * tc::kMaxDz + 4 * m], a);
        part[jj] = a;
      }
      __syncwarp();  // every lane has read the rows
      if (step + 1 < n_steps)
        tc::fetch_pz(spz, in.pz, r0 + 8 * rr, j0 + kKeys, L);
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
        tc::xset(xch, tc::kGPZ, u >> 1, 2 * rr + (u & 1),
                 (even ? hf[sl] : hf[sh]) + recv);
      }
    }
    bar_sync(1 + tile, 128);

    // a and dl of rows g, g + 8 and keys 8 n + 2 t + {0, 1}; the four warps
    // of the tile read the same operands from the exchange and compute the
    // same values
    float dl[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = 8 * n + 2 * t + (e & 1);
        const bool valid = r0 + g + 8 * r < L.N && j0 + c < L.N;
        const float dist = tc::xval(xch, tc::kDist, n, e);
        const float l = tc::ipa_logit(
            tc::xsum4(xch, tc::kQK, n, e),
            kt.bias[(16 * tile + g + 8 * r) * tc::kBS + c], dist, qm[r],
            kt.km[c], w, L);
        const float a = expf(l - lse[r]);
        const float v = a * ((tc::xsum4(xch, tc::kGV, n, e) +
                              tc::xval(xch, tc::kGVP, n, e) +
                              tc::xval(xch, tc::kGPZ, n, e)) -
                             dvec[r]);
        dl[n][e] = valid ? v : 0.f;
        if (qt == 0) {
          rowsum[r] += dl[n][e];
          dhw[r] += -0.5f * dist * dl[n][e];
        }
      }

    // dq += dl . k over this warp's channels, 3xTF32
    uint32_t dh[2][4], dlo[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) tc::split_ctile(dl[ks], dh[ks], dlo[ks]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t bh[2], bl[2];
        tc::bfrag_cols(kt.k, L.Cs, ks, col + 8 * n, bh, bl);
        mma3(acc[n], dh[ks], dlo[ks], bh, bl);
      }
    }
    if (qt == 1) {
      // sum_j dl_ij kp_j, 3xTF32 (zeros past Pq*3)
#pragma unroll
      for (int n = 0; n < kKQ; ++n) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t bh[2], bl[2];
          tc::bfrag_cols(kt.kp, tc::kP3qs, ks, 8 * n, bh, bl);
          mma3(dlkp[n], dh[ks], dlo[ks], bh, bl);
        }
      }
    }
  }

  // epilogue: rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g + 8 * r;
    if (qt == 0) {
      const float rs = quad_sum(rowsum[r]), hw = quad_sum(dhw[r]);
      if (t == 0) {
        s.rowsum[16 * tile + g + 8 * r] = rs;
        if (i < L.N) dhw_rows[((size_t)f * L.H + h) * L.N + i] = hw;
      }
    }
    if (i >= L.N) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = col + 8 * n + 2 * t;
      if (c < L.C)
        *reinterpret_cast<float2*>(dq + tc::at(L, f, i, h, L.C, c)) =
            make_float2(L.c_qk * acc[n][2 * r], L.c_qk * acc[n][2 * r + 1]);
    }
  }
  bar_sync(1 + tile, 128);  // the row sums are in shared memory
  if (qt == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + g + 8 * r;
      if (i >= L.N) continue;
      const float rs = s.rowsum[16 * tile + g + 8 * r];
#pragma unroll
      for (int n = 0; n < kKQ; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t + e;
          if (c < L.P3q) {
            const size_t x = tc::at(L, f, i, h, L.P3q, c);
            dqp[x] = -w * (rs * in.qp[x] - dlkp[n][2 * r + e]);
          }
        }
    }
  }
}

// ---------------------------------------------------------------------------
// kernel B: dk, dkp, dv, dvp. grid (ceil(N/16), H, F)
// ---------------------------------------------------------------------------
struct SmemB {
  RowTile rt;
  KeyTile kt;
  float *a, *dl;       // [16 keys][17]
  float *dk, *dv;      // [16][C]
  float *dlqp;         // [16][P3q]
  float *dvp;          // [16][P3v]
  float *colsum;       // [16]
  __host__ __device__ size_t carve(float* base, const Dims& d) {
    Carver c(base);
    rt.carve(c, d);
    kt.carve(c, d);
    a = c.take(kTile * (kTile + 1));
    dl = c.take(kTile * (kTile + 1));
    dk = c.take(kTile * d.C);
    dv = c.take(kTile * d.C);
    dlqp = c.take(kTile * d.P3q);
    dvp = c.take(kTile * d.P3v);
    colsum = c.take(kTile);
    return c.n;
  }
};

__global__ void __launch_bounds__(kThreads)
ipa_bwd_dkv_kernel(Inputs in, Dims d, float* __restrict__ dk,
                   float* __restrict__ dkp, float* __restrict__ dv,
                   float* __restrict__ dvp) {
  extern __shared__ float4 smem4[];
  SmemB s;
  s.carve(reinterpret_cast<float*>(smem4), d);
  const int j0 = blockIdx.x * kTile, h = blockIdx.y, f = blockIdx.z;
  const int tid = threadIdx.x;
  const float w = in.hw[h];
  const int C4 = d.C / 4;

  load_key_tile(s.kt, in, d, f, h, j0);
  for (int e = tid; e < kTile * d.C; e += kThreads) {
    s.dk[e] = 0.f;
    s.dv[e] = 0.f;
  }
  for (int e = tid; e < kTile * d.P3q; e += kThreads) s.dlqp[e] = 0.f;
  for (int e = tid; e < kTile * d.P3v; e += kThreads) s.dvp[e] = 0.f;
  __syncthreads();
  tile_norms(nullptr, &s.kt, d);

  // keys on the slow index: the 16 lanes that share a key reduce by shuffle
  const int jr = tid / kTile, r = tid % kTile, j = j0 + jr;
  float colsum = 0.f;
  for (int i0 = 0; i0 < d.N; i0 += kTile) {
    load_row_tile(s.rt, in, d, f, h, i0);
    __syncthreads();
    tile_norms(&s.rt, nullptr, d);
    __syncthreads();
    const int i = i0 + r;
    const bool valid = i < d.N && j < d.N;
    const size_t ij = valid ? (size_t)i * d.N + j : 0;
    const Elem e = element(s.rt, s.kt, r, jr, valid,
                           valid ? in.bias[ij * d.H + h] : 0.f,
                           in.pz + ij * d.Dz, w, d);
    colsum += e.dl;
    s.a[jr * (kTile + 1) + r] = e.a;
    s.dl[jr * (kTile + 1) + r] = e.dl;
    __syncthreads();
    // dk += dl^T . q and dv += a^T . g_o: a work item is 4 keys x 4 channels
    for (int it = tid; it < (kTile / kWide) * C4; it += kThreads) {
      const int kg = it / C4, c4 = it % C4;
      float4 ak[kWide], av[kWide];
#pragma unroll
      for (int kk = 0; kk < kWide; ++kk) {
        ak[kk] = reinterpret_cast<const float4*>(s.dk + (kg * kWide + kk) * d.C)[c4];
        av[kk] = reinterpret_cast<const float4*>(s.dv + (kg * kWide + kk) * d.C)[c4];
      }
      for (int rr = 0; rr < kTile; ++rr) {
        const float4 qq = reinterpret_cast<const float4*>(s.rt.q + rr * d.Cs)[c4];
        const float4 gg = reinterpret_cast<const float4*>(s.rt.go + rr * d.Cs)[c4];
#pragma unroll
        for (int kk = 0; kk < kWide; ++kk) {
          const float p = s.dl[(kg * kWide + kk) * (kTile + 1) + rr];
          const float pa = s.a[(kg * kWide + kk) * (kTile + 1) + rr];
          ak[kk].x = fmaf(p, qq.x, ak[kk].x);
          ak[kk].y = fmaf(p, qq.y, ak[kk].y);
          ak[kk].z = fmaf(p, qq.z, ak[kk].z);
          ak[kk].w = fmaf(p, qq.w, ak[kk].w);
          av[kk].x = fmaf(pa, gg.x, av[kk].x);
          av[kk].y = fmaf(pa, gg.y, av[kk].y);
          av[kk].z = fmaf(pa, gg.z, av[kk].z);
          av[kk].w = fmaf(pa, gg.w, av[kk].w);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kWide; ++kk) {
        reinterpret_cast<float4*>(s.dk + (kg * kWide + kk) * d.C)[c4] = ak[kk];
        reinterpret_cast<float4*>(s.dv + (kg * kWide + kk) * d.C)[c4] = av[kk];
      }
    }
    for (int it = tid; it < kTile * d.P3q; it += kThreads) {
      const int kk = it / d.P3q, x = it % d.P3q;
      float acc = s.dlqp[it];
      for (int rr = 0; rr < kTile; ++rr)
        acc = fmaf(s.dl[kk * (kTile + 1) + rr], s.rt.qp[rr * d.P3qs + x], acc);
      s.dlqp[it] = acc;
    }
    for (int it = tid; it < kTile * d.P3v; it += kThreads) {
      const int kk = it / d.P3v, x = it % d.P3v;
      float acc = s.dvp[it];
      for (int rr = 0; rr < kTile; ++rr)
        acc = fmaf(s.a[kk * (kTile + 1) + rr], s.rt.gopt[rr * d.P3vs + x], acc);
      s.dvp[it] = acc;
    }
    __syncthreads();  // the row tile, a and dl are rewritten by the next tile
  }
  colsum = sum16(colsum);
  if (r == 0) s.colsum[jr] = colsum;
  __syncthreads();
  for (int e = tid; e < kTile * C4; e += kThreads) {
    const int kk = e / C4, c4 = e % C4, jj = j0 + kk;
    if (jj < d.N) {
      const float4 a = reinterpret_cast<const float4*>(s.dk + kk * d.C)[c4];
      reinterpret_cast<float4*>(dk + at(d, f, jj, h, d.C, 0))[c4] =
          make_float4(d.c_qk * a.x, d.c_qk * a.y, d.c_qk * a.z, d.c_qk * a.w);
      reinterpret_cast<float4*>(dv + at(d, f, jj, h, d.C, 0))[c4] =
          reinterpret_cast<const float4*>(s.dv + kk * d.C)[c4];
    }
  }
  for (int e = tid; e < kTile * d.P3q; e += kThreads) {
    const int kk = e / d.P3q, x = e % d.P3q, jj = j0 + kk;
    if (jj < d.N)
      dkp[at(d, f, jj, h, d.P3q, x)] =
          -w * (s.colsum[kk] * s.kt.kp[kk * d.P3qs + x] - s.dlqp[e]);
  }
  for (int e = tid; e < kTile * d.P3v; e += kThreads) {
    const int kk = e / d.P3v, x = e % d.P3v, jj = j0 + kk;
    if (jj < d.N) dvp[at(d, f, jj, h, d.P3v, x)] = s.dvp[e];
  }
}

// ---------------------------------------------------------------------------
// kernel C: dbias [N, N, H], dpz [N, N, Dz]. grid (ceil(N/16), ceil(N/16))
// ---------------------------------------------------------------------------
struct SmemC {
  RowTile rt;
  KeyTile kt;
  float *pz;    // [256 elements][Dzs]: the tile's pair_z rows, staged once
  float *dpz;   // [256 elements][Dzs]
  __host__ __device__ size_t carve(float* base, const Dims& d) {
    Carver c(base);
    rt.carve(c, d);
    kt.carve(c, d);
    pz = c.take((size_t)kThreads * d.Dzs);
    dpz = c.take((size_t)kThreads * d.Dzs);
    return c.n;
  }
};

__global__ void __launch_bounds__(kThreads)
ipa_bwd_pair_kernel(Inputs in, Dims d, float* __restrict__ dbias,
                    float* __restrict__ dpz) {
  extern __shared__ float4 smem4[];
  SmemC s;
  s.carve(reinterpret_cast<float*>(smem4), d);
  const int j0 = blockIdx.x * kTile, i0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const int r = tid / kTile, jr = tid % kTile, i = i0 + r, j = j0 + jr;
  const bool valid = i < d.N && j < d.N;
  const size_t ij = valid ? (size_t)i * d.N + j : 0;

  // pair_z of the tile, one coalesced pass: row i holds 16 * Dz
  // consecutive floats
  for (int e = tid; e < kTile * kTile * d.Dz; e += kThreads) {
    const int rr = e / (kTile * d.Dz), rem = e % (kTile * d.Dz);
    const int kk = rem / d.Dz, x = rem % d.Dz;
    const int ii = i0 + rr, jj = j0 + kk;
    s.pz[(rr * kTile + kk) * d.Dzs + x] =
        (ii < d.N && jj < d.N) ? in.pz[((size_t)ii * d.N + jj) * d.Dz + x] : 0.f;
  }
  for (int x = 0; x < d.Dz; ++x) s.dpz[tid * d.Dzs + x] = 0.f;
  float* my_dpz = s.dpz + tid * d.Dzs;
  const float* my_pz = s.pz + tid * d.Dzs;

  for (int h = 0; h < d.H; ++h) {
    const float w = in.hw[h];
    const float bias_ij = valid ? in.bias[ij * d.H + h] : 0.f;
    float dl_sum = 0.f;
    for (int f = 0; f < d.F; ++f) {
      load_row_tile(s.rt, in, d, f, h, i0);
      load_key_tile(s.kt, in, d, f, h, j0);
      __syncthreads();
      tile_norms(&s.rt, &s.kt, d);
      __syncthreads();
      const Elem e = element(s.rt, s.kt, r, jr, valid, bias_ij, my_pz, w, d);
      dl_sum += e.dl;
      const float* gp = s.rt.gpair + r * d.Dzs;
      for (int x = 0; x < d.Dz; ++x) my_dpz[x] = fmaf(e.a, gp[x], my_dpz[x]);
      __syncthreads();  // the tiles are rewritten by the next (h, f)
    }
    if (valid) dbias[ij * d.H + h] = d.c_b * dl_sum;
  }
  for (int e = tid; e < kTile * kTile * d.Dz; e += kThreads) {
    const int rr = e / (kTile * d.Dz), rem = e % (kTile * d.Dz);
    const int kk = rem / d.Dz, x = rem % d.Dz;
    const int ii = i0 + rr, jj = j0 + kk;
    if (ii < d.N && jj < d.N)
      dpz[((size_t)ii * d.N + jj) * d.Dz + x] = s.dpz[(rr * kTile + kk) * d.Dzs + x];
  }
}

size_t smem_bytes_a(const ipa_tc::Layout& L) {
  SmemA s;
  return s.carve(nullptr, L) * sizeof(float);
}

template <typename Smem>
size_t smem_bytes(const Dims& d) {
  Smem s;
  return s.carve(nullptr, d) * sizeof(float);
}

int prepare(const Dims& d, int device) {
  if (d.F < 1 || d.N < 1 || d.H < 1 || d.C < 4 || d.C % 4 != 0 || d.P3q < 3 ||
      d.P3v < 3 || d.Dz < 1 || d.H > 65535 || d.F > 65535 ||
      (d.N + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSetDevice(device);
}

Dims make_dims(int F, int N, int H, int C, int Pq, int Pv, int Dz, float c_qk,
               float c_b, float inf) {
  Dims d;
  d.F = F, d.N = N, d.H = H, d.C = C, d.Cs = padded_c(C);
  d.P3q = 3 * Pq, d.P3qs = padded_odd(3 * Pq);
  d.P3v = 3 * Pv, d.P3vs = padded_odd(3 * Pv);
  d.Dz = Dz, d.Dzs = padded_odd(Dz);
  d.c_qk = c_qk, d.c_b = c_b, d.inf = inf;
  return d;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Each launcher runs its kernel on `stream` and returns cudaGetLastError()
// (0 = the launch was accepted). Layouts are the JAX package's: q, k, v and
// g_o [F, N, H, C]; q_pts, k_pts [F, N, H, Pq*3]; v_pts, g_opt
// [F, N, H, Pv*3]; bias [N, N, H]; pair_z [N, N, Dz]; mask [F, N];
// head_weights [H]; lse and D [F, H, N]; g_pair [F, N, H, Dz]. Outputs:
// A dq like q, dqp like q_pts, dhw_rows [F, H, N]; B dk, dv like k, dkp
// like k_pts, dvp like v_pts; C dbias [N, N, H], dpz [N, N, Dz]. All
// float32 and contiguous; the C-wide tensors 16-byte aligned, C divisible
// by 4; for A also C <= 256, Pq*3 <= 32, Pv*3 <= 48 and Dz <= 32.
#define IPA_BWD_INPUTS                                                       \
  const float *q, const float *k, const float *v, const float *q_pts,        \
      const float *k_pts, const float *v_pts, const float *bias,             \
      const float *pair_z, const float *mask, const float *head_weights,     \
      const float *lse, const float *dvec, const float *g_o,                 \
      const float *g_opt, const float *g_pair
#define IPA_BWD_SHAPES                                                       \
  int F, int N, int H, int C, int Pq, int Pv, int Dz, float c_qk, float c_b, \
      float inf, int device, cudaStream_t stream
#define IPA_BWD_PACK                                                         \
  Inputs in{q,   k,   v,          q_pts, k_pts, v_pts, bias,  pair_z,        \
            mask, head_weights, lse,   dvec,  g_o,   g_opt, g_pair};         \
  const Dims d = make_dims(F, N, H, C, Pq, Pv, Dz, c_qk, c_b, inf);          \
  int err = prepare(d, device);                                              \
  if (err) return err;

extern "C" int ipa_attention_bwd_dq(IPA_BWD_INPUTS, float* dq, float* dqp,
                                    float* dhw_rows, IPA_BWD_SHAPES) {
  IPA_BWD_PACK
  if (!ipa_tc::layout_ok(N, H, C, 3 * Pq, 3 * Pv, Dz))
    return (int)cudaErrorInvalidValue;
  const ipa_tc::Layout L =
      ipa_tc::make_layout(N, H, C, 3 * Pq, 3 * Pv, Dz, c_qk, c_b, inf,
                          (reinterpret_cast<uintptr_t>(pair_z) & 15) == 0);
  const size_t smem = smem_bytes_a(L);
  if (smem > (size_t)ipa_tc::kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = ipa_tc::tiles_for(C) == ipa_tc::kMaxNT
                    ? ipa_bwd_dq_kernel<ipa_tc::kMaxNT>
                    : ipa_bwd_dq_kernel<1>;
  if ((err = set_smem(kernel, smem))) return err;
  const dim3 grid(H, F, (N + ipa_tc::kRows - 1) / ipa_tc::kRows);
  kernel<<<grid, ipa_tc::kThreads, smem, stream>>>(in, L, dq, dqp, dhw_rows);
  return (int)cudaGetLastError();
}

extern "C" int ipa_attention_bwd_dkv(IPA_BWD_INPUTS, float* dk, float* dkp,
                                     float* dv, float* dvp, IPA_BWD_SHAPES) {
  IPA_BWD_PACK
  const size_t smem = smem_bytes<SmemB>(d);
  if ((err = set_smem(ipa_bwd_dkv_kernel, smem))) return err;
  const dim3 grid((N + kTile - 1) / kTile, H, F);
  ipa_bwd_dkv_kernel<<<grid, kThreads, smem, stream>>>(in, d, dk, dkp, dv, dvp);
  return (int)cudaGetLastError();
}

extern "C" int ipa_attention_bwd_pair(IPA_BWD_INPUTS, float* dbias, float* dpz,
                                      IPA_BWD_SHAPES) {
  IPA_BWD_PACK
  const size_t smem = smem_bytes<SmemC>(d);
  if ((err = set_smem(ipa_bwd_pair_kernel, smem))) return err;
  const dim3 grid((N + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  ipa_bwd_pair_kernel<<<grid, kThreads, smem, stream>>>(in, d, dbias, dpz);
  return (int)cudaGetLastError();
}

// dynamic shared-memory bytes per block of kernel 0 (A), 1 (B) or 2 (C)
extern "C" long long ipa_attention_bwd_smem(int which, int C, int Pq, int Pv,
                                            int Dz) {
  const Dims d = make_dims(1, 1, 1, C, Pq, Pv, Dz, 0.f, 0.f, 0.f);
  switch (which) {
    case 0:
      return (long long)smem_bytes_a(ipa_tc::make_layout(
          1, 1, C, 3 * Pq, 3 * Pv, Dz, 0.f, 0.f, 0.f, true));
    case 1: return (long long)smem_bytes<SmemB>(d);
    case 2: return (long long)smem_bytes<SmemC>(d);
    default: return -1;
  }
}

extern "C" const char* ipa_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
