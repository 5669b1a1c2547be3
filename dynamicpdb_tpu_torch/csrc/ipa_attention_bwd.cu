// Invariant Point Attention backward, flash style, for sm_90a: three kernels
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
// One logit: all three build it with the forward's code (ipa_tile.cuh:
// qk_partial, point_dist or its transposed twin, row_norms, norms16,
// ipa_logit, the quarters summed by xsum4), so a_ij is the forward's. On the
// TPU the last grid axis runs in order and the kernels accumulate in scratch
// across it. Here that axis becomes a loop inside one block, so every output
// element is written by exactly one block: no atomics, the same bits from
// run to run, and no buffer beyond the outputs (shared memory and registers
// hold every N x N quantity).
//
// Bound on an H100 (2 FLOP per multiply-add): the tile recompute costs
// about 1,220 FLOP per (f, h, i, j) element (q.k and g_o.v over C, the
// point and pair terms); A adds about 560, B about 1,150, C about 65. At
// the release shapes (F=2, N=256, H=8, C=256, Pq=8, Pv=12, Dz=32) that is
// 1.87, 2.48 and 1.35 GFLOP, against 30-40 MB of compulsory traffic each.
// On the CUDA cores (67 TFLOP/s float32) 28, 37 and 20 us. With the
// products on the TF32 tensor cores (495 TFLOP/s) in three passes and the
// rest on the CUDA cores: 11.5, 15.2 and 12.0 us (the last the bytes;
// chip_smoke.ipa_bwd_cost, bounds).
//
// Passes. Every float32 product on the tensor cores (mma.sync m16n8k8, TF32
// in, float32 accumulators) runs in three passes of operands split into a
// TF32 high and low part (3xTF32, tf32_mma.cuh split, mma3): at the release
// widths one pass misses BWD_RTOL x each gradient's largest magnitude by
// 6-9x, three land 23-45x inside it (tests/test_torch_ipa_precision.py).
//   A: q.k^T, g_o.v^T, dl.k (C wide, 86% of A's operations), qp.kp^T (24
//      wide), g_opt.vp^T (36), dl.kp (24);
//   B: k.q^T, v.g_o^T, dl^T.q, a^T.g_o (C wide, 87% of B's operations),
//      kp.qp^T, vp.g_opt^T, dl^T.qp, a^T.g_opt;
//   C: q.k^T, g_o.v^T (C wide, 80% of C's operations), qp.kp^T,
//      g_opt.vp^T.
// On the CUDA cores in float32: the pair terms (a different matrix per
// query row, no product within one (f, h)): g_pair_i.pz_ij in all three, and
// in C dpz += a_ij g_pair_i, a rank-1 update a (f, h) in registers.
//
// Limits: C % 4 == 0 up to 256, Pq*3 <= 32, Pv*3 <= 48, Dz <= 32, every N
// (rows and keys past N are zero-filled and their elements get a = dl = 0;
// pad rows, mask 0, are computed exactly as the reference does).
// Rectangular calls (ipa_tile.cuh): Nq query rows against Nk keys, a query
// mask and a key mask; B's dk/dv are then the sums over this call's rows
// only (sequence parallelism adds the ranks' sums), C's dbias and dpz are
// [Nq, Nk, .], and the grids run over Nq rows (A, C) and Nk keys (B, C).
// Every loop of the tile code runs to a compile-time bound (ipa_tile.cuh
// Layout).
//
// Kernel A (dq): the forward's row-stationary layout (ipa_tile.cuh), 32
// query rows of one (f, h) a block, grid (H, F, ceil(N/32)); per 16-key step
// the tile recompute (tile_products, tile_a_dl), then dq += dl.k from dl's
// accumulators. ptxas 250 registers at C = 256 (168 at C <= 32), no
// spills; 184,192 bytes of shared memory, one block of 8 warps an SM.
//
// Kernel B (dk/dv): key-stationary, 32 keys of one (f, h) a block (two
// 16-key tiles, four channel-quarter warps each), head fastest on the grid
// (H, F, ceil(N/32)): 128 blocks at the release shapes. The block's v rows
// and key points stay in shared memory, its k as raw A fragments in
// registers (each warp its quarter); 16 query rows a step arrive by
// cp.async. Per step a warp computes its quarter of the transposed tile
// k.q^T and v.g_o^T (keys x rows, M = keys), quarter 0 the point
// distances, quarter 1 vp.g_opt^T, quarters 2 and 3 the pair term of keys
// g + 8 rr; after the exchange a^T and dl^T sit in mma accumulators in the
// layout of the next products' A fragments (rows as the permuted depth), so
// dk += dl^T.q and dv += a^T.g_o take them without a trip through shared
// memory, each warp its channel quarter; quarter 0 adds dl^T.qp and the
// column sums, quarter 1 a^T.g_opt. What this does about the first
// version's limits:
//   1. one thread per (row, key) with two 256-long dot products alone: the
//      four C-wide products are mma tiles, k's fragments held, v's read;
//   2. dk and dv rewritten in shared memory on every row tile on the CUDA
//      cores: in mma accumulators, 64 registers a lane;
//   3. synchronous loads, four block barriers a tile: q, g_o, their points,
//      g_pair, lse, D, the row mask and the bias tile [16 rows][32 keys]
//      come by cp.async into the other of two buffers, one block barrier a
//      step; each pair warp's pair_z tile [16 rows][8 keys][Dz] by cp.async
//      (16-byte copies at Dz = 32, stored XOR-swizzled so the 16-byte reads
//      of a quarter warp meet 8 distinct bank groups), refetched once read;
//   4. strided bias and pair_z reads: the bias tile by 4-byte cp.async, the
//      H blocks of a key block (head fastest) sharing each [N, N, H] sector
//      and each pair_z tile in L2.
// Departures from a literal double-buffered key-stationary design: a block
// has 227 KB; v (33 KB), two row steps (87 KB), the pair tiles (64 KB) and
// the exchange (22 KB) fill it, so k waits in registers, not shared memory,
// and pair_z is single-buffered per warp, as in A. The tile is computed
// transposed, not in the forward's orientation with a and dl passed through
// shared memory: the same products, each element's passes in the same
// order (mma3t), without that round trip. ptxas 255 registers at C = 256
// (161 at C <= 32), no spills; 220,416 bytes of shared memory at the
// release widths, one block an SM.
//
// Kernel C (pair): row-stationary, the (i, j) tile of 32 rows and 16 keys a
// block, grid (ceil(N/16), ceil(N/32)): 128 blocks at the release shapes;
// inside, the (head, frame) loop of the TPU kernel's grid. Per (h, f) it
// runs A's tile recompute (tile_products, tile_a_dl: the same code) on
// that (f, h)'s key tile, double-buffered by cp.async with the rows' points;
// q and g_o arrive as A fragments straight from L2 into registers, the next
// (f, h)'s loaded as soon as this one's products have read them. Quarter 0
// keeps dbias over the frames in registers and writes it once per head;
// every warp keeps dpz of its 8 elements for 8 pair channels (its quarter
// of Dz) in registers, 64 a lane, rank-1 updates on the CUDA cores. The
// tile's pair_z (64 KB at Dz = 32) is fetched once. What this does about
// the first version's limits:
//   1. the attention recomputed per element on the CUDA cores: A's tensor-
//      core tile code;
//   2. both tiles restaged with two block barriers for every (h, f): k, v,
//      their points and the bias by cp.async into the other buffer while
//      the block computes, one block barrier an (h, f); q and g_o not staged
//      at all;
//   3. dpz as rank-1 updates in shared memory per element: in registers.
// Departure: a_ij of every (f, h) kept in shared memory for one dpz product
// at the end would fit at the release shapes (32 KB more, 228,096 bytes)
// but bounds F H at 16 or needs chunks; the rank-1 updates in registers
// take any F and H, and cost 0.012 of the kernel's 0.169 ms, the most the
// other design could save (PERF.md section 6). ptxas 255 registers at
// C = 256 (225 at C <= 32), no spills; 195,328 bytes of shared memory at
// the release widths, one block an SM.
//
// Times on the card, the A/B against the CUDA-core versions and where the
// time goes (tools/bench_ipa.py --ablate): PERF.md section 6.
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "ipa_tile.cuh"

namespace {

using namespace ipa_tc;

struct Inputs {
  const float *q, *k, *v, *qp, *kp, *vp, *bias, *pz, *mask, *kmask, *hw,
      *lse, *dvec, *go, *gopt, *gpair;
};

// ---------------------------------------------------------------------------
// kernel A: dq, dqp, dhw rows. grid (H, F, ceil(N/32))
// ---------------------------------------------------------------------------
// A warp keeps its quarter of q and of g_o as A fragments (32 registers each
// at C = 256; the query points and g_opt wait in shared memory); after the
// exchange dl leaves its accumulators as the A fragment of dq += dl.k (each
// warp its quarter of the channels, 3xTF32) and, in quarter 1, of dl.kp;
// quarter 0 keeps the row sums of dl and of -0.5 dist dl.
struct SmemA {
  Common c;
  float* qp;      // [kRows][kP3qs]: the block's query points
  float* gopt;    // [kRows][kP3vs]: and their cotangents
  float* rowsum;  // [kRows]
  __host__ __device__ size_t carve(float* base, const Layout& L) {
    Carver cv(base);
    c.carve(cv, L);
    qp = cv.take((size_t)kRows * kP3qs);
    gopt = cv.take((size_t)kRows * kP3vs);
    rowsum = cv.take(kRows);
    return cv.n;
  }
};

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
ipa_bwd_dq_kernel(Inputs in, Layout L, float* __restrict__ dq,
                  float* __restrict__ dqp, float* __restrict__ dhw_rows) {
  extern __shared__ float4 smem4[];
  SmemA s;
  s.carve(reinterpret_cast<float*>(smem4), L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = warp >> 2, qt = warp & 3;  // query tile, channel quarter
  const int h = blockIdx.x, f = blockIdx.y, i0 = blockIdx.z * kRows;
  const int r0 = i0 + 16 * tile;
  const int col = qt * L.CQ;
  const int rr = qt & 1;  // quarters 2, 3: pair rows g + 8 rr
  const bool pair_warp = qt >= 2;
  const float w = in.hw[h];
  const int n_steps = (L.Nk + kKeys - 1) / kKeys;
  float* xch = s.c.xch + tile * kXchFloats;
  float* sksq = s.c.ksq + tile * kKeys;
  float* spz = s.c.pz + (16 * tile + 8 * rr) * kPZs;

  const float* sqp = s.qp + 16 * tile * kP3qs;  // this tile's rows
  const float* sgopt = s.gopt + 16 * tile * kP3vs;

  zero_padding(s.c, L);
  // the block's query points and their cotangents join the first group
  fetch_rows(s.qp, kP3qs, kMaxP3q, in.qp, f, h, i0, L.P3q, L);
  fetch_rows(s.gopt, kP3vs, kMaxP3v, in.gopt, f, h, i0, L.P3v, L);
  fetch_keys(s.c.tile(0, L), in.k, in.v, in.kp, in.vp, in.kmask, in.bias, f,
             h, i0, 0, true, L);
  if (pair_warp) fetch_pz(spz, in.pz, r0 + 8 * rr, 0, L);

  // the tile's rows in registers
  float qa[NT][4], goa[NT][4];
#pragma unroll
  for (int ks = 0; ks < NT; ++ks) {
    load_afrag(qa[ks], in.q, L, L.Nq, f, h, r0, L.C, col + 8 * ks, L.C);
    load_afrag(goa[ks], in.go, L, L.Nq, f, h, r0, L.C, col + 8 * ks, L.C);
  }
  float gp[kMaxDz / 4];  // zeros past Dz
  if (pair_warp) {
    const int i = r0 + g + 8 * rr;
#pragma unroll
    for (int m = 0; m < kMaxDz / 4; ++m) {
      const int d = t + 4 * m;
      gp[m] = (i < L.Nq && d < L.Dz) ? in.gpair[atq(L, f, i, h, L.Dz, d)]
                                     : 0.f;
    }
  }
  float qm[2], lse[2], dvec[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g + 8 * r;
    const bool ok = i < L.Nq;
    qm[r] = ok ? in.mask[(size_t)f * L.Nq + i] : 0.f;
    lse[r] = ok ? in.lse[((size_t)f * L.H + h) * L.Nq + i] : 0.f;
    dvec[r] = ok ? in.dvec[((size_t)f * L.H + h) * L.Nq + i] : 0.f;
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
    const KeyTile kt = s.c.tile(step & 1, L);
    if (pair_warp)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    fetch_keys(s.c.tile((step + 1) & 1, L), in.k, in.v, in.kp, in.vp,
               in.kmask, in.bias, f, h, i0, j0 + kKeys, step + 1 < n_steps,
               L);

    tile_products<NT>(xch, sksq, qa, goa, sqp, sgopt, spz, gp, kt, col, qt,
                      [&] {
                        if (step + 1 < n_steps)
                          fetch_pz(spz, in.pz, r0 + 8 * rr, j0 + kKeys, L);
                      },
                      [](int) {}, L);
    bar_sync(1 + tile, 128);

    float a[2][4], dl[2][4], dist[2][4];
    tile_a_dl(a, dl, dist, xch, kt, tile, qm, lse, dvec, w, r0, j0, L);
    if (qt == 0) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          rowsum[e >> 1] += dl[n][e];
          dhw[e >> 1] += -0.5f * dist[n][e] * dl[n][e];
        }
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
    if (qt == 1) {
      // sum_j dl_ij kp_j, 3xTF32 (zeros past Pq*3)
#pragma unroll
      for (int n = 0; n < kKQ; ++n) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t bh[2], bl[2];
          bfrag_cols(kt.kp, kP3qs, ks, 8 * n, bh, bl);
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
        if (i < L.Nq) dhw_rows[((size_t)f * L.H + h) * L.Nq + i] = hw;
      }
    }
    if (i >= L.Nq) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = col + 8 * n + 2 * t;
      if (c < L.C)
        *reinterpret_cast<float2*>(dq + atq(L, f, i, h, L.C, c)) =
            make_float2(L.c_qk * acc[n][2 * r], L.c_qk * acc[n][2 * r + 1]);
    }
  }
  bar_sync(1 + tile, 128);  // the row sums are in shared memory
  if (qt == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + g + 8 * r;
      if (i >= L.Nq) continue;
      const float rs = s.rowsum[16 * tile + g + 8 * r];
#pragma unroll
      for (int n = 0; n < kKQ; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t + e;
          if (c < L.P3q) {
            const size_t x = atq(L, f, i, h, L.P3q, c);
            dqp[x] = -w * (rs * in.qp[x] - dlkp[n][2 * r + e]);
          }
        }
    }
  }
}

// ---------------------------------------------------------------------------
// kernel B: dk, dkp, dv, dvp. grid (H, F, ceil(N/32))
// ---------------------------------------------------------------------------
constexpr int kBKeys = 16 * kTiles;      // keys per block: two 16-key tiles
constexpr int kStep = 16;                // query rows per step: 2 n-tiles
constexpr int kRB = kBKeys + 4;          // bias tile row stride: 4 mod 16
constexpr int kGPs = kMaxDz + 4;         // g_pair row stride: 4 mod 16
constexpr int kPZB = kStep * 8 * kMaxDz; // a pair warp's [16 rows][8 keys][32]

// The pair_z tile is stored with its 16-byte chunks XOR-swizzled: chunk x
// of (row r, key kk) at chunk x ^ pz_swz(r, kk). A quarter warp's 16-byte
// reads (lanes g = 0, 1 and t = 0..3 reading rows 2t + e of key g) then fall
// in 8 distinct bank groups.
__host__ __device__ inline int pz_swz(int r, int kk) {
  return (kk + 2 * (r >> 1)) & 7;
}

__host__ __device__ inline int pz_index(int r, int kk, int d) {
  return r * 8 * kMaxDz + kk * kMaxDz + 4 * ((d >> 2) ^ pz_swz(r, kk)) +
         (d & 3);
}

// One step's query rows; two of them double-buffer the steps.
struct RowStep {
  float *q, *go;           // [kStep][Cs]
  float *qp;               // [kStep][kP3qs]
  float *gopt;             // [kStep][kP3vs]
  float *gpair;            // [kStep][kGPs]
  float *lse, *dvec, *qm;  // [kStep]
  float *bias;             // [kStep][kRB]: the block's 32 keys
};

__host__ __device__ inline RowStep row_step(Carver& c, const Layout& L) {
  RowStep r;
  r.q = c.take((size_t)kStep * L.Cs);
  r.go = c.take((size_t)kStep * L.Cs);
  r.qp = c.take((size_t)kStep * kP3qs);
  r.gopt = c.take((size_t)kStep * kP3vs);
  r.gpair = c.take((size_t)kStep * kGPs);
  r.lse = c.take(kStep);
  r.dvec = c.take(kStep);
  r.qm = c.take(kStep);
  r.bias = c.take((size_t)kStep * kRB);
  return r;
}

struct SmemB {
  float* v;         // [kBKeys][Cs]: the block's keys, resident
  float *kp, *vp;   // [kBKeys][kP3qs], [kBKeys][kP3vs]
  float *km, *ksq;  // [kBKeys]
  float* rows;      // two row steps of row_floats each
  size_t row_floats;
  float* pz;        // [kTiles][2][kPZB]: the pair warps' tiles
  float* qsq;       // [kTiles][kStep]: |qp|^2 of the step's rows
  float* xch;       // [kTiles][kXchFloats]
  __host__ __device__ size_t carve(float* base, const Layout& L) {
    Carver c(base);
    v = c.take((size_t)kBKeys * L.Cs);
    kp = c.take((size_t)kBKeys * kP3qs);
    vp = c.take((size_t)kBKeys * kP3vs);
    km = c.take(kBKeys);
    ksq = c.take(kBKeys);
    Carver one(nullptr);
    row_step(one, L);
    row_floats = one.n;
    rows = c.take(2 * row_floats);
    pz = c.take((size_t)kTiles * 2 * kPZB);
    qsq = c.take((size_t)kTiles * kStep);
    xch = c.take((size_t)kTiles * kXchFloats);
    return c.n;
  }
  __device__ RowStep step(int b, const Layout& L) const {
    Carver c(rows + b * row_floats);
    return row_step(c, L);
  }
};

// Zero what cp.async never writes and the products read: channels
// [C, 4 CQ) of v and of both steps' q and g_o, point columns past P3q and
// P3v, pair channels past Dz of g_pair and of the pair_z tiles.
__device__ void zero_padding_b(const SmemB& s, const Layout& L) {
  const int tid = threadIdx.x;
  const int pc = 4 * L.CQ - L.C;
  const int pq = kMaxP3q - L.P3q, pv = kMaxP3v - L.P3v, pd = kMaxDz - L.Dz;
  if (pc)
    deal(kBKeys, pc, tid, kThreads,
         [&](int r, int x) { s.v[r * L.Cs + L.C + x] = 0.f; });
  if (pq)
    deal(kBKeys, pq, tid, kThreads,
         [&](int r, int x) { s.kp[r * kP3qs + L.P3q + x] = 0.f; });
  if (pv)
    deal(kBKeys, pv, tid, kThreads,
         [&](int r, int x) { s.vp[r * kP3vs + L.P3v + x] = 0.f; });
  for (int b = 0; b < 2; ++b) {
    const RowStep rs = s.step(b, L);
    if (pc)
      deal(kStep, pc, tid, kThreads, [&](int r, int x) {
        rs.q[r * L.Cs + L.C + x] = 0.f;
        rs.go[r * L.Cs + L.C + x] = 0.f;
      });
    if (pq)
      deal(kStep, pq, tid, kThreads,
           [&](int r, int x) { rs.qp[r * kP3qs + L.P3q + x] = 0.f; });
    if (pv)
      deal(kStep, pv, tid, kThreads,
           [&](int r, int x) { rs.gopt[r * kP3vs + L.P3v + x] = 0.f; });
    if (pd)
      deal(kStep, pd, tid, kThreads,
           [&](int r, int x) { rs.gpair[r * kGPs + L.Dz + x] = 0.f; });
  }
  if (pd)  // (pair tile, row, key) rk
    deal(kTiles * 2 * kStep * 8, pd, tid, kThreads, [&](int rk, int x) {
      s.pz[(rk >> 7) * kPZB + pz_index((rk >> 3) & 15, rk & 7, L.Dz + x)] =
          0.f;
    });
}

// The block's keys j0.. j0 + 31 of (f, h): v rows, key points, value points
// and key mask, zero past Nk; not committed (the first row step's commit
// takes them).
__device__ void fetch_block_keys(const SmemB& s, const Inputs& in, int f,
                                 int h, int j0, const Layout& L) {
  const int tid = threadIdx.x;
  const int nk = min(kBKeys, L.Nk - j0);
  deal(kBKeys, L.C / 4, tid, kThreads, [&](int r, int c4) {
    const bool ok = r < nk;
    cp_async16(s.v + r * L.Cs + 4 * c4,
               in.v + (ok ? atk(L, f, j0 + r, h, L.C, 4 * c4) : 0), ok);
  });
  deal(kBKeys, L.P3q, tid, kThreads, [&](int r, int x) {
    const bool ok = r < nk;
    cp_async4(s.kp + r * kP3qs + x,
              in.kp + (ok ? atk(L, f, j0 + r, h, L.P3q, x) : 0), ok);
  });
  deal(kBKeys, L.P3v, tid, kThreads, [&](int r, int x) {
    const bool ok = r < nk;
    cp_async4(s.vp + r * kP3vs + x,
              in.vp + (ok ? atk(L, f, j0 + r, h, L.P3v, x) : 0), ok);
  });
  if (tid < kBKeys) {
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
    const int nr = min(kStep, L.Nq - i0);  // real rows of the step
    deal(kStep, L.C / 4, tid, kThreads, [&](int r, int c4) {
      const bool ok = r < nr;
      const size_t src = ok ? atq(L, f, i0 + r, h, L.C, 4 * c4) : 0;
      cp_async16(rs.q + r * L.Cs + 4 * c4, in.q + src, ok);
      cp_async16(rs.go + r * L.Cs + 4 * c4, in.go + src, ok);
    });
    deal(kStep, L.P3q, tid, kThreads, [&](int r, int x) {
      const bool ok = r < nr;
      cp_async4(rs.qp + r * kP3qs + x,
                in.qp + (ok ? atq(L, f, i0 + r, h, L.P3q, x) : 0), ok);
    });
    deal(kStep, L.P3v, tid, kThreads, [&](int r, int x) {
      const bool ok = r < nr;
      cp_async4(rs.gopt + r * kP3vs + x,
                in.gopt + (ok ? atq(L, f, i0 + r, h, L.P3v, x) : 0), ok);
    });
    deal(kStep, L.Dz, tid, kThreads, [&](int r, int x) {
      const bool ok = r < nr;
      cp_async4(rs.gpair + r * kGPs + x,
                in.gpair + (ok ? atq(L, f, i0 + r, h, L.Dz, x) : 0), ok);
    });
    if (tid < kStep) {
      const bool ok = tid < nr;
      const size_t row = ok ? ((size_t)f * L.H + h) * L.Nq + i0 + tid : 0;
      cp_async4(rs.lse + tid, in.lse + row, ok);
      cp_async4(rs.dvec + tid, in.dvec + row, ok);
      cp_async4(rs.qm + tid,
                in.mask + (ok ? (size_t)f * L.Nq + i0 + tid : 0), ok);
    }
    const int nk = min(kBKeys, L.Nk - j0);
    for (int e = tid; e < kStep * kBKeys; e += kThreads) {
      const int r = e / kBKeys, c = e % kBKeys;
      const bool ok = r < nr && c < nk;
      cp_async4(rs.bias + r * kRB + c,
                in.bias + (ok ? ((size_t)(i0 + r) * L.Nk + j0 + c) * L.H + h
                              : 0),
                ok);
    }
  }
  cp_async_commit();
}

// pair_z rows i0.. i0 + 15 and keys jb.. jb + 7 into dst (pz_index), by
// one warp, as one cp.async group: at Dz = 32 each row's 8 keys are one
// contiguous run of [Nq, Nk, Dz], copied 16 bytes at a time.
__device__ void fetch_pz_keys(float* dst, const float* __restrict__ pz,
                              int i0, int jb, const Layout& L) {
  const int lane = threadIdx.x & 31;
  if (L.pz_vec) {
    for (int e = lane; e < kStep * 8 * 8; e += 32) {
      const int r = e >> 6, kk = (e >> 3) & 7, x = e & 7;
      const int i = i0 + r, j = jb + kk;
      const bool ok = i < L.Nq && j < L.Nk;
      cp_async16(dst + pz_index(r, kk, 4 * x),
                 ok ? pz + ((size_t)i * L.Nk + j) * kMaxDz + 4 * x : pz, ok);
    }
  } else {
    const int per_row = 8 * L.Dz;
    for (int e = lane; e < kStep * per_row; e += 32) {
      const int r = e / per_row, rem = e - r * per_row;
      const int kk = rem / L.Dz, d = rem - kk * L.Dz;
      const int i = i0 + r, j = jb + kk;
      const bool ok = i < L.Nq && j < L.Nk;
      cp_async4(dst + pz_index(r, kk, d),
                ok ? pz + ((size_t)i * L.Nk + j) * L.Dz + d : pz, ok);
    }
  }
  cp_async_commit();
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
ipa_bwd_dkv_kernel(Inputs in, Layout L, float* __restrict__ dk,
                   float* __restrict__ dkp, float* __restrict__ dv,
                   float* __restrict__ dvp) {
  extern __shared__ float4 smem4[];
  SmemB s;
  s.carve(reinterpret_cast<float*>(smem4), L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kt = warp >> 2, qt = warp & 3;  // key tile, channel quarter
  const int h = blockIdx.x, f = blockIdx.y, j0 = blockIdx.z * kBKeys;
  const int k0 = 16 * kt;  // the tile's first key in the block
  const int col = qt * L.CQ;
  const int rr = qt & 1;  // quarters 2, 3: pair keys g + 8 rr
  const bool pair_warp = qt >= 2;
  const float w = in.hw[h];
  const int n_steps = (L.Nq + kStep - 1) / kStep;
  float* xch = s.xch + kt * kXchFloats;
  float* sqsq = s.qsq + kt * kStep;
  float* spz = s.pz + (2 * kt + rr) * kPZB;
  const int swz = pz_swz(2 * t, g);  // of every row this lane reads

  zero_padding_b(s, L);
  fetch_block_keys(s, in, f, h, j0, L);
  fetch_row_step(s.step(0, L), in, f, h, 0, j0, true, L);
  if (pair_warp) fetch_pz_keys(spz, in.pz, 0, j0 + k0 + 8 * rr, L);

  // this warp's quarter of the tile's k, as A fragments
  float ka[NT][4];
#pragma unroll
  for (int ks = 0; ks < NT; ++ks)
    load_afrag(ka[ks], in.k, L, L.Nk, f, h, j0 + k0, L.C, col + 8 * ks,
               L.C);

  // dk and dv of keys g, g + 8 over this warp's channels; pacc: dl^T.qp in
  // quarter 0, a^T.g_opt in quarter 1
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
    const int i0 = step * kStep;
    const RowStep rs = s.step(step & 1, L);
    if (pair_warp)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    fetch_row_step(s.step((step + 1) & 1, L), in, f, h, i0 + kStep, j0,
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
      xput(xch, kQK + qt, x);
      qk_partial<NT, true>(
          x,
          [&](int ks, float (&a)[4]) {
            smem_afrag(a, s.v + k0 * L.Cs, L.Cs, col + 8 * ks);
          },
          rs.go, col, L);
      xput(xch, kGV + qt, x);
    }
    if (qt == 0) {
      // dist = |qp_i|^2 + |kp_j|^2 - 2 kp_j.qp_i, the norms by the
      // forward's code (rows: row_norms, keys: norms16)
      if (step == 0) norms16(s.ksq + k0, s.kp + k0 * kP3qs, kP3qs);
      float qpa[kKQ][4], qsq[2];
#pragma unroll
      for (int ks = 0; ks < kKQ; ++ks)
        smem_afrag(qpa[ks], rs.qp, kP3qs, 8 * ks);
      row_norms(qsq, qpa);
      if (t == 0) {
        sqsq[g] = qsq[0];
        sqsq[g + 8] = qsq[1];
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
        smem_afrag(a, s.kp + k0 * kP3qs, kP3qs, 8 * ks);
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
          dist[n][e] = sqsq[8 * n + 2 * t + (e & 1)] +
                       s.ksq[k0 + g + 8 * (e >> 1)] - 2.f * cross[n][e];
      xput(xch, kDist, dist);
    } else if (qt == 1) {
      // vp . g_opt^T, 3xTF32
      float gvp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) gvp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kNV; ++ks) {  // zeros past Pv*3
        float a[4];
        smem_afrag(a, s.vp + k0 * kP3vs, kP3vs, 8 * ks);
        uint32_t ah[4], al[4];
        split4(a, ah, al);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t bh[2], bl[2];
          bfrag_rows(rs.gopt, kP3vs, n, 8 * ks, bh, bl);
          mma3t(gvp[n], ah, al, bh, bl);
        }
      }
      xput(xch, kGVP, gvp);
    } else {
      // g_pair_i . pz_ij of key g + 8 rr and rows 8 n + 2 t + e: every
      // pair channel of the element in this lane, 16-byte reads
      cp_async_wait<1>();  // this step's pair_z tile (the next rows may wait)
      __syncwarp();
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * n + 2 * t + e;
          const float4* gp4 = reinterpret_cast<const float4*>(rs.gpair +
                                                              r * kGPs);
          const float* z = spz + r * 8 * kMaxDz + g * kMaxDz;
          float acc = 0.f;
#pragma unroll
          for (int x = 0; x < kMaxDz / 4; ++x) {  // zeros past Dz
            const float4 p = gp4[x];
            const float4 q = *reinterpret_cast<const float4*>(
                z + 4 * (x ^ swz));
            acc = fmaf(p.x, q.x, acc);
            acc = fmaf(p.y, q.y, acc);
            acc = fmaf(p.z, q.z, acc);
            acc = fmaf(p.w, q.w, acc);
          }
          xset(xch, kGPZ, n, 2 * rr + e, acc);
        }
      __syncwarp();  // every lane has read the tile
      if (step + 1 < n_steps)
        fetch_pz_keys(spz, in.pz, i0 + kStep, j0 + k0 + 8 * rr, L);
    }
    bar_sync(1 + kt, 128);

    // a^T and dl^T of keys g, g + 8 and rows 8 n + 2 t + {0, 1}; the four
    // warps of the tile read the same operands and compute the same values
    float a[2][4], dl[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = k0 + g + 8 * (e >> 1), r = 8 * n + 2 * t + (e & 1);
        const bool valid = i0 + r < L.Nq && j0 + kr < L.Nk;
        const float l =
            ipa_logit(xsum4(xch, kQK, n, e), rs.bias[r * kRB + kr],
                      xval(xch, kDist, n, e), rs.qm[r], s.km[kr], w, L);
        const float av = expf(l - rs.lse[r]);
        const float v = av * ((xsum4(xch, kGV, n, e) +
                               xval(xch, kGVP, n, e) +
                               xval(xch, kGPZ, n, e)) -
                              rs.dvec[r]);
        a[n][e] = valid ? av : 0.f;
        dl[n][e] = valid ? v : 0.f;
        if (qt == 0) colsum[e >> 1] += dl[n][e];
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
    if (qt == 0) {
      // sum_i dl_ij qp_i (zeros past Pq*3)
#pragma unroll
      for (int n = 0; n < kKQ; ++n)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t bh[2], bl[2];
          bfrag_cols(rs.qp, kP3qs, ks, 8 * n, bh, bl);
          mma3(pacc[n], dh[ks], dlo[ks], bh, bl);
        }
    } else if (qt == 1) {
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

  // epilogue: keys g, g + 8 of the tile
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = k0 + g + 8 * r, j = j0 + kr;
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
    if (qt == 0) {
#pragma unroll
      for (int n = 0; n < kKQ; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t + e;
          if (c < L.P3q)
            dkp[atk(L, f, j, h, L.P3q, c)] =
                -w * (cs * s.kp[kr * kP3qs + c] - pacc[n][2 * r + e]);
        }
    } else if (qt == 1) {
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
// ceil(Nq/32))
// ---------------------------------------------------------------------------
struct SmemC {
  Common c;
  float* qp;    // [2][kRows][kP3qs]: the (f, h)'s query points, and
  float* gopt;  // [2][kRows][kP3vs]: their cotangents, with the key tiles
  __host__ __device__ size_t carve(float* base, const Layout& L) {
    Carver cv(base);
    c.carve(cv, L);
    qp = cv.take((size_t)2 * kRows * kP3qs);
    gopt = cv.take((size_t)2 * kRows * kP3vs);
    return cv.n;
  }
};

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
ipa_bwd_pair_kernel(Inputs in, Layout L, int F, float* __restrict__ dbias,
                    float* __restrict__ dpz) {
  extern __shared__ float4 smem4[];
  SmemC s;
  s.carve(reinterpret_cast<float*>(smem4), L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = warp >> 2, qt = warp & 3;  // query tile, channel quarter
  const int j0 = blockIdx.x * kKeys, i0 = blockIdx.y * kRows;
  const int r0 = i0 + 16 * tile;
  const int col = qt * L.CQ;
  const int rr = qt & 1;  // quarters 2, 3: pair rows g + 8 rr
  const bool pair_warp = qt >= 2;
  const int n_it = F * L.H;  // (h, f), the frame fastest
  float* xch = s.c.xch + tile * kXchFloats;
  float* sksq = s.c.ksq + tile * kKeys;
  float* spz = s.c.pz + (16 * tile + 8 * rr) * kPZs;

  // the (f, h) of iteration `it`'s key tile and rows' points into buffer
  // it & 1, as one cp.async group (committed even when empty)
  auto fetch = [&](int it, bool any) {
    const int hh = it / F, ff = it - hh * F, b = it & 1;
    if (any) {
      fetch_rows(s.qp + b * kRows * kP3qs, kP3qs, kMaxP3q, in.qp, ff, hh, i0,
                 L.P3q, L);
      fetch_rows(s.gopt + b * kRows * kP3vs, kP3vs, kMaxP3v, in.gopt, ff, hh,
                 i0, L.P3v, L);
    }
    fetch_keys(s.c.tile(b, L), in.k, in.v, in.kp, in.vp, in.kmask, in.bias,
               ff, hh, i0, j0, any, L);
  };
  float qa[NT][4], goa[NT][4];  // this warp's quarter of q and g_o
  auto load_q = [&](float (&x)[NT][4], const float* src, int it) {
    const int hh = it / F, ff = it - hh * F;
#pragma unroll
    for (int ks = 0; ks < NT; ++ks)
      load_afrag(x[ks], src, L, L.Nq, ff, hh, r0, L.C, col + 8 * ks, L.C);
  };
  // the (f, h) of iteration it's row operands: g_pair of the pair rows
  // (channels t + 4 m) and of rows g, g + 8 (channels 8 qt + m), mask, lse, D
  float gp[kMaxDz / 4], gq[2][8], qm[2], lse[2], dvec[2];
  auto load_small = [&](int it) {
    const int h = it / F, f = it - h * F;
    if (pair_warp) {
      const int i = r0 + g + 8 * rr;
#pragma unroll
      for (int m = 0; m < kMaxDz / 4; ++m) {
        const int d = t + 4 * m;
        gp[m] = (i < L.Nq && d < L.Dz) ? in.gpair[atq(L, f, i, h, L.Dz, d)]
                                       : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + g + 8 * r;
      const bool ok = i < L.Nq;
      qm[r] = ok ? in.mask[(size_t)f * L.Nq + i] : 0.f;
      lse[r] = ok ? in.lse[((size_t)f * L.H + h) * L.Nq + i] : 0.f;
      dvec[r] = ok ? in.dvec[((size_t)f * L.H + h) * L.Nq + i] : 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int d = 8 * qt + m;
        gq[r][m] =
            (ok && d < L.Dz) ? in.gpair[atq(L, f, i, h, L.Dz, d)] : 0.f;
      }
    }
  };

  zero_padding(s.c, L);
  if (pair_warp) fetch_pz(spz, in.pz, r0 + 8 * rr, j0, L);  // once
  fetch(0, true);
  load_q(qa, in.q, 0);
  load_q(goa, in.go, 0);
  load_small(0);

  // dpz of this lane's 8 elements for pair channels 8 qt + m; dbias (over
  // the frames, quarter 0)
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
    cp_async_wait<0>();
    __syncthreads();
    fetch(it + 1, it + 1 < n_it);

    const float w = in.hw[h];
    const int b = it & 1;
    const bool more = it + 1 < n_it;
    // the next (f, h)'s q and g_o as soon as this one's are read
    tile_products<NT>(xch, sksq, qa, goa,
                      s.qp + b * kRows * kP3qs + 16 * tile * kP3qs,
                      s.gopt + b * kRows * kP3vs + 16 * tile * kP3vs, spz, gp,
                      kt, col, qt, [] {},
                      [&](int which) {
                        if (more) load_q(which ? goa : qa,
                                         which ? in.go : in.q, it + 1);
                      },
                      L);
    bar_sync(1 + tile, 128);

    float a[2][4], dl[2][4], dist[2][4];
    tile_a_dl(a, dl, dist, xch, kt, tile, qm, lse, dvec, w, r0, j0, L);
    if (qt == 0) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dba[n][e] += dl[n][e];
      if (f == F - 1) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = r0 + g + 8 * (e >> 1), j = j0 + 8 * n + 2 * t +
                                                     (e & 1);
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
      const int i = r0 + g + 8 * (e >> 1), j = j0 + 8 * n + 2 * t + (e & 1);
      if (i >= L.Nq || j >= L.Nk) continue;
      float* out = dpz + ((size_t)i * L.Nk + j) * L.Dz;
#pragma unroll
      for (int m = 0; m < 8; ++m)
        if (8 * qt + m < L.Dz) out[8 * qt + m] = dpa[n][e][m];
    }
}

template <typename Smem>
size_t smem_bytes(const Layout& L) {
  Smem s;
  return s.carve(nullptr, L) * sizeof(float);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Each launcher runs its kernel on `stream` and returns cudaGetLastError()
// (0 = the launch was accepted). Layouts are the JAX package's, with Nq
// query rows against Nk keys (Nq = Nk = N in the square call): q and g_o
// [F, Nq, H, C], k and v [F, Nk, H, C]; q_pts [F, Nq, H, Pq*3], k_pts
// [F, Nk, H, Pq*3]; v_pts [F, Nk, H, Pv*3], g_opt [F, Nq, H, Pv*3]; bias
// [Nq, Nk, H]; pair_z [Nq, Nk, Dz]; mask [F, Nq] (the query rows'),
// key_mask [F, Nk]; head_weights [H]; lse and D [F, H, Nq]; g_pair
// [F, Nq, H, Dz]. Outputs: A dq like q, dqp like q_pts, dhw_rows
// [F, H, Nq]; B dk, dv like k, dkp like k_pts, dvp like v_pts (sums over
// the Nq rows); C dbias [Nq, Nk, H], dpz [Nq, Nk, Dz]. All
// float32 and contiguous; the C-wide tensors 16-byte aligned; C divisible
// by 4 and at most 256, Pq*3 <= 32, Pv*3 <= 48, Dz <= 32.
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
// instance for C (NT 8 or 1) of `kern`, sets its shared memory (smem bytes
// of `Smem`) and selects the device.
#define IPA_BWD_PREPARE(kern, Smem)                                          \
  Inputs in{q,        k,            v,   q_pts, k_pts, v_pts, bias, pair_z, \
            mask,     key_mask,     head_weights,  lse,  dvec,  g_o,         \
            g_opt,    g_pair};                                               \
  if (F < 1 || F > 65535 ||                                                  \
      !layout_ok(Nq, Nk, H, C, 3 * Pq, 3 * Pv, Dz) ||                        \
      (Nq + kRows - 1) / kRows > 65535 || (Nk + kBKeys - 1) / kBKeys > 65535)\
    return (int)cudaErrorInvalidValue;                                       \
  const Layout L =                                                           \
      make_layout(Nq, Nk, H, C, 3 * Pq, 3 * Pv, Dz, c_qk, c_b, inf,          \
                  (reinterpret_cast<uintptr_t>(pair_z) & 15) == 0);          \
  const size_t smem = smem_bytes<Smem>(L);                                   \
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;            \
  int err = (int)cudaSetDevice(device);                                      \
  if (err) return err;                                                       \
  auto kernel = tiles_for(C) == kMaxNT ? kern<kMaxNT> : kern<1>;             \
  if ((err = set_smem(kernel, smem))) return err;

extern "C" int ipa_attention_bwd_dq(IPA_BWD_INPUTS, float* dq, float* dqp,
                                    float* dhw_rows, IPA_BWD_SHAPES) {
  IPA_BWD_PREPARE(ipa_bwd_dq_kernel, SmemA)
  const dim3 grid(H, F, (Nq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(in, L, dq, dqp, dhw_rows);
  return (int)cudaGetLastError();
}

extern "C" int ipa_attention_bwd_dkv(IPA_BWD_INPUTS, float* dk, float* dkp,
                                     float* dv, float* dvp, IPA_BWD_SHAPES) {
  IPA_BWD_PREPARE(ipa_bwd_dkv_kernel, SmemB)
  const dim3 grid(H, F, (Nk + kBKeys - 1) / kBKeys);
  kernel<<<grid, kThreads, smem, stream>>>(in, L, dk, dkp, dv, dvp);
  return (int)cudaGetLastError();
}

extern "C" int ipa_attention_bwd_pair(IPA_BWD_INPUTS, float* dbias, float* dpz,
                                      IPA_BWD_SHAPES) {
  IPA_BWD_PREPARE(ipa_bwd_pair_kernel, SmemC)
  const dim3 grid((Nk + kKeys - 1) / kKeys, (Nq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(in, L, F, dbias, dpz);
  return (int)cudaGetLastError();
}

// dynamic shared-memory bytes per block of kernel 0 (A), 1 (B) or 2 (C)
extern "C" long long ipa_attention_bwd_smem(int which, int C, int Pq, int Pv,
                                            int Dz) {
  const Layout L =
      make_layout(1, 1, 1, C, 3 * Pq, 3 * Pv, Dz, 0.f, 0.f, 0.f, true);
  switch (which) {
    case 0: return (long long)smem_bytes<SmemA>(L);
    case 1: return (long long)smem_bytes<SmemB>(L);
    case 2: return (long long)smem_bytes<SmemC>(L);
    default: return -1;
  }
}

extern "C" const char* ipa_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
