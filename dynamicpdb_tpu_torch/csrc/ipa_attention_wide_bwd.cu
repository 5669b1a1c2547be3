// Invariant Point Attention backward on the CUDA cores, for sm_90a: the
// wide route, for the widths past both tensor-core routes' limits
// (ipa_attention_bwd.cu: C <= 256, Pq*3 <= 32, Pv*3 <= 48, Dz <= 32;
// ipa_attention_wide_tc_bwd.cu: C <= 384, Pq*3 <= 40, Pv*3 <= 56,
// Dz <= 64, which takes the widths between).
//
// Replaces the three Pallas TPU kernels of
// dynamicpdb_tpu/ops/pallas/ipa_attention.py that the custom VJP
// (_ipa_attention_bwd :563) launches through _fused_ipa_backward (:369),
// which name no width limit, wherever the tensor-core kernels cannot take
// the widths:
//
//   kernel A  ipa_wide_bwd_dq_kernel    <- _bwd_dq_kernel   (:259)
//   kernel B  ipa_wide_bwd_dkv_kernel   <- _bwd_dkv_kernel  (:297)
//   kernel C  ipa_wide_bwd_pair_kernel  <- _bwd_pair_kernel (:338)
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
// The logit is built in the same order of operations as the CUDA-core
// wide forward (ipa_attention_wide_fwd.cu), which is the forward at every
// width these kernels take, so a_ij agrees with its softmax to the last
// bit the two compilations allow.
//
// Bound on an H100 (2 FLOP per multiply-add): the tile recompute costs
// about 4 C + 2 Pq*3 + 2 Pv*3 + 2 Dz + 14 FLOP per (f, h, i, j) element;
// A adds about 2 C + 2 Pq*3, B about 4 C + 2 Pq*3 + 2 Pv*3, C about 2 Dz
// (chip_smoke.ipa_bwd_cost). Every operation runs on the CUDA cores
// (67 TFLOP/s float32), so arithmetic bounds all three.
//
// Design (CUDA cores, accumulators in shared memory, any width up to what
// a block's 227 KB holds: ipa_attention_wide_bwd_smem gives the bytes,
// ipa_wide_smem.cuh the limit). On the TPU the last grid
// axis runs in order and the kernels accumulate in scratch across it. Here
// that axis becomes a loop inside one block, so every output element is
// written by exactly one block: no atomics, and the result is the same
// from run to run.
//   * Every kernel works on 16 x 16 element tiles with one thread per
//     (query row, key) element: 256 threads. The 16 query rows (q, g_o,
//     their points, g_pair, lse, D) and the 16 key rows (k, v, their
//     points) are staged in shared memory, rows padded to C+4 floats so the
//     float4 reads of a quarter warp fall on distinct banks.
//   * A: one block per (16 query rows, head, frame), looping over key
//     tiles; dq accumulates in shared memory, the row sums in registers.
//   * B: one block per (16 keys, head, frame), looping over query tiles;
//     dk, dv and the point sums accumulate in shared memory.
//   * C: one block per (16 query rows, 16 keys), looping over heads and,
//     inside, frames; each element reads its pair_z row from global memory
//     (L2), dpz accumulates in shared memory per element, dbias in a
//     register per head.
//   * Rows and keys past N (the ragged last tile) are loaded as zeros and
//     their elements forced to a = dl = 0, so N need not divide the tile.
//     Pad rows (mask 0) are computed exactly as the reference does.
//   * A call may take Nq query rows against Nk keys, with a query mask and
//     a key mask (sequence parallelism: one rank's rows against every key):
//     the query side has Nq rows, the key side Nk, bias and pair_z
//     [Nq, Nk, .]; B's dk/dv are the sums over the call's rows. The square
//     call passes Nq = Nk = N and one mask twice.
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "ipa_wide_smem.cuh"

namespace {

constexpr int kTile = 16;                  // query rows and keys per tile
constexpr int kThreads = kTile * kTile;    // one thread per element
constexpr int kWide = 4;                   // rows per work item of the C-wide sums

static_assert(kTile == 16, "row reductions use 16-lane shuffles");

__host__ __device__ inline int padded_c(int C) { return C + 4; }
__host__ __device__ inline int padded_odd(int p) { return p | 1; }

struct Dims {
  int F, Nq, Nk, H, C, Cs, P3q, P3qs, P3v, P3vs, Dz, Dzs;
  float c_qk, c_b, inf;
};

// Bump allocator over dynamic shared memory. With a null base it only
// counts, so the host sizes a launch with the same code the kernel carves
// with. Every buffer starts on a 16-byte boundary.
struct Carver {
  float* base;
  size_t n = 0;
  __host__ __device__ explicit Carver(float* b) : base(b) {}
  __host__ __device__ float* take(size_t count) {
    float* p = base ? base + n : nullptr;
    n += (count + 3) & ~size_t(3);
    return p;
  }
};

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
  const float *q, *k, *v, *qp, *kp, *vp, *bias, *pz, *mask, *kmask, *hw,
      *lse, *dvec, *go, *gopt, *gpair;
};

// element (f, n, h, x) of a [F, rows, H, D] tensor: rows = Nq on the query
// side (q, g_o, their points, g_pair, the outputs), Nk on the key side
__device__ inline size_t at(int rows, const Dims& d, int f, int n, int h,
                            int D, int x) {
  return (((size_t)f * rows + n) * d.H + h) * D + x;
}

// rows n0..n0+15 of a [F, rows, H, D] tensor at (f, h) into dst[r * ds + x],
// zeros past `rows`; float4 copies (D divisible by 4, 16-byte aligned rows)
__device__ void load_rows4(float* dst, int ds, const float* src, int rows,
                           const Dims& d, int f, int h, int n0, int D) {
  const int D4 = D / 4;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = threadIdx.x; e < kTile * D4; e += kThreads) {
    const int r = e / D4, x4 = e % D4, n = n0 + r;
    reinterpret_cast<float4*>(dst + r * ds)[x4] =
        n < rows ? reinterpret_cast<const float4*>(
                       src + at(rows, d, f, n, h, D, 0))[x4]
                 : zero4;
  }
}

__device__ void load_rows(float* dst, int ds, const float* src, int rows,
                          const Dims& d, int f, int h, int n0, int D) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, x = e % D, n = n0 + r;
    dst[r * ds + x] = n < rows ? src[at(rows, d, f, n, h, D, x)] : 0.f;
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
  load_rows4(t.q, d.Cs, in.q, d.Nq, d, f, h, i0, d.C);
  load_rows4(t.go, d.Cs, in.go, d.Nq, d, f, h, i0, d.C);
  load_rows(t.qp, d.P3qs, in.qp, d.Nq, d, f, h, i0, d.P3q);
  load_rows(t.gopt, d.P3vs, in.gopt, d.Nq, d, f, h, i0, d.P3v);
  load_rows(t.gpair, d.Dzs, in.gpair, d.Nq, d, f, h, i0, d.Dz);
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x, i = i0 + r;
    const bool ok = i < d.Nq;
    t.qm[r] = ok ? in.mask[(size_t)f * d.Nq + i] : 0.f;
    t.lse[r] = ok ? in.lse[((size_t)f * d.H + h) * d.Nq + i] : 0.f;
    t.dvec[r] = ok ? in.dvec[((size_t)f * d.H + h) * d.Nq + i] : 0.f;
  }
}

__device__ void load_key_tile(KeyTile& t, const Inputs& in, const Dims& d,
                              int f, int h, int j0) {
  load_rows4(t.k, d.Cs, in.k, d.Nk, d, f, h, j0, d.C);
  load_rows4(t.v, d.Cs, in.v, d.Nk, d, f, h, j0, d.C);
  load_rows(t.kp, d.P3qs, in.kp, d.Nk, d, f, h, j0, d.P3q);
  load_rows(t.vp, d.P3vs, in.vp, d.Nk, d, f, h, j0, d.P3v);
  if (threadIdx.x < kTile) {
    const int j = j0 + threadIdx.x;
    t.km[threadIdx.x] = j < d.Nk ? in.kmask[(size_t)f * d.Nk + j] : 0.f;
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
// kernel A: dq, dqp, dhw rows. grid (ceil(Nq/16), H, F)
// ---------------------------------------------------------------------------
struct SmemA {
  RowTile rt;
  KeyTile kt;
  float *dl;     // [16][17]
  float *dq;     // [16][C]
  float *dlkp;   // [16][P3q]
  float *rowsum; // [16]
  __host__ __device__ size_t carve(float* base, const Dims& d) {
    Carver c(base);
    rt.carve(c, d);
    kt.carve(c, d);
    dl = c.take(kTile * (kTile + 1));
    dq = c.take(kTile * d.C);
    dlkp = c.take(kTile * d.P3q);
    rowsum = c.take(kTile);
    return c.n;
  }
};

__global__ void __launch_bounds__(kThreads)
ipa_wide_bwd_dq_kernel(Inputs in, Dims d, float* __restrict__ dq,
                  float* __restrict__ dqp, float* __restrict__ dhw_rows) {
  extern __shared__ float4 smem4[];
  SmemA s;
  s.carve(reinterpret_cast<float*>(smem4), d);
  const int i0 = blockIdx.x * kTile, h = blockIdx.y, f = blockIdx.z;
  const int tid = threadIdx.x;
  const float w = in.hw[h];
  const int C4 = d.C / 4;

  load_row_tile(s.rt, in, d, f, h, i0);
  for (int e = tid; e < kTile * d.C; e += kThreads) s.dq[e] = 0.f;
  for (int e = tid; e < kTile * d.P3q; e += kThreads) s.dlkp[e] = 0.f;
  __syncthreads();
  tile_norms(&s.rt, nullptr, d);

  const int r = tid / kTile, jr = tid % kTile, i = i0 + r;
  float rowsum = 0.f, dhw = 0.f;
  for (int j0 = 0; j0 < d.Nk; j0 += kTile) {
    load_key_tile(s.kt, in, d, f, h, j0);
    __syncthreads();
    tile_norms(nullptr, &s.kt, d);
    __syncthreads();
    const int j = j0 + jr;
    const bool valid = i < d.Nq && j < d.Nk;
    const size_t ij = valid ? (size_t)i * d.Nk + j : 0;
    const Elem e = element(s.rt, s.kt, r, jr, valid,
                           valid ? in.bias[ij * d.H + h] : 0.f,
                           in.pz + ij * d.Dz, w, d);
    rowsum += e.dl;
    dhw += -0.5f * e.dist * e.dl;
    s.dl[r * (kTile + 1) + jr] = e.dl;
    __syncthreads();
    // dq += dl . k: a work item is 4 rows x 4 channels
    for (int it = tid; it < (kTile / kWide) * C4; it += kThreads) {
      const int rg = it / C4, c4 = it % C4;
      float4 acc[kWide];
#pragma unroll
      for (int rr = 0; rr < kWide; ++rr)
        acc[rr] = reinterpret_cast<const float4*>(s.dq + (rg * kWide + rr) * d.C)[c4];
      for (int jj = 0; jj < kTile; ++jj) {
        const float4 kk = reinterpret_cast<const float4*>(s.kt.k + jj * d.Cs)[c4];
#pragma unroll
        for (int rr = 0; rr < kWide; ++rr) {
          const float p = s.dl[(rg * kWide + rr) * (kTile + 1) + jj];
          acc[rr].x = fmaf(p, kk.x, acc[rr].x);
          acc[rr].y = fmaf(p, kk.y, acc[rr].y);
          acc[rr].z = fmaf(p, kk.z, acc[rr].z);
          acc[rr].w = fmaf(p, kk.w, acc[rr].w);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kWide; ++rr)
        reinterpret_cast<float4*>(s.dq + (rg * kWide + rr) * d.C)[c4] = acc[rr];
    }
    for (int it = tid; it < kTile * d.P3q; it += kThreads) {
      const int rr = it / d.P3q, x = it % d.P3q;
      float acc = s.dlkp[it];
      for (int jj = 0; jj < kTile; ++jj)
        acc = fmaf(s.dl[rr * (kTile + 1) + jj], s.kt.kp[jj * d.P3qs + x], acc);
      s.dlkp[it] = acc;
    }
    __syncthreads();  // the key tile and dl are rewritten by the next tile
  }
  rowsum = sum16(rowsum);
  dhw = sum16(dhw);
  if (jr == 0) {
    s.rowsum[r] = rowsum;
    if (i < d.Nq) dhw_rows[((size_t)f * d.H + h) * d.Nq + i] = dhw;
  }
  __syncthreads();
  for (int e = tid; e < kTile * C4; e += kThreads) {
    const int rr = e / C4, c4 = e % C4, ii = i0 + rr;
    if (ii < d.Nq) {
      const float4 a = reinterpret_cast<const float4*>(s.dq + rr * d.C)[c4];
      reinterpret_cast<float4*>(dq + at(d.Nq, d, f, ii, h, d.C, 0))[c4] =
          make_float4(d.c_qk * a.x, d.c_qk * a.y, d.c_qk * a.z, d.c_qk * a.w);
    }
  }
  for (int e = tid; e < kTile * d.P3q; e += kThreads) {
    const int rr = e / d.P3q, x = e % d.P3q, ii = i0 + rr;
    if (ii < d.Nq)
      dqp[at(d.Nq, d, f, ii, h, d.P3q, x)] =
          -w * (s.rowsum[rr] * s.rt.qp[rr * d.P3qs + x] - s.dlkp[e]);
  }
}

// ---------------------------------------------------------------------------
// kernel B: dk, dkp, dv, dvp. grid (ceil(Nk/16), H, F)
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
ipa_wide_bwd_dkv_kernel(Inputs in, Dims d, float* __restrict__ dk,
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
  for (int i0 = 0; i0 < d.Nq; i0 += kTile) {
    load_row_tile(s.rt, in, d, f, h, i0);
    __syncthreads();
    tile_norms(&s.rt, nullptr, d);
    __syncthreads();
    const int i = i0 + r;
    const bool valid = i < d.Nq && j < d.Nk;
    const size_t ij = valid ? (size_t)i * d.Nk + j : 0;
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
    if (jj < d.Nk) {
      const float4 a = reinterpret_cast<const float4*>(s.dk + kk * d.C)[c4];
      reinterpret_cast<float4*>(dk + at(d.Nk, d, f, jj, h, d.C, 0))[c4] =
          make_float4(d.c_qk * a.x, d.c_qk * a.y, d.c_qk * a.z, d.c_qk * a.w);
      reinterpret_cast<float4*>(dv + at(d.Nk, d, f, jj, h, d.C, 0))[c4] =
          reinterpret_cast<const float4*>(s.dv + kk * d.C)[c4];
    }
  }
  for (int e = tid; e < kTile * d.P3q; e += kThreads) {
    const int kk = e / d.P3q, x = e % d.P3q, jj = j0 + kk;
    if (jj < d.Nk)
      dkp[at(d.Nk, d, f, jj, h, d.P3q, x)] =
          -w * (s.colsum[kk] * s.kt.kp[kk * d.P3qs + x] - s.dlqp[e]);
  }
  for (int e = tid; e < kTile * d.P3v; e += kThreads) {
    const int kk = e / d.P3v, x = e % d.P3v, jj = j0 + kk;
    if (jj < d.Nk) dvp[at(d.Nk, d, f, jj, h, d.P3v, x)] = s.dvp[e];
  }
}

// ---------------------------------------------------------------------------
// kernel C: dbias [Nq, Nk, H], dpz [Nq, Nk, Dz]. grid (ceil(Nk/16),
// ceil(Nq/16))
// ---------------------------------------------------------------------------
struct SmemC {
  RowTile rt;
  KeyTile kt;
  float *dpz;   // [256 elements][Dzs]
  __host__ __device__ size_t carve(float* base, const Dims& d) {
    Carver c(base);
    rt.carve(c, d);
    kt.carve(c, d);
    dpz = c.take((size_t)kThreads * d.Dzs);
    return c.n;
  }
};

__global__ void __launch_bounds__(kThreads)
ipa_wide_bwd_pair_kernel(Inputs in, Dims d, float* __restrict__ dbias,
                         float* __restrict__ dpz) {
  extern __shared__ float4 smem4[];
  SmemC s;
  s.carve(reinterpret_cast<float*>(smem4), d);
  const int j0 = blockIdx.x * kTile, i0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const int r = tid / kTile, jr = tid % kTile, i = i0 + r, j = j0 + jr;
  const bool valid = i < d.Nq && j < d.Nk;
  const size_t ij = valid ? (size_t)i * d.Nk + j : 0;

  // each element reads its own pair_z row from global memory (L2 after the
  // first (h, f)): staging the tile's 256 rows too would leave no room for
  // C = 384 beside Dz = 64
  for (int x = 0; x < d.Dz; ++x) s.dpz[tid * d.Dzs + x] = 0.f;
  float* my_dpz = s.dpz + tid * d.Dzs;
  const float* my_pz = in.pz + ij * d.Dz;

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
    if (ii < d.Nq && jj < d.Nk)
      dpz[((size_t)ii * d.Nk + jj) * d.Dz + x] =
          s.dpz[(rr * kTile + kk) * d.Dzs + x];
  }
}

template <typename Smem>
size_t smem_bytes(const Dims& d) {
  Smem s;
  return s.carve(nullptr, d) * sizeof(float);
}

int prepare(const Dims& d, int device) {
  if (d.F < 1 || d.Nq < 1 || d.Nk < 1 || d.H < 1 || d.C < 4 || d.C % 4 != 0 || d.P3q < 3 ||
      d.P3v < 3 || d.Dz < 1 || d.H > 65535 || d.F > 65535 ||
      (d.Nq + kTile - 1) / kTile > 65535 ||
      (d.Nk + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSetDevice(device);
}

Dims make_dims(int F, int Nq, int Nk, int H, int C, int Pq, int Pv, int Dz,
               float c_qk, float c_b, float inf) {
  Dims d;
  d.F = F, d.Nq = Nq, d.Nk = Nk, d.H = H, d.C = C, d.Cs = padded_c(C);
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
// (0 = the launch was accepted). Layouts are the JAX package's, with Nq
// query rows against Nk keys (Nq = Nk = N in the square call): q and g_o
// [F, Nq, H, C], k and v [F, Nk, H, C]; q_pts [F, Nq, H, Pq*3], k_pts
// [F, Nk, H, Pq*3]; v_pts [F, Nk, H, Pv*3], g_opt [F, Nq, H, Pv*3]; bias
// [Nq, Nk, H]; pair_z [Nq, Nk, Dz]; mask [F, Nq] (the query rows'),
// key_mask [F, Nk]; head_weights [H]; lse and D [F, H, Nq]; g_pair
// [F, Nq, H, Dz]. Outputs: A dq like q, dqp like q_pts, dhw_rows
// [F, H, Nq]; B dk, dv like k, dkp like k_pts, dvp like v_pts (sums over
// the Nq rows); C dbias [Nq, Nk, H], dpz [Nq, Nk, Dz]. All
// float32 and contiguous; the C-wide tensors 16-byte aligned, C divisible
// by 4, and the widths within one block's shared memory
// (ipa_attention_wide_bwd_smem).
#define IPA_BWD_INPUTS                                                       \
  const float *q, const float *k, const float *v, const float *q_pts,        \
      const float *k_pts, const float *v_pts, const float *bias,             \
      const float *pair_z, const float *mask, const float *key_mask,         \
      const float *head_weights, const float *lse, const float *dvec,        \
      const float *g_o, const float *g_opt, const float *g_pair
#define IPA_BWD_SHAPES                                                       \
  int F, int Nq, int Nk, int H, int C, int Pq, int Pv, int Dz, float c_qk,  \
      float c_b, float inf, int device, cudaStream_t stream
#define IPA_BWD_PACK                                                         \
  Inputs in{q,        k,            v,   q_pts, k_pts, v_pts, bias, pair_z, \
            mask,     key_mask,     head_weights,  lse,  dvec,  g_o,         \
            g_opt,    g_pair};                                               \
  const Dims d = make_dims(F, Nq, Nk, H, C, Pq, Pv, Dz, c_qk, c_b, inf);     \
  int err = prepare(d, device);                                              \
  if (err) return err;

extern "C" int ipa_attention_wide_bwd_dq(IPA_BWD_INPUTS, float* dq,
                                         float* dqp, float* dhw_rows,
                                         IPA_BWD_SHAPES) {
  IPA_BWD_PACK
  const size_t smem = smem_bytes<SmemA>(d);
  if (smem > ipa_wide::kMaxSmem) return (int)cudaErrorInvalidValue;
  if ((err = set_smem(ipa_wide_bwd_dq_kernel, smem))) return err;
  const dim3 grid((Nq + kTile - 1) / kTile, H, F);
  ipa_wide_bwd_dq_kernel<<<grid, kThreads, smem, stream>>>(in, d, dq, dqp, dhw_rows);
  return (int)cudaGetLastError();
}

extern "C" int ipa_attention_wide_bwd_dkv(IPA_BWD_INPUTS, float* dk,
                                          float* dkp, float* dv, float* dvp,
                                          IPA_BWD_SHAPES) {
  IPA_BWD_PACK
  const size_t smem = smem_bytes<SmemB>(d);
  if (smem > ipa_wide::kMaxSmem) return (int)cudaErrorInvalidValue;
  if ((err = set_smem(ipa_wide_bwd_dkv_kernel, smem))) return err;
  const dim3 grid((Nk + kTile - 1) / kTile, H, F);
  ipa_wide_bwd_dkv_kernel<<<grid, kThreads, smem, stream>>>(in, d, dk, dkp, dv, dvp);
  return (int)cudaGetLastError();
}

extern "C" int ipa_attention_wide_bwd_pair(IPA_BWD_INPUTS, float* dbias,
                                           float* dpz, IPA_BWD_SHAPES) {
  IPA_BWD_PACK
  const size_t smem = smem_bytes<SmemC>(d);
  if (smem > ipa_wide::kMaxSmem) return (int)cudaErrorInvalidValue;
  if ((err = set_smem(ipa_wide_bwd_pair_kernel, smem))) return err;
  const dim3 grid((Nk + kTile - 1) / kTile, (Nq + kTile - 1) / kTile);
  ipa_wide_bwd_pair_kernel<<<grid, kThreads, smem, stream>>>(in, d, dbias, dpz);
  return (int)cudaGetLastError();
}

// dynamic shared-memory bytes per block of kernel 0 (A), 1 (B) or 2 (C)
extern "C" long long ipa_attention_wide_bwd_smem(int which, int C, int Pq,
                                                 int Pv, int Dz) {
  const Dims d = make_dims(1, 1, 1, 1, C, Pq, Pv, Dz, 0.f, 0.f, 0.f);
  switch (which) {
    case 0: return (long long)smem_bytes<SmemA>(d);
    case 1: return (long long)smem_bytes<SmemB>(d);
    case 2: return (long long)smem_bytes<SmemC>(d);
    default: return -1;
  }
}

extern "C" const char* ipa_attention_wide_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
