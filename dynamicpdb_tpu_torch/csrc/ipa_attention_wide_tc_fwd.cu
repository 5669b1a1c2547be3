// Invariant Point Attention forward, flash style, for sm_90a, on the TF32
// tensor cores, at the widths past ipa_attention_fwd.cu's limits (C > 256,
// Pq*3 > 32, Pv*3 > 48 or Dz > 32) up to C = 384, Pq*3 = 40, Pv*3 = 56,
// Dz = 64 (ipa_wide_tile.cuh); past those the CUDA-core kernel
// (ipa_attention_wide_fwd.cu) takes them.
//
// Replaces the Pallas TPU kernel dynamicpdb_tpu/ops/pallas/ipa_attention.py
// _ipa_attn_kernel (:39), which names no width limit, at model.ipa.c_z =
// 256 (Dz = 64), c_hidden = 384 (C = 384), no_qk_points = 12 (Pq*3 = 36),
// no_v_points = 18 (Pv*3 = 54). For every frame f, head h and query row i:
//
//   logit_ij = c_qk q_i.k_j + c_b bias_ijh
//              - 0.5 w_h (|qp_i|^2 + |kp_j|^2 - 2 qp_i.kp_j)
//              + inf (m_i m_j - 1)
//   a_ij     = softmax_j(logit_ij)            (online, never stored)
//   o_i      = sum_j a_ij v_j                 [C]
//   o_pt_i   = sum_j a_ij vp_j                [Pv*3]
//   o_pair_i = sum_j a_ij pz_ij               [Dz]   (pz shared by frames)
//   lse_i    = log sum_j exp(logit_ij)
//
// Masking copies the reference: a pad row (m_i = 0) takes a softmax over
// all keys with the additive term inf = 1e5, no key skipped; only keys past
// Nk (the ragged last step) are excluded. A call of Nq query rows against
// Nk keys takes a query mask and a key mask (sequence parallelism); the
// square call passes one mask twice. A row's outputs depend on its own
// operands and the keys alone, so a block of rows equals the square call's
// rows bit for bit.
//
// Bound on an H100 at wide-model (F=2, N=256, H=8, C=384, Pq=12, Pv=12,
// Dz=64; chip_smoke.ipa_cost, bounds): 1.91 GFLOP, 84% of it in q.k^T and
// p.v, against 47.5 MB of compulsory traffic (pair_z 16.8 MB, q, k, v, o
// 25.2 MB). Every operation on the CUDA cores: 0.0285 ms; the products on
// the TF32 tensor cores in three passes: 0.0117 ms of arithmetic, so the
// bytes bound it, 0.0142 ms at 3.35 TB/s.
//
// Passes. q.k^T, qp.kp^T, p.v and p.vp on the tensor cores (mma.sync
// m16n8k8, TF32 in, float32 accumulators) in three passes of operands split
// into a TF32 high and low part (tf32_mma.cuh split, mma3); one pass misses
// IPA_ATOL at these widths too (tests/test_torch_ipa_precision.py). The
// pair stream sum_j a_ij pz_ij, a different matrix per query row, runs on
// the CUDA cores in float32.
//
// Layout (ipa_wide_tile.cuh): one block of eight warps per (head, frame,
// 16 query rows), head fastest on the grid; warp w owns channels
// [w CQ, (w + 1) CQ): its slice of q as A fragments (24 registers at
// C = 384) and of o as accumulators (24). Per 16-key step each warp
// computes its slice of q.k^T, warp 0 also the point distances; the
// slices meet in the exchange (one block barrier), every warp then holds
// the same logits and probabilities, accumulates p.v over its channels,
// warp 1 p.vp, and warps 4-7 the pair stream (rows g + 8 (w & 1), pair
// channels 32 ((w >> 1) & 1) + t + 4 m), each fetching, reading and
// refetching its 8 rows x 16 keys x 32 channels of pair_z by cp.async.
// Key steps (k, v, points, key mask, bias) come by cp.async into the other
// of two buffers while the block computes. Shared memory at C = 384:
// 191,168 bytes (two key tiles 115,840, pair tiles 66,048, exchange
// 9,216), one block an SM; ptxas: 255 registers at C = 384 (252 at
// C <= 256), no spills. What this does about the CUDA-core kernel's limits:
//   1. every product on the CUDA cores in float32: q.k^T, p.v, qp.kp^T
//      and p.vp are mma tiles;
//   2. accumulators in shared memory: o, o_pt, o_pair, the running max and
//      sum in registers;
//   3. synchronous loads with three block barriers a 32-key tile: cp.async
//      into the other buffer, two barriers a 16-key step (the step's top
//      and the exchange);
//   4. pair_z read element by element from L2: 16-byte cp.async into
//      shared memory, a warp's rows in one group, the next step's fetched
//      as soon as this step's are read; the F H blocks of a row block run
//      together (head fastest) and share it in L2;
//   5. ipa_attention_fwd.cu's own limits (registers at C = 384, shared
//      memory at Dz = 64): eight channel slices on one 16-row tile
//      (ipa_wide_tile.cuh).
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "ipa_wide_tile.cuh"

namespace {

using namespace ipa_wtc;

struct SmemF {
  Common c;
  float* pz;  // [4 pair warps][8 rows][kPZh]
  __host__ __device__ size_t carve(float* base, const Layout& L) {
    Carver cv(base);
    c.carve(cv, L, kFwdSlots);
    pz = cv.take((size_t)4 * 8 * kPZh);
    return cv.n;
  }
};

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
ipa_wtc_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ qp,
                   const float* __restrict__ kp,
                   const float* __restrict__ vp,
                   const float* __restrict__ bias,
                   const float* __restrict__ pz,
                   const float* __restrict__ qmask,
                   const float* __restrict__ kmask,
                   const float* __restrict__ head_w, float* __restrict__ o,
                   float* __restrict__ o_pt, float* __restrict__ o_pair,
                   float* __restrict__ lse, Layout L) {
  extern __shared__ float4 smem4[];
  SmemF s;
  s.carve(reinterpret_cast<float*>(smem4), L);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, f = blockIdx.y, i0 = blockIdx.z * kRows;
  const int col = w * L.CQ;  // first channel of this warp
  const bool pair_warp = w >= 4;
  const int rr = w & 1, c0 = 32 * ((w >> 1) & 1);  // pair rows, channels
  const float hw = head_w[h];
  const int n_steps = (L.Nk + kKeys - 1) / kKeys;
  float* spz = s.pz + (w & 3) * 8 * kPZh;  // warps 4-7

  zero_padding(s.c, L);
  fetch_key_step(s.c.tile(0, L), k, v, kp, vp, kmask, bias, f, h, i0, 0,
                 true, L);
  if (pair_warp) fetch_pz(spz, pz, i0 + 8 * rr, 0, c0, L);

  float qa[NT][4];
#pragma unroll
  for (int ks = 0; ks < NT; ++ks)
    load_afrag(qa[ks], q, L, L.Nq, f, h, i0, L.C, col + 8 * ks, L.C);
  float qpa[kKQ][4], qsq[2];
  if (w == 0) {
#pragma unroll
    for (int ks = 0; ks < kKQ; ++ks)
      load_afrag(qpa[ks], qp, L, L.Nq, f, h, i0, L.P3q, 8 * ks, L.P3q);
    row_norms(qsq, qpa);
  }
  float qm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    qm[r] = i < L.Nq ? qmask[(size_t)f * L.Nq + i] : 0.f;
  }

  float o_acc[NT][4], opt[kNV][4], opair[8];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < kNV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) opt[n][e] = 0.f;
#pragma unroll
  for (int m = 0; m < 8; ++m) opair[m] = 0.f;
  float m_run[2] = {kNegInit, kNegInit}, l_run[2] = {0.f, 0.f};

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
    fetch_key_step(s.c.tile((step + 1) & 1, L), k, v, kp, vp, kmask, bias,
                   f, h, i0, j0 + kKeys, step + 1 < n_steps, L);

    if (w == 0) {
      float dist[2][4];
      key_norms(s.c.ksq, kt);
      __syncwarp();
      point_dist(dist, qpa, qsq, s.c.ksq, kt);
      xput(s.c.xch, kDist, dist);
    }
    float sc[2][4];
    qk_partial<NT>(
        sc,
        [&](int ks, float (&a)[4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qa[ks][e];
        },
        kt.k, col, L);
    xput(s.c.xch, kQK + w, sc);
    __syncthreads();  // the exchange

    // logits of rows g, g + 8 and keys 8 n + 2 t + {0, 1}, then the online
    // softmax; every warp computes the same values
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = tile_logit(s.c.xch, kt, n, e, qm, hw, L);
        sc[n][e] = j0 + 8 * n + 2 * t + (e & 1) < L.Nk ? l : -INFINITY;
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(fmaxf(sc[0][2 * r], sc[0][2 * r + 1]),
                       fmaxf(sc[1][2 * r], sc[1][2 * r + 1]));
      // finite: key j0 is real
      const float m_new = fmaxf(m_run[r], quad_max(mx));
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = expf(sc[n][e] - m_new);  // 0 past Nk
          sc[n][e] = p;
          l_run[r] += p;
        }
    }

    if (pair_warp) {
      // o_pair of row g + 8 rr, channels c0 + t + 4 m, += sum_j p_ij pz_ij;
      // each key's p comes from its quad by shuffle
      const float a_rr = rr ? alpha[1] : alpha[0];
#pragma unroll
      for (int m = 0; m < 8; ++m) opair[m] *= a_rr;
      cp_async_wait<1>();  // this step's pair_z (the next key tile may wait)
      __syncwarp();
      const float* z = spz + g * kPZh + t;  // zeros past Dz
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        const int n = jj >> 3, e = jj & 1;
        const float mine = rr ? sc[n][2 + e] : sc[n][e];
        const float pv = __shfl_sync(0xffffffffu, mine,
                                     (lane & ~3) | ((jj & 7) >> 1));
#pragma unroll
        for (int m = 0; m < 8; ++m)
          opair[m] = fmaf(pv, z[jj * 32 + 4 * m], opair[m]);
      }
      __syncwarp();  // every lane has read the rows
      if (step + 1 < n_steps)
        fetch_pz(spz, pz, i0 + 8 * rr, j0 + kKeys, c0, L);
    }

    // o += p . v over this warp's channels, 3xTF32
    uint32_t ph[2][4], pl[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) split_ctile(sc[ks], ph[ks], pl[ks]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[n][e] *= alpha[e >> 1];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t bh[2], bl[2];
        bfrag_cols(kt.v, L.Cs, ks, col + 8 * n, bh, bl);
        mma3(o_acc[n], ph[ks], pl[ks], bh, bl);
      }
    }
    if (w == 1) {
      // o_pt += p . vp, 3xTF32 (zeros past Pv*3)
#pragma unroll
      for (int n = 0; n < kNV; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) opt[n][e] *= alpha[e >> 1];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t bh[2], bl[2];
          bfrag_cols(kt.vp, kP3vs, ks, 8 * n, bh, bl);
          mma3(opt[n], ph[ks], pl[ks], bh, bl);
        }
      }
    }
  }

  // epilogue: normalise and store rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    const float inv = 1.f / l;
    const int i = i0 + g + 8 * r;
    if (i >= L.Nq) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = col + 8 * n + 2 * t;
      if (c < L.C)
        *reinterpret_cast<float2*>(o + atq(L, f, i, h, L.C, c)) =
            make_float2(o_acc[n][2 * r] * inv, o_acc[n][2 * r + 1] * inv);
    }
    if (w == 0 && t == 0)
      lse[((size_t)f * L.H + h) * L.Nq + i] = m_run[r] + logf(l);
    if (w == 1) {
#pragma unroll
      for (int n = 0; n < kNV; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t + e;
          if (c < L.P3v)
            o_pt[atq(L, f, i, h, L.P3v, c)] = opt[n][2 * r + e] * inv;
        }
    }
    if (pair_warp && r == rr) {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int d = c0 + t + 4 * m;
        if (d < L.Dz) o_pair[atq(L, f, i, h, L.Dz, d)] = opair[m] * inv;
      }
    }
  }
}

size_t smem_bytes(const Layout& L) {
  SmemF none;
  return none.carve(nullptr, L) * sizeof(float);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = the
// launch was accepted). Arguments and layouts as ipa_attention_fwd's
// (ipa_attention_fwd.cu): q [F, Nq, H, C], k, v [F, Nk, H, C], points
// [F, rows, H, P, 3], bias [Nq, Nk, H], pair_z [Nq, Nk, Dz], mask [F, Nq],
// key_mask [F, Nk], head_weights [H]; o, o_pt, o_pair, lse. All float32,
// contiguous; q, k, v and o 16-byte aligned; C divisible by 4 and at most
// 384, Pq*3 <= 40, Pv*3 <= 56, Dz <= 64.
extern "C" int ipa_attention_wide_tc_fwd(
    const float* q, const float* k, const float* v, const float* q_pts,
    const float* k_pts, const float* v_pts, const float* bias,
    const float* pair_z, const float* mask, const float* key_mask,
    const float* head_weights, float* o, float* o_pt, float* o_pair,
    float* lse, int F, int Nq, int Nk, int H, int C, int Pq, int Pv, int Dz,
    float c_qk, float c_b, float inf, int device, cudaStream_t stream) {
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
  auto kernel = tiles_for(C) == kMaxNT ? ipa_wtc_fwd_kernel<kMaxNT>
                                       : ipa_wtc_fwd_kernel<4>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, F, (Nq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, key_mask,
      head_weights, o, o_pt, o_pair, lse, L);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block (bytes) at these widths.
extern "C" long long ipa_attention_wide_tc_fwd_smem(int C, int Pq, int Pv,
                                                    int Dz) {
  return (long long)smem_bytes(make_layout(1, 1, 1, C, 3 * Pq, 3 * Pv, Dz,
                                           0.f, 0.f, 0.f, true));
}

extern "C" const char* ipa_attention_wide_tc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
