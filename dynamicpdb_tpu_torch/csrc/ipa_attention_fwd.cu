// Invariant Point Attention forward, flash style, for sm_90a, on the TF32
// tensor cores.
//
// Replaces the Pallas TPU kernel dynamicpdb_tpu/ops/pallas/ipa_attention.py
// _ipa_attn_kernel (:39). For every frame f, head h and query row i:
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
// Masking copies the reference exactly: a pad row (m_i = 0) still takes a
// softmax over all keys, with the additive term inf = 1e5 rather than -inf,
// and no key is skipped. Only keys past the end of the array (j >= N, the
// ragged last tile) are excluded.
//
// Bound on an H100 at the release shapes (F=2, N=256, H=8, C=256, Pq=8,
// Pv=12, Dz=32): 1.28 GFLOP, 84% of it in q.k^T and p.v, against ~30 MB of
// compulsory traffic. Every operation on the CUDA cores (67 TFLOP/s
// float32): 0.019 ms. The products on the TF32 tensor cores (495 TFLOP/s)
// in the three passes below: 0.007 ms of arithmetic, so the bytes bound it,
// 0.009 ms at 3.35 TB/s (chip_smoke.ipa_cost, bounds).
//
// Passes. Every product runs on the tensor cores (mma.sync m16n8k8, TF32 in,
// float32 accumulators) in three passes, lo.hi + hi.lo + hi.hi of operands
// split into a TF32 high and low part (tf32_mma.cuh split): q.k^T (q, k
// float32 inputs), qp.kp^T (24 wide), p.v and p.vp (36 wide; p is a float32
// result). One pass misses IPA_ATOL = 1e-4 by 14-32x on o, o_pt, o_pair;
// three passes with the tensor cores' truncating accumulation land at
// 3e-6 to 1.4e-5 (tests/test_torch_ipa_precision.py emulates both). The pair
// stream sum_j a_ij pz_ij is a different matrix per query row, no product
// within one (f, h); it runs on the CUDA cores in float32.
//
// Layout (ipa_tile.cuh): one block of eight warps per (head, frame, 32
// query rows), head fastest on the grid; each 16-row tile is owned by four
// warps that split its C channels in quarters. A warp keeps its quarter of
// q as A fragments (32 registers at C = 256) and of o as accumulators (32);
// the logits and the online softmax (quad shuffles) are computed by all
// four warps of a tile from the exchanged quarters of q.k^T, and the
// probabilities leave the score accumulators as p.v's A fragments. Quarter
// 0 adds the point distances (qp.kp^T) before the exchange, quarter 1 p.vp
// after it, quarters 2 and 3 the pair stream of rows g and g + 8. ptxas:
// 255 registers at C = 256 (205 at C <= 32), no spills; 172,800 bytes of
// shared memory, one block an SM. What this does about the CUDA-core
// version's limits:
//   1. no tensor cores: q.k^T, p.v and the point products run on them;
//   2. no overlap: every key step (k, v, points, mask, bias) comes by
//      cp.async into the other of two buffers while the block computes, one
//      block barrier a step; each pair warp's pair_z rows by cp.async, the
//      next step's fetched as soon as this step's are read;
//   3. strided bias reads: the head is the fastest grid axis, so the H
//      blocks of a query tile read the 32-byte sectors of the [N, N, H] bias
//      together, one DRAM read each, the other heads' floats from L2;
//   4. pair_z re-read per block: the F H blocks of a query tile run
//      together and share each pair_z tile in L2 (one DRAM read per call);
//      a block reads its rows' tile once, 16-byte copies at Dz = 32;
//   5. small tiles: 8 warps on 32 rows, two on each scheduler, 128 blocks
//      at the release shapes.
// Every loop runs to a compile-time bound (no branch in the tile code):
// channels past C, point columns past Pq*3 and Pv*3, pair channels past Dz
// are zeros, keys past N get -inf. C % 4 == 0 up to 256, Pq*3 <= 32,
// Pv*3 <= 48, Dz <= 32 and every N run. The alternatives measured are in
// PERF.md §6: four warps of half the channels, q in shared memory, a
// third key-tile buffer, loop bounds known only at run time.
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "ipa_tile.cuh"

namespace {

using namespace ipa_tc;

__host__ __device__ size_t carve_fwd(Common& c, float* base,
                                     const Layout& L) {
  Carver cv(base);
  c.carve(cv, L);
  return cv.n;
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
ipa_attn_fwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ qp,
                         const float* __restrict__ kp,
                         const float* __restrict__ vp,
                         const float* __restrict__ bias,
                         const float* __restrict__ pz,
                         const float* __restrict__ mask,
                         const float* __restrict__ head_w,
                         float* __restrict__ o, float* __restrict__ o_pt,
                         float* __restrict__ o_pair, float* __restrict__ lse,
                         Layout L) {
  extern __shared__ float4 smem4[];
  Common s;
  carve_fwd(s, reinterpret_cast<float*>(smem4), L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = warp >> 2, qt = warp & 3;  // query tile, channel quarter
  const int h = blockIdx.x, f = blockIdx.y, i0 = blockIdx.z * kRows;
  const int r0 = i0 + 16 * tile;  // first query row of this warp's tile
  const int col = qt * L.CQ;      // first channel of this warp
  const int rr = qt & 1;          // quarters 2, 3: pair rows g + 8 rr
  const bool pair_warp = qt >= 2;
  const float w = head_w[h];
  const int n_steps = (L.N + kKeys - 1) / kKeys;
  float* xch = s.xch + tile * kXchFloats;
  float* sksq = s.ksq + tile * kKeys;
  float* spz = s.pz + (16 * tile + 8 * rr) * kPZs;  // quarters 2, 3

  zero_padding(s, L);
  fetch_keys(s.tile(0, L), k, v, kp, vp, mask, bias, f, h, i0, 0, true, L);
  if (pair_warp) fetch_pz(spz, pz, r0 + 8 * rr, 0, L);

  // this warp's q channels as A fragments, the query points, the masks
  float qa[NT][4];
#pragma unroll
  for (int ks = 0; ks < NT; ++ks)
    load_afrag(qa[ks], q, L, f, h, r0, L.C, col + 8 * ks, L.C);
  float qpa[kKQ][4], qsq[2];
  if (qt == 0) {
#pragma unroll
    for (int ks = 0; ks < kKQ; ++ks)
      load_afrag(qpa[ks], qp, L, f, h, r0, L.P3q, 8 * ks, L.P3q);
    row_norms(qsq, qpa);
  }
  float qm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g + 8 * r;
    qm[r] = i < L.N ? mask[(size_t)f * L.N + i] : 0.f;
  }

  float o_acc[NT][4], opt[kNV][4], opair[kMaxDz / 4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < kNV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) opt[n][e] = 0.f;
#pragma unroll
  for (int m = 0; m < kMaxDz / 4; ++m) opair[m] = 0.f;
  float m_run[2] = {kNegInit, kNegInit}, l_run[2] = {0.f, 0.f};

  for (int step = 0; step < n_steps; ++step) {
    const int j0 = step * kKeys;
    const KeyTile kt = s.tile(step & 1, L);
    // this step's key tile has landed (quarters 2, 3 may still wait for
    // pair_z), and every warp is done with the last step and so with the
    // other buffer, which now takes the next step's tile
    if (pair_warp)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    fetch_keys(s.tile((step + 1) & 1, L), k, v, kp, vp, mask, bias, f, h, i0,
               j0 + kKeys, step + 1 < n_steps, L);

    // each warp's share of the logits' products into the exchange
    if (qt == 0) {
      float dist[2][4];
      key_norms(sksq, kt, L);
      __syncwarp();
      point_dist(dist, qpa, qsq, sksq, kt, L);
      xput(xch, kDist, dist);
    }
    float sc[2][4];
    qk_partial<NT>(
        sc,
        [&](int ks, float (&a)[4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qa[ks][e];
        },
        kt.k, col, L);
    xput(xch, kQK + qt, sc);
    bar_sync(1 + tile, 128);

    // logits of rows g, g + 8 and keys 8 n + 2 t + {0, 1}, then the online
    // softmax; the four warps of the tile read the same operands from the
    // exchange and compute the same values
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = 8 * n + 2 * t + (e & 1);
        const float l = ipa_logit(
            xsum4(xch, kQK, n, e), kt.bias[(16 * tile + g + 8 * r) * kBS + c],
            xval(xch, kDist, n, e), qm[r], kt.km[c], w, L);
        sc[n][e] = j0 + c < L.N ? l : -INFINITY;
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
          const float p = expf(sc[n][e] - m_new);  // 0 past N
          sc[n][e] = p;
          l_run[r] += p;
        }
    }

    if (pair_warp) {
      // o_pair of row g + 8 rr += sum_j p_ij pz_ij: lane (g, t) owns pair
      // channels t + 4 m; each key's p comes from its quad by shuffle. The
      // tile is read first in the step, so that its refetch has the rest.
      const float a_rr = rr ? alpha[1] : alpha[0];
#pragma unroll
      for (int m = 0; m < kMaxDz / 4; ++m) opair[m] *= a_rr;
      cp_async_wait<1>();  // this step's pair_z rows (the key tile may wait)
      __syncwarp();
      const float* z = spz + g * kPZs + t;  // zeros past Dz
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        const int n = jj >> 3, e = jj & 1;
        const float mine = rr ? sc[n][2 + e] : sc[n][e];
        const float pv = __shfl_sync(0xffffffffu, mine,
                                     (lane & ~3) | ((jj & 7) >> 1));
#pragma unroll
        for (int m = 0; m < kMaxDz / 4; ++m)
          opair[m] = fmaf(pv, z[jj * kMaxDz + 4 * m], opair[m]);
      }
      __syncwarp();  // every lane has read the rows
      if (step + 1 < n_steps) fetch_pz(spz, pz, r0 + 8 * rr, j0 + kKeys, L);
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
    if (qt == 1) {
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
    const int i = r0 + g + 8 * r;
    if (i >= L.N) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = col + 8 * n + 2 * t;
      if (c < L.C)
        *reinterpret_cast<float2*>(o + at(L, f, i, h, L.C, c)) =
            make_float2(o_acc[n][2 * r] * inv, o_acc[n][2 * r + 1] * inv);
    }
    if (qt == 0 && t == 0)
      lse[((size_t)f * L.H + h) * L.N + i] = m_run[r] + logf(l);
    if (qt == 1) {
#pragma unroll
      for (int n = 0; n < kNV; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t + e;
          if (c < L.P3v)
            o_pt[at(L, f, i, h, L.P3v, c)] = opt[n][2 * r + e] * inv;
        }
    }
    if (pair_warp && r == rr) {
#pragma unroll
      for (int m = 0; m < kMaxDz / 4; ++m) {
        const int d = t + 4 * m;
        if (d < L.Dz) o_pair[at(L, f, i, h, L.Dz, d)] = opair[m] * inv;
      }
    }
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = the
// launch was accepted). Layouts are the JAX package's: q, k, v [F, N, H, C];
// q_pts, k_pts [F, N, H, Pq, 3]; v_pts [F, N, H, Pv, 3]; bias [N, N, H];
// pair_z [N, N, Dz]; mask [F, N]; head_weights [H]; outputs o [F, N, H, C],
// o_pt [F, N, H, Pv, 3], o_pair [F, N, H, Dz], lse [F, H, N]. All float32,
// contiguous; q, k, v and o 16-byte aligned; C divisible by 4 and at most
// 256, Pq*3 <= 32, Pv*3 <= 48, Dz <= 32.
extern "C" int ipa_attention_fwd(
    const float* q, const float* k, const float* v, const float* q_pts,
    const float* k_pts, const float* v_pts, const float* bias,
    const float* pair_z, const float* mask, const float* head_weights,
    float* o, float* o_pt, float* o_pair, float* lse, int F, int N, int H,
    int C, int Pq, int Pv, int Dz, float c_qk, float c_b, float inf,
    int device, cudaStream_t stream) {
  if (F < 1 || F > 65535 || !layout_ok(N, H, C, 3 * Pq, 3 * Pv, Dz) ||
      (N + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const Layout L =
      make_layout(N, H, C, 3 * Pq, 3 * Pv, Dz, c_qk, c_b, inf,
                  (reinterpret_cast<uintptr_t>(pair_z) & 15) == 0);
  Common none;
  const size_t smem = carve_fwd(none, nullptr, L) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto kernel = tiles_for(C) == kMaxNT ? ipa_attn_fwd_kernel<kMaxNT>
                                       : ipa_attn_fwd_kernel<1>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, F, (N + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, head_weights, o, o_pt,
      o_pair, lse, L);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block (bytes) at these widths.
extern "C" long long ipa_attention_fwd_smem(int C, int Pq, int Pv, int Dz) {
  const Layout L = make_layout(1, 1, C, 3 * Pq, 3 * Pv, Dz, 0.f, 0.f, 0.f,
                               true);
  Common none;
  return (long long)(carve_fwd(none, nullptr, L) * sizeof(float));
}

extern "C" const char* ipa_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
