// Invariant Point Attention forward, flash style, for sm_90a.
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
// Bound on an H100: about 1.2 kFLOP per (f, h, i, j), 1.28 GFLOP at the
// release shapes (F=2, N=256, H=8, C=256, Pq=8, Pv=12, Dz=32), against
// about 30 MB of compulsory traffic: float32 arithmetic bounds it (~19 us
// at 67 TFLOP/s outside the tensor cores, ~9 us for the bytes).
//
// Design (first version; correctness first, no tensor cores yet): one block
// of 256 threads per (16 query rows, head, frame). The block walks the keys
// in tiles of 32: a K tile and the key points are staged in shared memory,
// each thread computes two logits of one row with float4 loads from rows
// padded to C+4 floats (conflict-free across a quarter warp), the 16 threads
// of a row reduce max and sum with shuffles, and the same shared buffer is
// then refilled with the V tile for the value streams. All accumulators live
// in shared memory, so any C divisible by 4 works. The pair stream reads
// pair_z straight from global memory with consecutive threads on consecutive
// channels (coalesced); at the release shapes pair_z (8 MB) stays in L2
// across the F*H blocks that read it.
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr int kRows = 16;     // query rows per block
constexpr int kKeys = 32;     // keys per tile
constexpr int kThreads = 256;
constexpr int kRowThreads = kThreads / kRows;    // threads per row: 16
constexpr int kKeysPerThread = kKeys / kRowThreads;  // 2
constexpr float kNegInit = -1e30f;  // running-max start, as the TPU kernel

static_assert(kRowThreads == 16, "row reductions use 16-lane shuffles");
static_assert(kKeys % kRowThreads == 0, "keys split evenly over a row");

__host__ __device__ inline int padded_c(int C) { return C + 4; }
__host__ __device__ inline int padded_p(int p) { return p | 1; }

__host__ inline size_t smem_floats(int C, int P3q, int P3v, int Dz) {
  const int Cs = padded_c(C), P3qs = padded_p(P3q);
  return (size_t)kRows * Cs + (size_t)kKeys * Cs + (size_t)kRows * C +
         (size_t)kRows * P3qs + (size_t)kKeys * P3qs + (size_t)kKeys * P3v +
         2 * kRows + 2 * kKeys + (size_t)kRows * (kKeys + 1) + 3 * kRows +
         (size_t)kRows * P3v + (size_t)kRows * Dz;
}

__global__ void __launch_bounds__(kThreads, 2)
ipa_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ qp,
                    const float* __restrict__ kp, const float* __restrict__ vp,
                    const float* __restrict__ bias,
                    const float* __restrict__ pz,
                    const float* __restrict__ mask,
                    const float* __restrict__ head_w, float* __restrict__ o,
                    float* __restrict__ o_pt, float* __restrict__ o_pair,
                    float* __restrict__ lse, int N, int H, int C, int P3q,
                    int P3v, int Dz, float c_qk, float c_b, float inf) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Cs = padded_c(C), P3qs = padded_p(P3q), C4 = C / 4;
  // float4-addressed buffers first: every offset stays a multiple of 4
  float* sQ = smem;                    // [kRows][Cs]
  float* sKV = sQ + kRows * Cs;        // [kKeys][Cs]: K tile, then V tile
  float* sO = sKV + kKeys * Cs;        // [kRows][C] accumulator
  float* sQP = sO + kRows * C;         // [kRows][P3qs]
  float* sKP = sQP + kRows * P3qs;     // [kKeys][P3qs]
  float* sVP = sKP + kKeys * P3qs;     // [kKeys][P3v]
  float* sQsq = sVP + kKeys * P3v;     // [kRows] |qp|^2
  float* sQm = sQsq + kRows;           // [kRows] query mask
  float* sKsq = sQm + kRows;           // [kKeys] |kp|^2
  float* sKm = sKsq + kKeys;           // [kKeys] key mask
  float* sP = sKm + kKeys;             // [kRows][kKeys + 1] probabilities
  float* sM = sP + kRows * (kKeys + 1);  // [kRows] running max
  float* sL = sM + kRows;              // [kRows] running denominator
  float* sA = sL + kRows;              // [kRows] rescale of this tile
  float* sOpt = sA + kRows;            // [kRows][P3v] accumulator
  float* sOpair = sOpt + kRows * P3v;  // [kRows][Dz] accumulator

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int f = blockIdx.z;
  const float w = head_w[h];
  // element (f, n, h, d) of a [F, N, H, D] tensor: ((f*N + n)*H + h)*D + d
  auto row = [&](int n) { return ((size_t)f * N + n) * H + h; };
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int e = tid; e < kRows * C4; e += kThreads) {
    const int r = e / C4, c4 = e % C4, i = i0 + r;
    reinterpret_cast<float4*>(sQ + r * Cs)[c4] =
        i < N ? reinterpret_cast<const float4*>(q + row(i) * C)[c4] : zero4;
    reinterpret_cast<float4*>(sO + r * C)[c4] = zero4;
  }
  for (int e = tid; e < kRows * P3q; e += kThreads) {
    const int r = e / P3q, x = e % P3q, i = i0 + r;
    sQP[r * P3qs + x] = i < N ? qp[row(i) * P3q + x] : 0.f;
  }
  for (int e = tid; e < kRows * P3v; e += kThreads) sOpt[e] = 0.f;
  for (int e = tid; e < kRows * Dz; e += kThreads) sOpair[e] = 0.f;
  if (tid < kRows) {
    const int i = i0 + tid;
    sQm[tid] = i < N ? mask[(size_t)f * N + i] : 0.f;
    sM[tid] = kNegInit;
    sL[tid] = 0.f;
  }
  __syncthreads();
  if (tid < kRows) {
    float s = 0.f;
    for (int x = 0; x < P3q; ++x) s += sQP[tid * P3qs + x] * sQP[tid * P3qs + x];
    sQsq[tid] = s;
  }

  // logits phase: thread -> (row r, keys cg + 16 m)
  const int r = tid / kRowThreads;
  const int cg = tid % kRowThreads;
  const int i = i0 + r;

  for (int j0 = 0; j0 < N; j0 += kKeys) {
    const int nk = min(kKeys, N - j0);  // valid keys in this tile
    for (int e = tid; e < kKeys * C4; e += kThreads) {
      const int jr = e / C4, c4 = e % C4;
      reinterpret_cast<float4*>(sKV + jr * Cs)[c4] =
          jr < nk ? reinterpret_cast<const float4*>(k + row(j0 + jr) * C)[c4]
                  : zero4;
    }
    for (int e = tid; e < kKeys * P3q; e += kThreads) {
      const int jr = e / P3q, x = e % P3q;
      sKP[jr * P3qs + x] = jr < nk ? kp[row(j0 + jr) * P3q + x] : 0.f;
    }
    for (int e = tid; e < kKeys * P3v; e += kThreads) {
      const int jr = e / P3v, x = e % P3v;
      sVP[jr * P3v + x] = jr < nk ? vp[row(j0 + jr) * P3v + x] : 0.f;
    }
    if (tid < kKeys) sKm[tid] = tid < nk ? mask[(size_t)f * N + j0 + tid] : 0.f;
    __syncthreads();
    if (tid < kKeys) {
      float s = 0.f;
      for (int x = 0; x < P3q; ++x) s += sKP[tid * P3qs + x] * sKP[tid * P3qs + x];
      sKsq[tid] = s;
    }
    __syncthreads();

    float logit[kKeysPerThread];
#pragma unroll
    for (int m = 0; m < kKeysPerThread; ++m) logit[m] = 0.f;
    const float4* q4 = reinterpret_cast<const float4*>(sQ + r * Cs);
    for (int c4 = 0; c4 < C4; ++c4) {
      const float4 a = q4[c4];
#pragma unroll
      for (int m = 0; m < kKeysPerThread; ++m) {
        const float4 b = reinterpret_cast<const float4*>(
            sKV + (cg + kRowThreads * m) * Cs)[c4];
        logit[m] = fmaf(a.x, b.x, logit[m]);
        logit[m] = fmaf(a.y, b.y, logit[m]);
        logit[m] = fmaf(a.z, b.z, logit[m]);
        logit[m] = fmaf(a.w, b.w, logit[m]);
      }
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int m = 0; m < kKeysPerThread; ++m) {
      const int jr = cg + kRowThreads * m, j = j0 + jr;
      float cross = 0.f;
      for (int x = 0; x < P3q; ++x)
        cross = fmaf(sQP[r * P3qs + x], sKP[jr * P3qs + x], cross);
      float l = c_qk * logit[m];
      l += c_b * ((i < N && jr < nk) ? bias[((size_t)i * N + j) * H + h] : 0.f);
      l += -0.5f * w * (sQsq[r] + sKsq[jr] - 2.f * cross);
      l += inf * (sQm[r] * sKm[jr] - 1.f);
      logit[m] = jr < nk ? l : -INFINITY;
      tile_max = fmaxf(tile_max, logit[m]);
    }
    for (int off = kRowThreads / 2; off > 0; off >>= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    const float m_prev = sM[r];
    const float m_new = fmaxf(m_prev, tile_max);
    float psum = 0.f;
#pragma unroll
    for (int m = 0; m < kKeysPerThread; ++m) {
      const float p = expf(logit[m] - m_new);
      sP[r * (kKeys + 1) + cg + kRowThreads * m] = p;
      psum += p;
    }
    for (int off = kRowThreads / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    __syncthreads();  // every read of sM and of the K tile is done
    if (cg == 0) {
      const float alpha = expf(m_prev - m_new);
      sA[r] = alpha;
      sM[r] = m_new;
      sL[r] = sL[r] * alpha + psum;
    }
    for (int e = tid; e < kKeys * C4; e += kThreads) {
      const int jr = e / C4, c4 = e % C4;
      reinterpret_cast<float4*>(sKV + jr * Cs)[c4] =
          jr < nk ? reinterpret_cast<const float4*>(v + row(j0 + jr) * C)[c4]
                  : zero4;
    }
    __syncthreads();

    // o: a work item is 4 rows x 4 channels, so one V load feeds 16 FMAs
    for (int e = tid; e < (kRows / 4) * C4; e += kThreads) {
      const int rg = e / C4, c4 = e % C4;
      float4 acc[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int rw = rg * 4 + rr;
        const float a = sA[rw];
        const float4 cur = reinterpret_cast<const float4*>(sO + rw * C)[c4];
        acc[rr] = make_float4(cur.x * a, cur.y * a, cur.z * a, cur.w * a);
      }
      for (int jr = 0; jr < nk; ++jr) {
        const float4 vv = reinterpret_cast<const float4*>(sKV + jr * Cs)[c4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const float p = sP[(rg * 4 + rr) * (kKeys + 1) + jr];
          acc[rr].x = fmaf(p, vv.x, acc[rr].x);
          acc[rr].y = fmaf(p, vv.y, acc[rr].y);
          acc[rr].z = fmaf(p, vv.z, acc[rr].z);
          acc[rr].w = fmaf(p, vv.w, acc[rr].w);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        reinterpret_cast<float4*>(sO + (rg * 4 + rr) * C)[c4] = acc[rr];
    }
    for (int e = tid; e < kRows * P3v; e += kThreads) {
      const int rw = e / P3v, x = e % P3v;
      float acc = sOpt[e] * sA[rw];
      for (int jr = 0; jr < nk; ++jr)
        acc = fmaf(sP[rw * (kKeys + 1) + jr], sVP[jr * P3v + x], acc);
      sOpt[e] = acc;
    }
    for (int e = tid; e < kRows * Dz; e += kThreads) {
      const int rw = e / Dz, d = e % Dz, ii = i0 + rw;
      float acc = sOpair[e] * sA[rw];
      if (ii < N) {
        const float* pzr = pz + ((size_t)ii * N + j0) * Dz + d;
        for (int jr = 0; jr < nk; ++jr)
          acc = fmaf(sP[rw * (kKeys + 1) + jr], pzr[(size_t)jr * Dz], acc);
      }
      sOpair[e] = acc;
    }
    __syncthreads();  // sKV, sP and sA are rewritten by the next tile
  }

  for (int e = tid; e < kRows * C4; e += kThreads) {
    const int rw = e / C4, c4 = e % C4, ii = i0 + rw;
    if (ii < N) {
      const float inv = 1.f / sL[rw];
      const float4 a = reinterpret_cast<const float4*>(sO + rw * C)[c4];
      reinterpret_cast<float4*>(o + row(ii) * C)[c4] =
          make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
    }
  }
  for (int e = tid; e < kRows * P3v; e += kThreads) {
    const int rw = e / P3v, x = e % P3v, ii = i0 + rw;
    if (ii < N) o_pt[row(ii) * P3v + x] = sOpt[e] * (1.f / sL[rw]);
  }
  for (int e = tid; e < kRows * Dz; e += kThreads) {
    const int rw = e / Dz, d = e % Dz, ii = i0 + rw;
    if (ii < N) o_pair[row(ii) * Dz + d] = sOpair[e] * (1.f / sL[rw]);
  }
  if (tid < kRows && i0 + tid < N)
    lse[((size_t)f * H + h) * N + i0 + tid] = sM[tid] + logf(sL[tid]);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = the
// launch was accepted). Layouts are the JAX package's: q, k, v [F, N, H, C];
// q_pts, k_pts [F, N, H, Pq, 3]; v_pts [F, N, H, Pv, 3]; bias [N, N, H];
// pair_z [N, N, Dz]; mask [F, N]; head_weights [H]; outputs o [F, N, H, C],
// o_pt [F, N, H, Pv, 3], o_pair [F, N, H, Dz], lse [F, H, N]. All float32,
// contiguous; q, k, v and o 16-byte aligned, C divisible by 4.
extern "C" int ipa_attention_fwd(
    const float* q, const float* k, const float* v, const float* q_pts,
    const float* k_pts, const float* v_pts, const float* bias,
    const float* pair_z, const float* mask, const float* head_weights,
    float* o, float* o_pt, float* o_pair, float* lse, int F, int N, int H,
    int C, int Pq, int Pv, int Dz, float c_qk, float c_b, float inf,
    int device, cudaStream_t stream) {
  if (F < 1 || N < 1 || H < 1 || C < 4 || C % 4 != 0 || Pq < 1 || Pv < 1 ||
      Dz < 1 || H > 65535 || F > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_floats(C, 3 * Pq, 3 * Pv, Dz) * sizeof(float);
  err = cudaFuncSetAttribute(ipa_attn_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kRows - 1) / kRows, H, F);
  ipa_attn_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, head_weights, o, o_pt,
      o_pair, lse, N, H, C, 3 * Pq, 3 * Pv, Dz, c_qk, c_b, inf);
  return (int)cudaGetLastError();
}

extern "C" const char* ipa_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
