// Gated geometric attention of the OmegaFold GeoFormer, fused, for sm_90a.
//
// Replaces the two Pallas TPU kernels of
// dynamicpdb_tpu/ops/pallas/geom_attention.py:
//   geom_attention  <- _kernel (:50), two-axis GeometricAttention
//   node_attention  <- _kernel_masked (:76), AttentionWEdgeBias, which adds a
//                      per-row key mask (kmask - 1) * 1e9
// For every cell (g = axis * H + head, batch row b) and query row i:
//
//   x        = X[b, g / H]                        [L, d]  (f32 or bf16)
//   q | gate = x_i  . Wqg[g] + bqg[g]             [2c]
//   k | v    = x_j  . Wkv[g] + bkv[g]             [2c] for every key j
//   s_ij     = (scale q_i) . k_j + bias[g, i, j] (+ (kmask[b, j] - 1) 1e9)
//   out_i    = (sum_j softmax_j(s_ij) v_j) * sigmoid(gate_i)   [c]
//
// with float32 arithmetic throughout and the output in the input's type.
// Neither the projections nor the [L, L] logits ever reach device memory.
//
// Bound on an H100 at the release shapes: geom_attention (B = L = 256,
// n_axis 2, H 4, d 128, c 32) does ~35 GFLOP per launch against ~137 MB of
// compulsory traffic, so float32 arithmetic bounds it (~0.52 ms at 67
// TFLOP/s outside the tensor cores); node_attention (M 16, L 256, d 256, H 8)
// ~3.3 GFLOP and ~12 MB (~0.049 ms, also arithmetic).
//
// Design (first version; correctness first, no tensor cores yet): one block
// of 256 threads per (query chunk of 256 rows, batch row, g); each thread
// owns one query row, so q, the output accumulator and the softmax state
// live in its registers and the row reductions need no shuffles. Phase 1
// stages Wqg[g] in shared memory and each thread projects its own row.
// Phase 2 walks the keys in tiles of 32: the block stages the x tile, the 256
// threads project it into a k|v tile (32 keys x 64 columns, 8 columns each,
// so every key is projected once per block, not once per query row), and
// each thread adds its row's bias (streamed from global memory per tile: a
// whole [L, L] block does not fit in shared memory at L = 256, and the bias,
// shared over b, stays in L2) and runs an online softmax. Keys past L (a
// ragged last tile) are excluded; masked keys sit near -1e9 and get exactly
// zero weight once any unmasked key has been seen.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;             // head width c
constexpr int kC2 = 2 * kC;        // q|gate and k|v widths
constexpr int kThreads = 256;      // one query row per thread
constexpr int kKeys = 32;          // keys per tile
constexpr int kColGroups = kThreads / kKeys;  // 8 threads per key row
constexpr int kColsPerThread = kC2 / kColGroups;  // 8 k|v columns each
constexpr int kMaxSmem = 232448;   // bytes a block may use on sm_90
static_assert(kColsPerThread == 8, "a thread projects 8 k|v columns");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__host__ __device__ inline size_t smem_floats(int d) {
  return (size_t)d * kC2                   // sW: Wqg, then Wkv
         + (size_t)kKeys * (d + 4)         // sX: x tile, rows padded
         + 2 * kKeys * kC                  // sK, sV
         + kKeys                           // sMask
         + (size_t)kThreads * (kC + 1);    // sGate
}

template <typename T, bool MASKED>
__global__ void __launch_bounds__(kThreads, 1)
geom_attn_kernel(const T* __restrict__ x, const float* __restrict__ wqg,
                 const float* __restrict__ bqg, const float* __restrict__ wkv,
                 const float* __restrict__ bkv, const float* __restrict__ bias,
                 const float* __restrict__ kmask, T* __restrict__ out,
                 int n_axis, int H, int L, int d, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sW = smem;                              // [d][kC2]
  float* sX = sW + (size_t)d * kC2;              // [kKeys][d + 4]
  float* sK = sX + (size_t)kKeys * (d + 4);      // [kKeys][kC]
  float* sV = sK + kKeys * kC;                   // [kKeys][kC]
  float* sMask = sV + kKeys * kC;                // [kKeys]
  float* sGate = sMask + kKeys;                  // [kThreads][kC + 1]

  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;     // this thread's query row
  const int b = blockIdx.y;                      // batch row (m for node)
  const int g = blockIdx.z;                      // axis * H + head
  const int G = n_axis * H;
  const int d4 = d / 4;
  const int xs = d + 4;                          // sX row stride
  const T* xg = x + ((size_t)b * n_axis + g / H) * L * d;
  const float* bias_g = bias + (size_t)g * L * L;
  const bool vec_bias = (L % 4) == 0;            // rows 16-byte aligned
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // ---- phase 1: q | gate of this thread's row ---------------------------
  {
    const float4* src = reinterpret_cast<const float4*>(wqg + (size_t)g * d * kC2);
    for (int e = tid; e < d * (kC2 / 4); e += kThreads) smem4[e] = src[e];
  }
  __syncthreads();
  float q[kC];
  {
    float acc[kC2];
#pragma unroll
    for (int c = 0; c < kC2; ++c) acc[c] = 0.f;
    const T* xrow = xg + (size_t)(i < L ? i : 0) * d;
    for (int dd = 0; dd < d; dd += 4) {
      const float4 xv = i < L ? load4(xrow + dd) : zero4;
      const float xu[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4* w4 = reinterpret_cast<const float4*>(sW + (dd + u) * kC2);
#pragma unroll
        for (int c4 = 0; c4 < kC2 / 4; ++c4) {
          const float4 w = w4[c4];
          acc[4 * c4 + 0] = fmaf(xu[u], w.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = fmaf(xu[u], w.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(xu[u], w.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(xu[u], w.w, acc[4 * c4 + 3]);
        }
      }
    }
    const float* bq = bqg + (size_t)g * kC2;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      q[c] = (acc[c] + bq[c]) * scale;
      sGate[tid * (kC + 1) + c] = acc[kC + c] + bq[kC + c];
    }
  }
  __syncthreads();  // sW is refilled with Wkv
  {
    const float4* src = reinterpret_cast<const float4*>(wkv + (size_t)g * d * kC2);
    for (int e = tid; e < d * (kC2 / 4); e += kThreads) smem4[e] = src[e];
  }

  // ---- phase 2: key tiles, online softmax --------------------------------
  float o[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) o[c] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;
  const int kr = tid / kColGroups;                   // projection: key row
  const int col0 = (tid % kColGroups) * kColsPerThread;  // and 8 columns
  const float* bk = bkv + (size_t)g * kC2;

  for (int j0 = 0; j0 < L; j0 += kKeys) {
    const int nk = min(kKeys, L - j0);
    for (int e = tid; e < kKeys * d4; e += kThreads) {
      const int r = e / d4, c4 = e % d4;
      const float4 v = r < nk ? load4(xg + (size_t)(j0 + r) * d + 4 * c4) : zero4;
      *reinterpret_cast<float4*>(sX + r * xs + 4 * c4) = v;
    }
    if (MASKED && tid < kKeys)
      sMask[tid] = tid < nk ? kmask[(size_t)b * L + j0 + tid] : 0.f;
    __syncthreads();

    {  // k | v of the tile: thread -> (key kr, columns col0 .. col0 + 7)
      float acc[kColsPerThread];
#pragma unroll
      for (int u = 0; u < kColsPerThread; ++u) acc[u] = 0.f;
      const float* xr = sX + kr * xs;
      for (int dd = 0; dd < d; ++dd) {
        const float xv = xr[dd];
        const float4 w0 = *reinterpret_cast<const float4*>(sW + dd * kC2 + col0);
        const float4 w1 = *reinterpret_cast<const float4*>(sW + dd * kC2 + col0 + 4);
        acc[0] = fmaf(xv, w0.x, acc[0]);
        acc[1] = fmaf(xv, w0.y, acc[1]);
        acc[2] = fmaf(xv, w0.z, acc[2]);
        acc[3] = fmaf(xv, w0.w, acc[3]);
        acc[4] = fmaf(xv, w1.x, acc[4]);
        acc[5] = fmaf(xv, w1.y, acc[5]);
        acc[6] = fmaf(xv, w1.z, acc[6]);
        acc[7] = fmaf(xv, w1.w, acc[7]);
      }
#pragma unroll
      for (int u = 0; u < kColsPerThread; ++u) {
        const int col = col0 + u;
        const float val = acc[u] + bk[col];
        if (col < kC)
          sK[kr * kC + col] = val;
        else
          sV[kr * kC + col - kC] = val;
      }
    }
    __syncthreads();

    if (i < L) {
      float s[kKeys];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float4* k4 = reinterpret_cast<const float4*>(sK + j * kC);
        float acc = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < kC / 4; ++c4) {
          const float4 kk = k4[c4];
          acc = fmaf(q[4 * c4 + 0], kk.x, acc);
          acc = fmaf(q[4 * c4 + 1], kk.y, acc);
          acc = fmaf(q[4 * c4 + 2], kk.z, acc);
          acc = fmaf(q[4 * c4 + 3], kk.w, acc);
        }
        s[j] = acc;
      }
      const float* brow = bias_g + (size_t)i * L + j0;
      if (vec_bias && nk == kKeys) {
#pragma unroll
        for (int j4 = 0; j4 < kKeys / 4; ++j4) {
          const float4 bb = load4(brow + 4 * j4);
          s[4 * j4 + 0] += bb.x;
          s[4 * j4 + 1] += bb.y;
          s[4 * j4 + 2] += bb.z;
          s[4 * j4 + 3] += bb.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kKeys; ++j)
          if (j < nk) s[j] += brow[j];
      }
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        if (MASKED) s[j] += (sMask[j] - 1.f) * 1e9f;
        if (j >= nk) s[j] = -INFINITY;
        tile_max = fmaxf(tile_max, s[j]);
      }
      const float m_new = fmaxf(m_run, tile_max);
      const float alpha = expf(m_run - m_new);  // 0 on the first tile
      l_run *= alpha;
#pragma unroll
      for (int c = 0; c < kC; ++c) o[c] *= alpha;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[j] - m_new);  // 0 for keys past L
        l_run += p;
        const float4* v4 = reinterpret_cast<const float4*>(sV + j * kC);
#pragma unroll
        for (int c4 = 0; c4 < kC / 4; ++c4) {
          const float4 vv = v4[c4];
          o[4 * c4 + 0] = fmaf(p, vv.x, o[4 * c4 + 0]);
          o[4 * c4 + 1] = fmaf(p, vv.y, o[4 * c4 + 1]);
          o[4 * c4 + 2] = fmaf(p, vv.z, o[4 * c4 + 2]);
          o[4 * c4 + 3] = fmaf(p, vv.w, o[4 * c4 + 3]);
        }
      }
      m_run = m_new;
    }
    __syncthreads();  // sX, sK, sV and sMask are rewritten by the next tile
  }

  if (i < L) {
    T* orow = out + (((size_t)b * G + g) * L + i) * kC;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float gate = sGate[tid * (kC + 1) + c];
      store(orow + c, (o[c] / l_run) * (1.f / (1.f + expf(-gate))));
    }
  }
}

template <typename T, bool MASKED>
int launch(const void* x, const float* wqg, const float* bqg, const float* wkv,
           const float* bkv, const float* bias, const float* kmask, void* out,
           int B, int n_axis, int H, int L, int d, int c, float scale,
           int device, cudaStream_t stream) {
  if (B < 1 || n_axis < 1 || H < 1 || L < 1 || d < 4 || d % 4 != 0 ||
      c != kC || B > 65535 || n_axis * H > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(d) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(geom_attn_kernel<T, MASKED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kThreads - 1) / kThreads, B, n_axis * H);
  geom_attn_kernel<T, MASKED><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), wqg, bqg, wkv, bkv, bias, kmask,
      static_cast<T*>(out), n_axis, H, L, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Both launchers run on `stream` and return cudaGetLastError() (0 = the
// launch was accepted). Layouts: x [B, n_axis, L, d] (node_attention: node
// [M, L, d], n_axis = 1) in float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// wqg, wkv [n_axis * H, d, 2c] and bqg, bkv [n_axis * H, 2c], float32, with
// g = axis * H + head; bias [n_axis * H, L, L] float32, shared over the
// batch rows; kmask [M, L] float32; out [B, n_axis * H, L, c] in x's type.
// All contiguous and 16-byte aligned; d divisible by 4; c = 32.
extern "C" int geom_attention(const void* x, const float* wqg, const float* bqg,
                              const float* wkv, const float* bkv,
                              const float* bias, void* out, int B, int n_axis,
                              int H, int L, int d, int c, float scale, int bf16,
                              int device, cudaStream_t stream) {
  return bf16 ? launch<__nv_bfloat16, false>(x, wqg, bqg, wkv, bkv, bias,
                                              nullptr, out, B, n_axis, H, L, d,
                                              c, scale, device, stream)
              : launch<float, false>(x, wqg, bqg, wkv, bkv, bias, nullptr, out,
                                     B, n_axis, H, L, d, c, scale, device,
                                     stream);
}

extern "C" int node_attention(const void* x, const float* wqg, const float* bqg,
                              const float* wkv, const float* bkv,
                              const float* bias, const float* kmask, void* out,
                              int M, int H, int L, int d, int c, float scale,
                              int bf16, int device, cudaStream_t stream) {
  return bf16 ? launch<__nv_bfloat16, true>(x, wqg, bqg, wkv, bkv, bias, kmask,
                                             out, M, 1, H, L, d, c, scale,
                                             device, stream)
              : launch<float, true>(x, wqg, bqg, wkv, bkv, bias, kmask, out, M,
                                    1, H, L, d, c, scale, device, stream);
}

// Dynamic shared memory per block for feature width d (bytes).
extern "C" long long geom_attention_smem(int d) {
  return (long long)(smem_floats(d) * sizeof(float));
}

extern "C" const char* geom_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
