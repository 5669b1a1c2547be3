// Gated geometric attention of the OmegaFold GeoFormer, fused, for sm_90a,
// on the tensor cores.
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
// to float32 accuracy, with the output in the input's type. Neither the
// projections nor the [L, L] logits ever reach device memory.
//
// Bound on an H100 at the release shapes: geom_attention (B = L = 256,
// n_axis 2, H 4, d 128, c 32) does 34.4 GFLOP of products and 0.6 GFLOP of
// elementwise work per launch against ~137 MB of compulsory traffic;
// node_attention (M 16, L 256, d 256, H 8) 3.2 GFLOP and ~12 MB. On the
// CUDA cores (67 TFLOP/s float32) that is 0.52 and 0.049 ms. The four
// products run here on the TF32 tensor cores (495 TFLOP/s); float32
// accuracy needs three passes (below), so the tensor-core bound is 3 x the
// products / 495 TFLOP/s plus the elementwise work / 67 TFLOP/s: ~0.22 and
// ~0.020 ms (chip_smoke.geom_cost).
//
// Precision. TF32 keeps 10 of float32's 23 mantissa bits, and one TF32
// product misses the 1e-4 float32 tolerance at d = 128 and 256 by ~5x. So a
// float32 operand is split into a TF32 high part and a TF32 low part (the
// rounding rest), and a product is hi.hi + hi.lo + lo.hi in float32
// accumulators ("3xTF32", ~2^-21 relative per term). Pass counts:
//   q.k^T and p.v: 3 passes always (q, k, v and p are float32 results);
//   the projections x.W: 3 passes, but one when x and the weights are both
//   bfloat16 (the --dtype bfloat16 path): a bf16 value has an 8-bit
//   significand, inside TF32's 10, so both low parts are 0 and one pass is
//   exact. bfloat16 x with float32 weights takes the 3-pass instance, where
//   x_lo = 0 adds nothing.
//
// Design. One block of 8 warps per (head, query chunk of 256 rows, batch
// row and axis), one block per SM; the head is the fastest grid axis, so the
// blocks that read the same x[b, axis] run together and find it in L2. Each
// warp owns 32 query rows, two 16-row mma tiles, in a flash-attention
// layout: q (as mma A fragments, hi and lo), the output and the scores live
// in mma accumulator fragments, the online softmax reduces over each row's
// quad with shuffles, and the row sums stay per thread until the end. Every
// B fragment (k, v, W) a warp loads from shared memory serves both tiles.
//   1. q | gate: a [256 x d] . [d x 64] product on the tensor cores, x and
//      Wqg staged in 32-wide slices of d by cp.async, double-buffered.
//      The q columns come out of the accumulators already in A-fragment
//      order (the c index is permuted inside each group of 8 channels, and
//      the k fragments read with the same permutation), so they stay in
//      registers; the gate waits in shared memory.
//   2. For each chunk of 128 keys: k | v of the chunk ([128 x d] . [d x 64],
//      the same staged product) is split into hi and lo once and kept
//      resident in shared memory (k as [key][c], v transposed), so every
//      warp's q.k^T and p.v read B fragments with 64-bit loads and no
//      conversion; past 128 keys the chunks stream. Each 32-key step adds a
//      bias tile brought in by cp.async (coalesced 16-byte rows when L % 4
//      == 0, 4-byte copies otherwise), double-buffered against the math, one
//      block barrier a step. The probabilities go from the score
//      accumulators straight into p.v's A fragments (keys permuted like the
//      channels above).
//   3. Epilogue: quad-sum the row sums, divide, gate, store.
// Keys past L are -inf; masked keys sit near -1e9 and get exactly zero
// weight once any unmasked key has been seen (an all-masked first tile is
// rescaled by exp(-1e9) = 0). Every L is taken: chunks and tiles are
// zero-filled past L and past the last query row.
//
// At L <= 256 a block holds every query row, so k | v is projected once per
// (b, g); past that once per query chunk. 201,216 bytes of shared memory;
// 256 threads, so a thread may hold up to 255 registers.
//
// node_attention's release grid is M H = 128 blocks for 132 SMs. Splitting
// its query rows was measured and is slower: 128-row blocks of 4 warps, two
// per SM, in two-block clusters that share each key chunk's k | v through
// distributed shared memory, took 0.078-0.081 ms against 0.0755-0.0784 ms
// for this layout on an H100 80GB HBM3 at 700 W (float32, release shapes;
// tools/bench_geom.py; the other split layouts tried are in PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32_mma.cuh"  // cp.async, mma, split, quad shuffles

namespace {

constexpr int kC = 32;             // head width c
constexpr int kC2 = 2 * kC;        // q|gate and k|v widths
constexpr int kWarps = 8;
constexpr int kMT = 2;             // 16-row tiles per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kMT * kWarps;  // query rows per block
constexpr int kChunk = 128;        // keys whose k|v are resident at once
constexpr int kTile = 32;          // keys per attention step
constexpr int kDk = 32;            // depth of one staged slice of x and W
constexpr int kMaxSmem = 232448;   // bytes a block may use on sm_90
// the k|v product's warp tile: 16 kMT keys x kKvWN columns
constexpr int kKvWN = kC2 * (kChunk / (16 * kMT)) / kWarps;
static_assert(kKvWN == 32, "a k|v warp tile is all k or all v columns");

// Row strides (floats) of the shared tiles. Each is 8 mod 32, so the 64-bit
// fragment loads of a half-warp (rows g = 0..3, column pairs 2t) fall on 32
// distinct banks; the x slice's 36 gives rows 4g + t for 32-bit loads.
constexpr int kKS = kC + 8;        // sK [key][c]
constexpr int kVS = kChunk + 8;    // sVt [c][key]
constexpr int kBS = kTile + 8;     // bias tile [query row][key]
constexpr int kWS = kC2 + 8;       // W slice [depth][column]

template <typename T> struct Staged;
template <> struct Staged<float> { static constexpr int stride = kDk + 4; };
template <> struct Staged<__nv_bfloat16> { static constexpr int stride = kDk + 8; };

// One staging buffer (x slice and W slice) of `rows` rows, float32 x.
__host__ __device__ constexpr size_t stage_bytes(int rows) {
  return (size_t)rows * (kDk + 4) * 4 + (size_t)kDk * kWS * 4;
}
constexpr size_t kResidentBytes =
    4 * (2 * kChunk * kKS + 2 * kC * kVS   // sK hi/lo, sVt hi/lo
         + 16 * kMT * kThreads             // sGate
         + kChunk);                        // sMask
constexpr size_t kStageBytes = 2 * stage_bytes(kRows);
static_assert(2 * (size_t)kRows * kBS * 4 <= kStageBytes, "bias tiles fit");
constexpr size_t kSmemBytes = kResidentBytes + kStageBytes;
static_assert(kResidentBytes % 16 == 0, "the stage region is 16-byte aligned");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// acc = x[row0 : row0 + ROWS] . W (rows past L read as 0), W [d][kC2] with
// rows ws floats apart. ROWS / WM x kC2 / WN warps (WM = 16 kMT); warp w
// owns rows WM (w % (ROWS / WM)) + 0..WM-1, as kMT 16-row tiles, and columns
// WN (w / (ROWS / WM)) + 0..WN-1, in C-fragment layout. x and W come
// through `stage` in slices of kDk, double-buffered by cp.async. PP is the
// pass count, 3 or 1 (see the header). Starts and ends with a block barrier.
template <typename T, int ROWS, int WN, int PP>
__device__ __forceinline__ void project(float (&acc)[kMT][WN / 8][4],
                                        const T* __restrict__ xg, int row0,
                                        int L, int d,
                                        const float* __restrict__ w,
                                        int ws, char* stage) {
  constexpr int WM = 16 * kMT;  // rows of a warp tile
  static_assert((ROWS / WM) * (kC2 / WN) == kWarps, "one tile per warp");
  constexpr int XS = Staged<T>::stride;
  constexpr int XBYTES = ROWS * XS * (int)sizeof(T);
  constexpr int BUF = (int)stage_bytes(ROWS);
  constexpr int PER16 = 16 / (int)sizeof(T);  // x elements per 16 bytes
  constexpr int XCH = kDk / PER16;            // 16-byte copies per x row
  static_assert(XBYTES % 16 == 0, "W slice is 16-byte aligned");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % (ROWS / WM), wn = warp / (ROWS / WM);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < WN / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  auto fetch = [&](int slice, int buf) {
    T* sx = reinterpret_cast<T*>(stage + buf * BUF);
    float* sw = reinterpret_cast<float*>(stage + buf * BUF + XBYTES);
    const int d0 = slice * kDk;
    for (int e = tid; e < ROWS * XCH; e += kThreads) {
      const int r = e / XCH, col = d0 + (e % XCH) * PER16;
      const bool ok = row0 + r < L && col < d;
      cp_async16(sx + r * XS + (e % XCH) * PER16,
                 ok ? xg + (size_t)(row0 + r) * d + col : xg, ok);
    }
    for (int e = tid; e < kDk * (kC2 / 4); e += kThreads) {
      const int r = e / (kC2 / 4), c4 = e % (kC2 / 4);
      const bool ok = d0 + r < d;
      cp_async16(sw + r * kWS + 4 * c4,
                 ok ? w + (size_t)(d0 + r) * ws + 4 * c4 : w, ok);
    }
    cp_async_commit();
  };

  const int n_slices = (d + kDk - 1) / kDk;
  __syncthreads();  // the stage region may still be read
  fetch(0, 0);
  for (int sl = 0; sl < n_slices; ++sl) {
    if (sl + 1 < n_slices) {
      fetch(sl + 1, (sl + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sx = reinterpret_cast<const T*>(stage + (sl & 1) * BUF);
    const float* sw =
        reinterpret_cast<const float*>(stage + (sl & 1) * BUF + XBYTES);
#pragma unroll
    for (int ks = 0; ks < kDk / 8; ++ks) {
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const T* xa = sx + (WM * wm + 16 * mt + g) * XS + 8 * ks + t;
        const float a[4] = {to_float(xa[0]), to_float(xa[8 * XS]),
                            to_float(xa[4]), to_float(xa[8 * XS + 4])};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (PP == 3)
            split(a[j], ah[mt][j], al[mt][j]);
          else
            ah[mt][j] = __float_as_uint(a[j]);  // bf16 x: exact in TF32
        }
      }
#pragma unroll
      for (int nt = 0; nt < WN / 8; ++nt) {
        const float* wb = sw + (8 * ks + t) * kWS + wn * WN + 8 * nt + g;
        const float b[2] = {wb[0], wb[4 * kWS]};
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (PP == 1)
            bh[j] = __float_as_uint(b[j]);  // bf16 weights: exact in TF32
          else
            split(b[j], bh[j], bl[j]);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (PP == 3) {
            mma(acc[mt][nt], al[mt], bh);
            mma(acc[mt][nt], ah[mt], bl);
          }
          mma(acc[mt][nt], ah[mt], bh);
        }
      }
    }
    __syncthreads();  // the next fetch overwrites this buffer
  }
}

// The bias tile [kRows query rows][kTile keys] at (row0, j0) into sb; rows
// and keys past L are zero-filled (and never used).
__device__ __forceinline__ void fetch_bias(float* sb,
                                           const float* __restrict__ bias_g,
                                           int row0, int j0, int L, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {  // L % 4 == 0: 16-byte aligned rows, whole 4-key groups
    for (int e = tid; e < kRows * (kTile / 4); e += kThreads) {
      const int r = e / (kTile / 4), j = j0 + 4 * (e % (kTile / 4));
      const bool ok = row0 + r < L && j < L;
      cp_async16(sb + r * kBS + (j - j0),
                 ok ? bias_g + (size_t)(row0 + r) * L + j : bias_g, ok);
    }
  } else {
    for (int e = tid; e < kRows * kTile; e += kThreads) {
      const int r = e / kTile, j = j0 + e % kTile;
      const bool ok = row0 + r < L && j < L;
      cp_async4(sb + r * kBS + (j - j0),
                ok ? bias_g + (size_t)(row0 + r) * L + j : bias_g, ok);
    }
  }
  cp_async_commit();
}

template <typename T, bool MASKED, int PP>
__global__ void __launch_bounds__(kThreads, 1)
geom_attn_kernel(const T* __restrict__ x, const float* __restrict__ wqg,
                 const float* __restrict__ bqg, const float* __restrict__ wkv,
                 const float* __restrict__ bkv, const float* __restrict__ bias,
                 const float* __restrict__ kmask, T* __restrict__ out,
                 int n_axis, int H, int L, int d, float scale) {
  extern __shared__ float4 smem4[];
  float* sKh = reinterpret_cast<float*>(smem4);  // [kChunk][kKS]
  float* sKl = sKh + kChunk * kKS;
  float* sVh = sKl + kChunk * kKS;               // [kC][kVS], v transposed
  float* sVl = sVh + kC * kVS;
  float* sGate = sVl + kC * kVS;                 // [16 kMT][kThreads]
  float* sMask = sGate + 16 * kMT * kThreads;    // [kChunk]
  char* stage = reinterpret_cast<char*>(sMask + kChunk);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int head = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int ba = blockIdx.z;                     // b * n_axis + axis
  const int b = ba / n_axis;
  const int gi = (ba % n_axis) * H + head;
  const int G = n_axis * H;
  const T* xg = x + (size_t)ba * L * d;
  const float* bias_g = bias + (size_t)gi * L * L;
  const bool vec = (L % 4) == 0;
  const int wrow = 16 * kMT * warp;              // this warp's first row

  // ---- 1. q | gate of the block's rows ---------------------------------
  uint32_t qh[kMT][4][4], ql[kMT][4][4];  // A fragments per 8-channel step
  {
    float acc[kMT][8][4];
    project<T, kRows, kC2, PP>(acc, xg, row0, L, d, wqg + gi * kC2, G * kC2,
                               stage);
    const float* bq = bqg + (size_t)gi * kC2;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          q[j] = (acc[mt][nt][j] + bq[8 * nt + 2 * t + (j & 1)]) * scale;
        // C layout (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) -> A layout
        // (g, t), (g+8, t), (g, t+4), (g+8, t+4) with channel 2t at column
        // t and 2t + 1 at column t + 4
        split(q[0], qh[mt][nt][0], ql[mt][nt][0]);
        split(q[2], qh[mt][nt][1], ql[mt][nt][1]);
        split(q[1], qh[mt][nt][2], ql[mt][nt][2]);
        split(q[3], qh[mt][nt][3], ql[mt][nt][3]);
      }
#pragma unroll
      for (int nt = 4; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sGate[(16 * mt + 4 * (nt - 4) + j) * kThreads + tid] =
              acc[mt][nt][j] + bq[8 * nt + 2 * t + (j & 1)];
    }
  }

  // ---- 2. key chunks: k|v resident, 32-key steps of online softmax ------
  float o[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[mt][n][j] = 0.f;
  float m_run[kMT][2], l_run[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_run[mt][h] = -INFINITY;
      l_run[mt][h] = 0.f;
    }
  float* sb[2] = {reinterpret_cast<float*>(stage),
                  reinterpret_cast<float*>(stage) + kRows * kBS};

  for (int kc0 = 0; kc0 < L; kc0 += kChunk) {
    {
      float acc[kMT][kKvWN / 8][4];
      project<T, kChunk, kKvWN, PP>(acc, xg, kc0, L, d, wkv + gi * kC2,
                                    G * kC2, stage);
      constexpr int WM = 16 * kMT;
      const int wm = warp % (kChunk / WM), wn = warp / (kChunk / WM);
      const float* bk = bkv + (size_t)gi * kC2 + kKvWN * wn;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kKvWN / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = WM * wm + 16 * mt + g + 8 * (j >> 1);
            const int ch = 8 * nt + 2 * t + (j & 1);
            uint32_t hi, lo;
            split(acc[mt][nt][j] + bk[ch], hi, lo);
            if (wn == 0) {
              sKh[key * kKS + ch] = __uint_as_float(hi);
              sKl[key * kKS + ch] = __uint_as_float(lo);
            } else {
              sVh[ch * kVS + key] = __uint_as_float(hi);
              sVl[ch * kVS + key] = __uint_as_float(lo);
            }
          }
      if (MASKED && tid < kChunk)
        sMask[tid] = kc0 + tid < L ? kmask[(size_t)b * L + kc0 + tid] : 0.f;
    }
    const int n_tiles = (min(kChunk, L - kc0) + kTile - 1) / kTile;
    fetch_bias(sb[0], bias_g, row0, kc0, L, vec);
    for (int jt = 0; jt < n_tiles; ++jt) {
      cp_async_wait<0>();
      // the bias tile jt has landed (and k|v and the mask, at jt == 0), and
      // every warp is done with step jt - 1 and so with the other buffer,
      // which now takes tile jt + 1 while this step computes
      __syncthreads();
      if (jt + 1 < n_tiles)
        fetch_bias(sb[(jt + 1) & 1], bias_g, row0, kc0 + (jt + 1) * kTile, L,
                   vec);
      const int kl0 = jt * kTile;  // first key of the step, in the chunk
      const int j0 = kc0 + kl0;

      // s = q . k^T, 3xTF32; each k fragment serves the warp's kMT tiles
      float s[kMT][4][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[mt][nt][j] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int off = (kl0 + 8 * nt + g) * kKS + 8 * ks + 2 * t;
          const float2 kh = *reinterpret_cast<const float2*>(sKh + off);
          const float2 kl = *reinterpret_cast<const float2*>(sKl + off);
          const uint32_t bh[2] = {__float_as_uint(kh.x), __float_as_uint(kh.y)};
          const uint32_t bl[2] = {__float_as_uint(kl.x), __float_as_uint(kl.y)};
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma(s[mt][nt], ql[mt][ks], bh);
            mma(s[mt][nt], qh[mt][ks], bl);
            mma(s[mt][nt], qh[mt][ks], bh);
          }
        }

      // + bias (+ mask); keys past L get -inf
      const float* sbt = sb[jt & 1];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = 8 * nt + 2 * t;
            const float2 bb = *reinterpret_cast<const float2*>(
                sbt + (wrow + 16 * mt + g + 8 * h) * kBS + col);
            const float bv[2] = {bb.x, bb.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = s[mt][nt][2 * h + e] + bv[e];
              if (MASKED) v += (sMask[kl0 + col + e] - 1.f) * 1e9f;
              s[mt][nt][2 * h + e] = j0 + col + e < L ? v : -INFINITY;
            }
          }

      // online softmax over the quad's 32 keys, rows g and g + 8 of each
      // tile
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mx = fmaxf(mx, fmaxf(s[mt][nt][2 * h], s[mt][nt][2 * h + 1]));
          // finite: key j0 is real; alpha is 0 at the start
          const float m_new = fmaxf(m_run[mt][h], quad_max(mx));
          const float alpha = expf(m_run[mt][h] - m_new);
          m_run[mt][h] = m_new;
          l_run[mt][h] *= alpha;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            o[mt][n][2 * h] *= alpha;
            o[mt][n][2 * h + 1] *= alpha;
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = expf(s[mt][nt][2 * h + e] - m_new);  // 0 past L
              s[mt][nt][2 * h + e] = p;
              l_run[mt][h] += p;
            }
        }

      // o += p . v, 3xTF32; the A fragment of keys 8ks.. is s[mt][ks] with
      // key 2t at column t and 2t + 1 at column t + 4, v read the same way
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ph[kMT][4], pl[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          split(s[mt][ks][0], ph[mt][0], pl[mt][0]);
          split(s[mt][ks][2], ph[mt][1], pl[mt][1]);
          split(s[mt][ks][1], ph[mt][2], pl[mt][2]);
          split(s[mt][ks][3], ph[mt][3], pl[mt][3]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int off = (8 * n + g) * kVS + kl0 + 8 * ks + 2 * t;
          const float2 vh = *reinterpret_cast<const float2*>(sVh + off);
          const float2 vl = *reinterpret_cast<const float2*>(sVl + off);
          const uint32_t bh[2] = {__float_as_uint(vh.x), __float_as_uint(vh.y)};
          const uint32_t bl[2] = {__float_as_uint(vl.x), __float_as_uint(vl.y)};
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma(o[mt][n], pl[mt], bh);
            mma(o[mt][n], ph[mt], bl);
            mma(o[mt][n], ph[mt], bh);
          }
        }
      }
    }
    // the next chunk's project() starts with a barrier before it restages
  }

  // ---- 3. normalise, gate, store ----------------------------------------
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float l = quad_sum(l_run[mt][h]);
      const int i = row0 + wrow + 16 * mt + g + 8 * h;
      if (i >= L) continue;
      T* orow = out + (((size_t)b * G + gi) * L + i) * kC;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float gate =
              sGate[(16 * mt + 4 * n + 2 * h + e) * kThreads + tid];
          v[e] = (o[mt][n][2 * h + e] / l) * (1.f / (1.f + expf(-gate)));
        }
        store2(orow + 8 * n + 2 * t, v[0], v[1]);
      }
    }
}

template <typename T, bool MASKED, int PP>
int launch(const void* x, const float* wqg, const float* bqg, const float* wkv,
           const float* bkv, const float* bias, const float* kmask, void* out,
           int B, int n_axis, int H, int L, int d, int c, float scale,
           int device, cudaStream_t stream) {
  if (B < 1 || n_axis < 1 || H < 1 || L < 1 || d < 8 || d % 8 != 0 ||
      c != kC || (long long)B * n_axis > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  static_assert(kSmemBytes <= (size_t)kMaxSmem, "fits one block");
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(geom_attn_kernel<T, MASKED, PP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, (L + kRows - 1) / kRows, B * n_axis);
  geom_attn_kernel<T, MASKED, PP><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), wqg, bqg, wkv, bkv, bias, kmask,
      static_cast<T*>(out), n_axis, H, L, d, scale);
  return (int)cudaGetLastError();
}

template <bool MASKED>
int dispatch(const void* x, const float* wqg, const float* bqg,
             const float* wkv, const float* bkv, const float* bias,
             const float* kmask, void* out, int B, int n_axis, int H, int L,
             int d, int c, float scale, int bf16, int w_bf16, int device,
             cudaStream_t stream) {
  using bf = __nv_bfloat16;
  if (!bf16)
    return launch<float, MASKED, 3>(x, wqg, bqg, wkv, bkv, bias, kmask, out,
                                    B, n_axis, H, L, d, c, scale, device,
                                    stream);
  if (w_bf16)
    return launch<bf, MASKED, 1>(x, wqg, bqg, wkv, bkv, bias, kmask, out, B,
                                 n_axis, H, L, d, c, scale, device, stream);
  return launch<bf, MASKED, 3>(x, wqg, bqg, wkv, bkv, bias, kmask, out, B,
                               n_axis, H, L, d, c, scale, device, stream);
}

}  // namespace

// Both launchers run on `stream` and return cudaGetLastError() (0 = the
// launch was accepted). Layouts: x [B, n_axis, L, d] (node_attention: node
// [M, L, d], n_axis = 1) in float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// wqg, wkv [d, n_axis * H, 2c] and bqg, bkv [n_axis * H, 2c], float32, with
// g = axis * H + head; w_bf16 = 1 promises that every value of wqg and wkv
// is a bfloat16 value (one projection pass with bf16 x); bias
// [n_axis * H, L, L] float32, shared over the batch rows; kmask [M, L]
// float32; out [B, n_axis * H, L, c] in x's type. All contiguous and
// 16-byte aligned; d divisible by 8; c = 32.
extern "C" int geom_attention(const void* x, const float* wqg, const float* bqg,
                              const float* wkv, const float* bkv,
                              const float* bias, void* out, int B, int n_axis,
                              int H, int L, int d, int c, float scale, int bf16,
                              int w_bf16, int device, cudaStream_t stream) {
  return dispatch<false>(x, wqg, bqg, wkv, bkv, bias, nullptr, out, B, n_axis,
                         H, L, d, c, scale, bf16, w_bf16, device, stream);
}

extern "C" int node_attention(const void* x, const float* wqg, const float* bqg,
                              const float* wkv, const float* bkv,
                              const float* bias, const float* kmask, void* out,
                              int M, int H, int L, int d, int c, float scale,
                              int bf16, int w_bf16, int device,
                              cudaStream_t stream) {
  return dispatch<true>(x, wqg, bqg, wkv, bkv, bias, kmask, out, M, 1, H, L,
                        d, c, scale, bf16, w_bf16, device, stream);
}

// Dynamic shared memory per block (bytes); the same for every d.
extern "C" long long geom_attention_smem(int d) {
  (void)d;
  return (long long)kSmemBytes;
}

extern "C" const char* geom_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
