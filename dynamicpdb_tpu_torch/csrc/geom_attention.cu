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
// node_attention also takes a block of query rows: row i of its output is
// x's row q0 + i (zeros past L: a 'seq' rank's pad rows), i < Lq, against
// all L keys, with the bias [H, Lq, L] of those rows; sequence
// parallelism gives each rank its own rows of the GeoFormer's residues.
// geom_attention's queries are all L rows (q0 = 0, Lq = L): under sequence
// parallelism a rank's rows are its batch rows B. Only offsets, limits and
// the grid depend on (q0, Lq): the square call computes what it computed
// before, bit for bit.
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
// Design. One block of 8 warps per (head, query chunk, batch row and axis),
// one block per SM; the head is the fastest grid axis, so the blocks that
// read the same x[b, axis] run together and find it in L2. A query chunk is
// 256 rows, or 128 (the two instances, below). Each warp owns 32 query
// rows, two 16-row mma tiles (16 rows, one tile, in the 128-row instance),
// in a flash-attention layout: q (as mma A fragments, hi and lo), the
// output and the scores live in mma accumulator fragments, the online
// softmax reduces over each row's quad with shuffles, and the row sums stay
// per thread until the end. Every B fragment (k, v, W) a warp loads from
// shared memory serves all its tiles.
//   1. q | gate: a [rows x d] . [d x 64] product on the tensor cores, x and
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
// Two instances, the same arithmetic for each row: 256 query rows a block
// (two tiles a warp) and 128 (one tile a warp). The caller picks one per
// call (ops/geom_attention.py tile_rows): a block's k | v is projected once
// per (b, g, query chunk), so the 128-row instance takes the calls whose
// query rows fit one 128-row chunk (Lq <= 128: a 'seq' rank's block, short
// sequences), where the 256-row tile would run half or more of its rows on
// zeros, and the 256-row instance every other call, where 128-row chunks
// would re-project k | v more often. The k | v product keeps its warp tile
// (32 keys x 32 columns) in both. A row's arithmetic does not depend on the
// instance: the same mma sequence per element, the same 32-key steps, so a
// row of a block call equals the square call's bit for bit. Shared memory:
// 201,216 bytes at 256 rows, 147,968 at 128 (the gate and the staged x
// slices shrink with the rows). The freed space buys nothing: no second
// block per SM (that needs ~113 KB each, and k | v of a key chunk alone
// hold 75 KB), and three or four staging buffers for the projections,
// tried on rows 128-255 of the release window, ran slower than two, so the
// staging stays double-buffered. 256 threads, so a thread may hold up to
// 255 registers.
//
// node_attention's release grid is M H = 128 blocks for 132 SMs. Splitting
// its square call's query rows was measured and is slower: 128-row blocks
// of 4 warps, two per SM, in two-block clusters that share each key
// chunk's k | v through distributed shared memory, took 0.078-0.081 ms
// against 0.0755-0.0784 ms for this layout on an H100 80GB HBM3 at 700 W
// (float32, release shapes; tools/bench_geom.py; the other split layouts
// tried are in PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "tf32_mma.cuh"  // cp.async, mma, split, quad shuffles

namespace {

constexpr int kC = 32;             // head width c
constexpr int kC2 = 2 * kC;        // q|gate and k|v widths
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 128;        // keys whose k|v are resident at once
constexpr int kTile = 32;          // keys per attention step
constexpr int kDk = 32;            // depth of one staged slice of x and W
constexpr int kMaxSmem = 232448;   // bytes a block may use on sm_90
// the k|v product's warp tile, the same in both instances: kKvMT 16-key mma
// tiles x kKvWN columns
constexpr int kKvMT = 2;
constexpr int kKvWN = kC2 * (kChunk / (16 * kKvMT)) / kWarps;
static_assert(kKvWN == 32, "a k|v warp tile is all k or all v columns");

// 16-row mma tiles per warp in the instance of `rows` query rows a block
__host__ __device__ constexpr int tiles_per_warp(int rows) {
  return rows / (16 * kWarps);
}

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
// Shared memory of the instance of `rows` query rows: k|v of a key chunk
// (hi and lo), the gate, the key mask, then two staging buffers of the
// larger of the query tile and the key chunk.
__host__ __device__ constexpr size_t resident_bytes(int rows) {
  return 4 * (2 * kChunk * kKS + 2 * kC * kVS   // sK hi/lo, sVt hi/lo
              + 16 * tiles_per_warp(rows) * kThreads  // sGate
              + kChunk);                                // sMask
}
__host__ __device__ constexpr size_t smem_bytes(int rows) {
  return resident_bytes(rows)
         + 2 * stage_bytes(rows > kChunk ? rows : kChunk);
}
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
// rows ws floats apart. ROWS / WM x kC2 / WN warps (WM = 16 MT); warp w
// owns rows WM (w % (ROWS / WM)) + 0..WM-1, as MT 16-row tiles, and columns
// WN (w / (ROWS / WM)) + 0..WN-1, in C-fragment layout. x and W come
// through `stage` in slices of kDk, double-buffered by cp.async. PP is the
// pass count, 3 or 1 (see the header). Every element of acc takes the same
// mma sequence whatever the tile's shape: per 8-deep step of d, lo.hi,
// hi.lo, hi.hi. Starts and ends with a block barrier.
template <typename T, int ROWS, int MT, int WN, int PP>
__device__ __forceinline__ void project(float (&acc)[MT][WN / 8][4],
                                        const T* __restrict__ xg, int row0,
                                        int L, int d,
                                        const float* __restrict__ w,
                                        int ws, char* stage) {
  constexpr int WM = 16 * MT;  // rows of a warp tile
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
  for (int mt = 0; mt < MT; ++mt)
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
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
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
        for (int mt = 0; mt < MT; ++mt) {
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

// The bias tile [ROWS query rows][kTile keys] at (row0, j0) into sb, of
// a bias with Lq rows of L keys; rows past Lq and keys past L are
// zero-filled (and never used).
template <int ROWS>
__device__ __forceinline__ void fetch_bias(float* sb,
                                           const float* __restrict__ bias_g,
                                           int row0, int j0, int Lq, int L,
                                           bool vec) {
  const int tid = threadIdx.x;
  if (vec) {  // L % 4 == 0: 16-byte aligned rows, whole 4-key groups
    for (int e = tid; e < ROWS * (kTile / 4); e += kThreads) {
      const int r = e / (kTile / 4), j = j0 + 4 * (e % (kTile / 4));
      const bool ok = row0 + r < Lq && j < L;
      cp_async16(sb + r * kBS + (j - j0),
                 ok ? bias_g + (size_t)(row0 + r) * L + j : bias_g, ok);
    }
  } else {
    for (int e = tid; e < ROWS * kTile; e += kThreads) {
      const int r = e / kTile, j = j0 + e % kTile;
      const bool ok = row0 + r < Lq && j < L;
      cp_async4(sb + r * kBS + (j - j0),
                ok ? bias_g + (size_t)(row0 + r) * L + j : bias_g, ok);
    }
  }
  cp_async_commit();
}

template <typename T, bool MASKED, int PP, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
geom_attn_kernel(const T* __restrict__ x, const float* __restrict__ wqg,
                 const float* __restrict__ bqg, const float* __restrict__ wkv,
                 const float* __restrict__ bkv, const float* __restrict__ bias,
                 const float* __restrict__ kmask, T* __restrict__ out,
                 int n_axis, int H, int L, int Lq, int q0, int d,
                 float scale) {
  constexpr int kRows = ROWS;                 // query rows a block
  constexpr int kMT = tiles_per_warp(kRows);  // 16-row tiles per warp
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
  const int row0 = blockIdx.y * kRows;           // of the Lq query rows
  const int ba = blockIdx.z;                     // b * n_axis + axis
  const int b = ba / n_axis;
  const int gi = (ba % n_axis) * H + head;
  const int G = n_axis * H;
  const T* xg = x + (size_t)ba * L * d;
  const float* bias_g = bias + (size_t)gi * Lq * L;
  const bool vec = (L % 4) == 0;
  const int wrow = 16 * kMT * warp;              // this warp's first row

  // ---- 1. q | gate of the block's rows ---------------------------------
  uint32_t qh[kMT][4][4], ql[kMT][4][4];  // A fragments per 8-channel step
  {
    float acc[kMT][8][4];
    // x rows q0 + row0 + r, read as 0 at and past min(q0 + Lq, L)
    project<T, kRows, kMT, kC2, PP>(acc, xg, q0 + row0, min(q0 + Lq, L), d,
                                    wqg + gi * kC2, G * kC2, stage);
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
      float acc[kKvMT][kKvWN / 8][4];
      project<T, kChunk, kKvMT, kKvWN, PP>(acc, xg, kc0, L, d,
                                           wkv + gi * kC2, G * kC2, stage);
      constexpr int WM = 16 * kKvMT;
      const int wm = warp % (kChunk / WM), wn = warp / (kChunk / WM);
      const float* bk = bkv + (size_t)gi * kC2 + kKvWN * wn;
#pragma unroll
      for (int mt = 0; mt < kKvMT; ++mt)
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
    fetch_bias<kRows>(sb[0], bias_g, row0, kc0, Lq, L, vec);
    for (int jt = 0; jt < n_tiles; ++jt) {
      cp_async_wait<0>();
      // the bias tile jt has landed (and k|v and the mask, at jt == 0), and
      // every warp is done with step jt - 1 and so with the other buffer,
      // which now takes tile jt + 1 while this step computes
      __syncthreads();
      if (jt + 1 < n_tiles)
        fetch_bias<kRows>(sb[(jt + 1) & 1], bias_g, row0,
                          kc0 + (jt + 1) * kTile, Lq, L, vec);
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
      if (i >= Lq) continue;
      T* orow = out + (((size_t)b * G + gi) * Lq + i) * kC;
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

// One call's operands and shapes (the launchers' layouts, below).
struct Call {
  const void* x;
  const float *wqg, *bqg, *wkv, *bkv, *bias, *kmask;
  void* out;
  int B, n_axis, H, L, Lq, q0, d;
  float scale;
};

constexpr int kMaxDevices = 64;  // devices whose attribute state is kept

// Launch the instance of ROWS query rows a block on the current device.
// The kernel's shared-memory attribute is set on its first launch on each
// device and kept, not set again per call.
template <typename T, bool MASKED, int PP, int ROWS>
cudaError_t launch(const Call& a, int device, cudaStream_t stream) {
  static_assert(ROWS % (16 * kWarps) == 0, "whole 16-row tiles per warp");
  static_assert(2 * (size_t)ROWS * kBS * 4 <= 2 * stage_bytes(ROWS),
                "bias tiles fit");
  static_assert(resident_bytes(ROWS) % 16 == 0,
                "the stage region is 16-byte aligned");
  static_assert(smem_bytes(ROWS) <= (size_t)kMaxSmem, "fits one block");
  constexpr size_t smem = smem_bytes(ROWS);
  static std::atomic<unsigned long long> ready{0};  // one bit a device
  const unsigned long long bit = 1ull << device;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        geom_attn_kernel<T, MASKED, PP, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid(a.H, (a.Lq + ROWS - 1) / ROWS, a.B * a.n_axis);
  geom_attn_kernel<T, MASKED, PP, ROWS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), a.wqg, a.bqg, a.wkv, a.bkv, a.bias,
      a.kmask, static_cast<T*>(a.out), a.n_axis, a.H, a.L, a.Lq, a.q0, a.d,
      a.scale);
  return cudaGetLastError();
}

template <typename T, bool MASKED, int PP>
cudaError_t launch_rows(const Call& a, int rows, int device,
                        cudaStream_t stream) {
  return rows == 128 ? launch<T, MASKED, PP, 128>(a, device, stream)
                     : launch<T, MASKED, PP, 256>(a, device, stream);
}

template <bool MASKED>
int dispatch(const Call& a, int c, int bf16, int w_bf16, int rows,
             int device, cudaStream_t stream) {
  if (a.B < 1 || a.n_axis < 1 || a.H < 1 || a.L < 1 || a.Lq < 1 ||
      a.q0 < 0 || a.d < 8 || a.d % 8 != 0 || c != kC ||
      (long long)a.B * a.n_axis > 65535 || a.H > 65535 ||
      (rows != 128 && rows != 256) || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  // launch on `device`, then give the caller back its current device
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  using bf = __nv_bfloat16;
  if (!bf16)
    err = launch_rows<float, MASKED, 3>(a, rows, device, stream);
  else if (w_bf16)
    err = launch_rows<bf, MASKED, 1>(a, rows, device, stream);
  else
    err = launch_rows<bf, MASKED, 3>(a, rows, device, stream);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

}  // namespace

// Both launchers run on `stream` and return cudaGetLastError() (0 = the
// launch was accepted); the caller's current device is left as it was.
// Layouts: x [B, n_axis, L, d] (node_attention: node [M, L, d], n_axis =
// 1) in float32 (bf16 = 0) or bfloat16 (bf16 = 1); wqg, wkv
// [d, n_axis * H, 2c] and bqg, bkv [n_axis * H, 2c], float32, with g =
// axis * H + head; w_bf16 = 1 promises that every value of wqg and wkv is
// a bfloat16 value (one projection pass with bf16 x); bias
// [n_axis * H, L, L] float32, shared over the batch rows (node_attention:
// [H, Lq, L], its query rows' bias); kmask [M, L] float32; out
// [B, n_axis * H, L, c] in x's type (node_attention: [M, H, Lq, c], row i
// the query x[q0 + i], zeros past L). All contiguous and 16-byte aligned;
// d divisible by 8; c = 32. `rows` picks the instance, 128 or 256 query
// rows a block; any other value is refused (cudaErrorInvalidValue).
extern "C" int geom_attention(const void* x, const float* wqg, const float* bqg,
                              const float* wkv, const float* bkv,
                              const float* bias, void* out, int B, int n_axis,
                              int H, int L, int d, int c, float scale, int bf16,
                              int w_bf16, int rows, int device,
                              cudaStream_t stream) {
  const Call a{x, wqg, bqg, wkv, bkv, bias, nullptr, out, B, n_axis, H, L, L,
               0, d, scale};
  return dispatch<false>(a, c, bf16, w_bf16, rows, device, stream);
}

extern "C" int node_attention(const void* x, const float* wqg, const float* bqg,
                              const float* wkv, const float* bkv,
                              const float* bias, const float* kmask, void* out,
                              int M, int H, int L, int Lq, int q0, int d, int c,
                              float scale, int bf16, int w_bf16, int rows,
                              int device, cudaStream_t stream) {
  const Call a{x, wqg, bqg, wkv, bkv, bias, kmask, out, M, 1, H, L, Lq, q0,
               d, scale};
  return dispatch<true>(a, c, bf16, w_bf16, rows, device, stream);
}

// Dynamic shared memory per block (bytes) of the instance of `rows` query
// rows, the same for every d; -1 for a `rows` the kernel has no instance of.
extern "C" long long geom_attention_smem(int rows) {
  return rows == 128 ? (long long)smem_bytes(128)
         : rows == 256 ? (long long)smem_bytes(256) : -1;
}

extern "C" const char* geom_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
