// The triangle-multiplicative branch of the OmegaFold GeoFormer's
// GeometricAttention, for sm_90a, on the tensor cores.
//
// No TPU kernel is replaced: the JAX package leaves this branch to XLA's
// einsums (dynamicpdb_tpu/models/omegafold/geoformer.py:273-290). It was
// added because on an H100 the same einsums in PyTorch ran on the CUDA
// cores in float32 (cuBLAS's FFMA kernels, ~30 TFLOP/s) with a permute
// pass between each pair of them: ~2.8 ms of a 3.4 ms GeometricAttention
// call outside its attention kernel at L = 256. With e the normalised
// edge [L, L, d] (a 'seq' rank holds its rows [q0, q0 + Lr) as `edge` and
// the whole tensor as `whole`), views x_0[i, k] = e[i, k] and
// x_1[i, k] = e[k, i], masks m [L], and r = 0, 1:
//
//   act_row[r, c, i, k] = glu(x_r[i, k] . Wa_r + ba_r)[c] m[i] (m[k])
//   act_col[r, c, j, k] = glu(x_r[j, k] . Wb_r + bb_r)[c] m[j]
//   ab[r, c, i, j]      = sum_k act_row[r, c, i, k] act_col[r, c, j, k]
//   out[i, j]           = attended[i, j] + sum_r (LN(ab[r, :, i, j]) . Wo_r
//                         + bo_r) * sigmoid(x_r[i, j] . Wg_r + bg_r)
//
// with glu(v) = v[:d] sigmoid(v[d:]), (m[k]) under pad_safe only, Wa_r,
// Wb_r, Wg_r column blocks of act_w[:, r] as stored, LN the LayerNorm
// without affine (float32 statistics, biased variance, eps 1e-5). Three
// kernels, one per line above but the last two together:
//   tri_proj  the four projections (two views x row and column operand), the
//             GLU and the masks; writes act_row [2, d, Lr, Lp] and act_col
//             [2, d, L, Lp], the summed index k contiguous and zero past L
//             (Lp = L rounded up to 64), which are the product's K-major
//             operands;
//   tri_mm    the triangle product, 2d independent [Lr x Lp] . [Lp x L]
//             products, into ab [2, d, Lr, Lp] (columns past L zero);
//   tri_out   per (i, j) and view: LayerNorm over c of ab[r, :, i, j],
//             the out-projection, the gate's projection of x_r[i, j], the
//             sum over r and the add of attended; writes out [Lr, L, d].
// The single-view form (the same three launchers with `view` 0 or 1) runs
// the same three kernels on one view r = `view` with its own weights
// (act_w [d, 5d], act_b [5d], out_w [d, d], out_b [d]), for AlphaFold2's
// triangle multiplications, which apply the two views one after the other:
// view 0 is its "outgoing" update (sum_k a_ik b_jk), view 1 its "incoming"
// one (sum_k a_ki b_kj). Its gate reads x_0[i, j] = e[i, j] for either
// view, as AlphaFold2's does, and `residual` (the un-normalised pair
// tensor) takes attended's place:
//   out[i, j] = residual[i, j] + (LN(ab[i, j]) . Wo + bo)
//               * sigmoid(e[i, j] . Wg + bg).
// The two-view instances are the same code with kOne false: their
// arithmetic and launches are as they were.
// No operand is permuted outside a kernel: every layout above is read as
// the kernels want it. The x views are read by index from `edge` and
// `whole` (x_1's rows are strided by L d, each row's d values contiguous).
//
// Bounds on an H100 at the release shapes (L = Lr = 256, d = 128), per call,
// each input counted once and each output once (chip_smoke.triangle_cost):
// tri_proj does 17.2 GFLOP of products against 168.6 MB (the edge read,
// act_row and act_col written), tri_mm 8.6 GFLOP against 201.3 MB (both
// operands read, ab written), tri_out 8.6 GFLOP against 168.6 MB (ab, the
// edge and attended read, out written). float32 accuracy on the TF32
// tensor cores takes three passes (3xTF32, tf32_mma.cuh), so the bounds
// are max(3 x products / 495 TFLOP/s, bytes / 3.35 TB/s) = 0.104 ms
// (products), 0.060 ms (bytes) and 0.052 ms (products). Every
// intermediate is float32: ab's LayerNorm needs it, and one TF32 pass is
// the benchmark's failing precision control. The einsum route this
// replaces wrote and read ~1 GB a call, most of it in strided passes.
//
// Design, common to the three: m16n8k8 TF32 mma.sync, each float operand
// split into a TF32 high and low part as it leaves shared memory and
// multiplied in three passes (mma3); operands staged by cp.async,
// zero-filled past the edges, so every L is taken.
//   tri_proj is persistent, one block of 16 warps an SM: a block keeps one
//     (view, operand) weight block [d x 2d] (value and gate columns side by
//     side, 135 KB) resident in shared memory and walks over tiles of 64
//     positions of one row, double buffering the x tiles; each warp owns
//     the value and gate columns of the same 16 channels, so the GLU is
//     taken in registers, and the output goes through shared memory to
//     256-byte runs of k.
//   tri_mm is a 128 x 128 tile of 8 warps, 32-deep three-stage cp.async
//     pipeline per (r, c), grid over (j tile, i tile, r c), two blocks an
//     SM.
//   tri_out takes one row i and 64 columns j, 8 warps, two blocks an SM:
//     ab's [d x 64] tile (256-byte runs of j) is normalised in place in
//     shared memory, the gate's and the out-projection's weights stream in
//     32-deep slices, the gate waits in shared memory while the
//     out-projection runs, and the two views' products are summed in
//     registers before the one store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "tf32_mma.cuh"  // cp.async, mma3, split, quad_sum

namespace {

constexpr int kD = 128;            // the edge width d
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 64;           // Lp = L rounded up to a multiple of this
constexpr int kMaxDevices = 64;    // devices whose attribute state is kept

// Row strides of staged x rows [.][kD], in elements: 4 mod 32 words, so the
// A-fragment loads of a warp (rows g, columns t) fall on distinct banks.
template <typename T> struct XStride;
template <> struct XStride<float> { static constexpr int v = kD + 4; };
template <> struct XStride<__nv_bfloat16> { static constexpr int v = kD + 8; };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
  const float2 v = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(p));
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// cp.async rows p = 0..n-1 of a [n][kD] tile of T into s (row stride
// XStride<T>), row p read from src + p * ps elements; rows p >= n_valid are
// zero-filled (`safe` is a valid address for their empty copies).
template <typename T, int NT = kThreads>
__device__ __forceinline__ void stage_rows(T* s, const T* src, size_t ps,
                                           int n, int n_valid,
                                           const T* safe) {
  constexpr int PER16 = 16 / (int)sizeof(T);
  constexpr int CH = kD / PER16;  // 16-byte copies a row
  constexpr int S = XStride<T>::v;
  for (int e = threadIdx.x; e < n * CH; e += NT) {
    const int p = e / CH, q = e % CH;
    const bool ok = p < n_valid;
    cp_async16(s + p * S + q * PER16, ok ? src + p * ps + q * PER16 : safe,
               ok);
  }
}

// A fragment (rows g, g + 8; columns t, t + 4) of the row-major 16 x 8
// tile at a (row stride S), split for 3xTF32.
template <int S, typename T>
__device__ __forceinline__ void frag_a(const T* a, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float v[4] = {to_float(a[g * S + t]), to_float(a[(g + 8) * S + t]),
                      to_float(a[g * S + t + 4]),
                      to_float(a[(g + 8) * S + t + 4])};
#pragma unroll
  for (int j = 0; j < 4; ++j) split(v[j], hi[j], lo[j]);
}

// The same fragment of a tile stored column-major: element (m, k) at
// a[k * S + m].
template <int S>
__device__ __forceinline__ void frag_a_t(const float* a, int g, int t,
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const float v[4] = {a[t * S + g], a[t * S + g + 8], a[(t + 4) * S + g],
                      a[(t + 4) * S + g + 8]};
#pragma unroll
  for (int j = 0; j < 4; ++j) split(v[j], hi[j], lo[j]);
}

// B fragment (depth t, t + 4; column g) of an 8 x 8 tile stored [k][n]
// (row stride S).
template <int S>
__device__ __forceinline__ void frag_b_kn(const float* b, int g, int t,
                                          uint32_t (&hi)[2],
                                          uint32_t (&lo)[2]) {
  split(b[t * S + g], hi[0], lo[0]);
  split(b[(t + 4) * S + g], hi[1], lo[1]);
}

// The same fragment of a tile stored [n][k] (depth contiguous).
template <int S>
__device__ __forceinline__ void frag_b_nk(const float* b, int g, int t,
                                          uint32_t (&hi)[2],
                                          uint32_t (&lo)[2]) {
  split(b[g * S + t], hi[0], lo[0]);
  split(b[g * S + t + 4], hi[1], lo[1]);
}

// Sets the kernel's dynamic shared memory on its first launch on each
// device (`ready` holds one bit a device).
template <typename K>
cudaError_t prepare(K kernel, size_t smem, int device,
                    std::atomic<unsigned long long>& ready) {
  const unsigned long long bit = 1ull << device;
  if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
  return err;
}

// ---- tri_proj ---------------------------------------------------------------
constexpr int kKT = 64;                 // positions k a tile
constexpr int kPW = 2 * kD + 8;         // resident weights [kD][2 kD]: 8 mod 32
constexpr int kOS = kKT + 4;            // output tile [c][k]: 4 mod 32
constexpr size_t kProjX = (size_t)kKT * (kD + 4) * 4;  // a float x tile
constexpr size_t kProjO = (size_t)kD * kOS * 4;        // the output tile
constexpr size_t kProjBuf = kProjX > kProjO ? kProjX : kProjO;
constexpr size_t kProjSmem = (size_t)kD * kPW * 4 + 2 * kProjBuf;
static_assert(kProjSmem <= 232448, "fits one block");

// Block (x, 2 r + kind): kind 0 writes act_row (rows i of the rank, view
// r), kind 1 act_col (every row j, view r); tiles tau = blockIdx.x,
// blockIdx.x + gridDim.x, ... of (row, 64 positions). 16 warps, 2 (rows,
// 32 each) x 8 (channels, 16 each): the one block of an SM keeps four
// warps on each tensor-core partition.
// kOne: the single-view form, block (x, kind) of view `view`, whose
// weights and outputs have no view axis.
constexpr int kProjThreads = 512;
template <typename T, bool kOne>
__global__ void __launch_bounds__(kProjThreads, 1)
tri_proj_kernel(const T* __restrict__ edge, const T* __restrict__ whole,
                const float* __restrict__ w, const float* __restrict__ bias,
                const float* __restrict__ mask, int key_mask,
                float* __restrict__ act_row, float* __restrict__ act_col,
                int Lr, int L, int Lp, int q0, int view) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);
  char* bufs = reinterpret_cast<char*>(sW + kD * kPW);
  constexpr int XS = XStride<T>::v;
  constexpr int kViews = kOne ? 1 : 2;
  const int r = kOne ? view : (int)(blockIdx.y >> 1);  // the view x is read in
  const int kind = kOne ? (int)blockIdx.y : (int)(blockIdx.y & 1);
  const int slot = kOne ? 0 : r;  // its place in the weights and outputs
  const int rows = kind ? L : Lr;
  const int nk = Lp / kKT;
  const int n_tiles = rows * nk;
  if ((int)blockIdx.x >= n_tiles) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // rows 32 wm, channels 16 wn
  const size_t Ld = (size_t)L * kD;
  // act_w[:, r] columns: the GLU's values, then its gates
  const int v_col = kind * kD, g_col = 2 * kD + kind * kD;
  for (int e = tid; e < kD * (2 * kD / 4); e += kProjThreads) {
    const int dd = e / (2 * kD / 4), q = e % (2 * kD / 4);
    const int col = q < kD / 4 ? v_col + 4 * q : g_col + 4 * (q - kD / 4);
    cp_async16(sW + dd * kPW + 4 * q,
               w + ((size_t)dd * kViews + slot) * (5 * kD) + col, true);
  }
  auto fetch = [&](int tau, int buf) {
    const int rho = tau / nk, k0 = (tau % nk) * kKT;
    const int grow = kind ? rho : q0 + rho;  // the row in the window
    const int n_valid = grow < L ? min(kKT, L - k0) : 0;
    const T* src;
    size_t ps;
    if (r == 0) {
      src = (kind ? whole : edge) + (size_t)rho * Ld + (size_t)k0 * kD;
      ps = kD;
    } else {
      src = n_valid > 0 ? whole + (size_t)k0 * Ld + (size_t)grow * kD
                        : whole;
      ps = Ld;
    }
    stage_rows<T, kProjThreads>(reinterpret_cast<T*>(bufs + buf * kProjBuf),
                                src, ps, kKT, n_valid, whole);
    cp_async_commit();
  };

  fetch(blockIdx.x, 0);  // one group with the weights
  const float* bv = bias + slot * 5 * kD + v_col;
  const float* bg = bias + slot * 5 * kD + g_col;
  int it = 0;
  for (int tau = blockIdx.x; tau < n_tiles; tau += gridDim.x, ++it) {
    const int buf = it & 1;
    if (tau + (int)gridDim.x < n_tiles) {
      fetch(tau + gridDim.x, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sX = reinterpret_cast<const T*>(bufs + buf * kProjBuf);
    float acc[2][4][4];  // [row tile][2 value tiles, 2 gate tiles]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < kD / 8; ++ks) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        frag_a<XS>(sX + (32 * wm + 16 * mt) * XS + 8 * ks, g, t, ah[mt],
                   al[mt]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n0 = (nt < 2 ? 0 : kD) + 16 * wn + 8 * (nt & 1);
        uint32_t bh[2], bl[2];
        frag_b_kn<kPW>(sW + 8 * ks * kPW + n0, g, t, bh, bl);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma3(acc[mt][nt], ah[mt], al[mt], bh, bl);
      }
    }
    __syncthreads();  // x is read: its buffer takes the output tile
    float* sO = reinterpret_cast<float*>(bufs + buf * kProjBuf);
    const int rho = tau / nk, k0 = (tau % nk) * kKT;
    const int grow = kind ? rho : q0 + rho;
    const float mrow = grow < L ? mask[grow] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 32 * wm + 16 * mt + g + 8 * (e >> 1);
        const int k = k0 + p;
        float m = k < L ? mrow : 0.f;
        if (key_mask && kind == 0 && k < L) m *= mask[k];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c = 16 * wn + 8 * nt + 2 * t + (e & 1);
          const float v = (acc[mt][nt][e] + bv[c]) *
                          sigmoid(acc[mt][nt + 2][e] + bg[c]);
          sO[c * kOS + p] = v * m;
        }
      }
    __syncthreads();
    float* dst = (kind ? act_col : act_row) +
                 ((size_t)slot * kD * rows + rho) * Lp + k0;
    for (int e = tid; e < kD * (kKT / 4); e += kProjThreads) {
      const int c = e / (kKT / 4), q = e % (kKT / 4);
      *reinterpret_cast<float4*>(dst + (size_t)c * rows * Lp + 4 * q) =
          *reinterpret_cast<const float4*>(sO + c * kOS + 4 * q);
    }
    __syncthreads();  // the next fetch overwrites this buffer
  }
}

// ---- tri_mm -----------------------------------------------------------------
constexpr int kMB = 128, kNB = 128, kKB = 32;  // block tile and depth step
constexpr int kMS = kKB + 4;                   // staged rows: 4 mod 32
constexpr int kStages = 3;
constexpr size_t kMmStage = (size_t)(kMB + kNB) * kMS * 4;
constexpr size_t kMmSmem = kStages * kMmStage;

// Block (j tile, i tile, r d + c): ab[r, c, i, j] for 128 x 128 (i, j).
// Warps 2 (rows, 64 each) x 4 (columns, 32 each). Two blocks an SM (110
// KB of shared memory and at most 128 registers each).
__global__ void __launch_bounds__(kThreads, 2)
tri_mm_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ out, int Lr, int L, int Lp) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n0 = blockIdx.x * kNB, m0 = blockIdx.y * kMB;
  const size_t batch = blockIdx.z;
  const float* A = a + batch * Lr * Lp;
  const float* B = b + batch * L * Lp;
  float* C = out + batch * Lr * Lp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  auto fetch = [&](int kt, int st) {
    float* sA = smem + st * (kMmStage / 4);
    float* sB = sA + kMB * kMS;
    const int k0 = kt * kKB;
    for (int e = tid; e < kMB * (kKB / 4); e += kThreads) {
      const int row = e / (kKB / 4), q = e % (kKB / 4);
      bool ok = m0 + row < Lr;
      cp_async16(sA + row * kMS + 4 * q,
                 ok ? A + (size_t)(m0 + row) * Lp + k0 + 4 * q : A, ok);
      ok = n0 + row < L;
      cp_async16(sB + row * kMS + 4 * q,
                 ok ? B + (size_t)(n0 + row) * Lp + k0 + 4 * q : B, ok);
    }
    cp_async_commit();
  };
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const int nkt = Lp / kKB;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt) fetch(s, s);
    else cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step kt is in; step kt - 1's stage is free
    if (kt + kStages - 1 < nkt) fetch(kt + kStages - 1, (kt + kStages - 1) % kStages);
    else cp_async_commit();
    const float* sA = smem + (kt % kStages) * (kMmStage / 4);
    const float* sB = sA + kMB * kMS;
#pragma unroll
    for (int ks = 0; ks < kKB / 8; ++ks) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        frag_b_nk<kMS>(sB + (32 * wn + 8 * nt) * kMS + 8 * ks, g, t, bh[nt],
                       bl[nt]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t ah[4], al[4];
        frag_a<kMS>(sA + (64 * wm + 16 * mt) * kMS + 8 * ks, g, t, ah, al);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma3(acc[mt][nt], ah, al, bh[nt], bl[nt]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = m0 + 64 * wm + 16 * mt + g + 8 * h;
      if (i >= Lr) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int j = n0 + 32 * wn + 8 * nt + 2 * t;
        if (j < Lp)
          store2(C + (size_t)i * Lp + j, acc[mt][nt][2 * h],
                 acc[mt][nt][2 * h + 1]);
      }
    }
}

// ---- tri_out ----------------------------------------------------------------
constexpr int kJT = 64;             // columns j a block (one row i)
constexpr int kAS = kJT + 8;        // ab tile [c][j]: 8 mod 32
constexpr int kSK = 32;             // depth of a weight slice
constexpr int kOW = kD + 8;         // weight slice [kSK][kD]: 8 mod 32
constexpr size_t kOutAB = (size_t)kD * kAS * 4;
constexpr size_t kOutX = (size_t)kJT * (kD + 4) * 4;
constexpr size_t kOutW = (size_t)kSK * kOW * 4;
constexpr size_t kOutSmem = kOutAB + kOutX + 2 * kOutW;
constexpr int kSlices = 2 * kD / kSK;  // the gate's, then the out-projection's
static_assert(kOutX >= (size_t)32 * kThreads * 4, "the gate fits x's place");
static_assert(2 * kOutSmem <= 228 * 1024 - 2 * 1024, "two blocks an SM");

// acc += a 32-deep slice of [32 rows x 32 channels]: A rows from `a`
// (row-major, row stride S, at the slice's depth), B from the weight slice
// `w` [kSK][kOW] at the warp's channels.
template <int S, typename T>
__device__ __forceinline__ void out_slice(float (&acc)[2][4][4], const T* a,
                                          const float* w, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < kSK / 8; ++ks) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      frag_a<S>(a + 16 * mt * S + 8 * ks, g, t, ah[mt], al[mt]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t bh[2], bl[2];
      frag_b_kn<kOW>(w + 8 * ks * kOW + 8 * nt, g, t, bh, bl);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma3(acc[mt][nt], ah[mt], al[mt], bh, bl);
    }
  }
}

// The same with A stored column-major (element (row, depth) at
// a[depth * S + row]): the normalised ab tile.
template <int S>
__device__ __forceinline__ void out_slice_t(float (&acc)[2][4][4],
                                            const float* a, const float* w,
                                            int g, int t) {
#pragma unroll
  for (int ks = 0; ks < kSK / 8; ++ks) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      frag_a_t<S>(a + 8 * ks * S + 16 * mt, g, t, ah[mt], al[mt]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t bh[2], bl[2];
      frag_b_kn<kOW>(w + 8 * ks * kOW + 8 * nt, g, t, bh, bl);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma3(acc[mt][nt], ah[mt], al[mt], bh, bl);
    }
  }
}

// Block (j tile, i). Warps 2 (columns j, 32 each) x 4 (channels, 32 each).
// Two blocks an SM (105 KB of shared memory and at most 128 registers
// each), so that one block's loads overlap the other's products. kOne: the
// single-view form, one pass with x_0's gate and weights without a view
// axis.
template <typename T, bool kOne>
__global__ void __launch_bounds__(kThreads, 2)
tri_out_kernel(const float* __restrict__ ab, const T* __restrict__ edge,
               const T* __restrict__ whole, const T* __restrict__ attended,
               const float* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ wo, const float* __restrict__ bo,
               T* __restrict__ out, int Lr, int L, int Lp, int q0) {
  extern __shared__ float4 smem4[];
  float* sAB = reinterpret_cast<float*>(smem4);
  T* sX = reinterpret_cast<T*>(sAB + kD * kAS);
  float* sWb = reinterpret_cast<float*>(reinterpret_cast<char*>(sX) + kOutX);
  float* sGate = reinterpret_cast<float*>(sX);  // [32][kThreads], in x's place
  constexpr int XS = XStride<T>::v;
  const int j0 = blockIdx.x * kJT, i = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const size_t Ld = (size_t)L * kD;
  const int n_cols = min(kJT, L - j0);

  float sum[2][4][4];  // the two views' gated products, summed over r
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[mt][nt][e] = 0.f;
  constexpr int kViews = kOne ? 1 : 2;
  for (int r = 0; r < kViews; ++r) {
    // slice s < 4: act_w[32 s.., r, 4d:5d] (the gate); s >= 4: out_proj_w[r]
    auto fetch_w = [&](int s, int buf) {
      float* dst = sWb + buf * (kOutW / 4);
      for (int e = tid; e < kSK * (kD / 4); e += kThreads) {
        const int dd = e / (kD / 4), q = e % (kD / 4);
        const int row = (s % (kD / kSK)) * kSK + dd;
        const float* src =
            s < kD / kSK ? w + ((size_t)row * kViews + r) * (5 * kD) + 4 * kD
                         : wo + ((size_t)r * kD + row) * kD;
        cp_async16(dst + dd * kOW + 4 * q, src + 4 * q, true);
      }
      cp_async_commit();
    };
    for (int e = tid; e < kD * (kJT / 4); e += kThreads) {
      const int c = e / (kJT / 4), q = e % (kJT / 4);
      cp_async16(sAB + c * kAS + 4 * q,
                 ab + (((size_t)r * kD + c) * Lr + i) * Lp + j0 + 4 * q, true);
    }
    if (r == 0) {
      stage_rows<T>(sX, edge + ((size_t)i * L + j0) * kD, kD, kJT, n_cols,
                    edge);
    } else {
      const bool real = q0 + i < L;  // a pad row's column view is zeros
      stage_rows<T>(sX, real ? whole + j0 * Ld + (size_t)(q0 + i) * kD : whole,
                    Ld, kJT, real ? n_cols : 0, whole);
    }
    fetch_w(0, 0);  // one group with ab and x

    float acc[2][4][4];  // the gate's product, then the out-projection's
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    for (int s = 0; s < kSlices; ++s) {
      if (s + 1 < kSlices) {
        fetch_w(s + 1, (s + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (s == 0) {
        // LayerNorm over c of each column j, in place: 4 threads a column
        const int j = tid >> 2, part = tid & 3;
        float mean = 0.f;
#pragma unroll 8
        for (int q = 0; q < kD / 4; ++q) mean += sAB[(4 * q + part) * kAS + j];
        mean = quad_sum(mean) * (1.f / kD);
        float var = 0.f;
#pragma unroll 8
        for (int q = 0; q < kD / 4; ++q) {
          const float dv = sAB[(4 * q + part) * kAS + j] - mean;
          var += dv * dv;
        }
        const float rstd = rsqrtf(quad_sum(var) * (1.f / kD) + 1e-5f);
#pragma unroll 8
        for (int q = 0; q < kD / 4; ++q) {
          float* p = sAB + (4 * q + part) * kAS + j;
          *p = (*p - mean) * rstd;
        }
        // read by the out-projection's slices, past a barrier
      }
      if (s == kD / kSK) {
        // the gate is complete and x read by every warp (the barrier
        // above): the gate waits in x's place, each thread's own values
        const float* bgr = bias + r * 5 * kD + 4 * kD;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = 32 * wn + 8 * nt + 2 * t + (e & 1);
              sGate[((mt * 4 + nt) * 4 + e) * kThreads + tid] =
                  sigmoid(acc[mt][nt][e] + bgr[c]);
              acc[mt][nt][e] = 0.f;
            }
      }
      const float* sW = sWb + (s & 1) * (kOutW / 4);
      const int kb = (s % (kD / kSK)) * kSK;  // depth of this slice
      if (s < kD / kSK)
        out_slice<XS>(acc, sX + (32 * wm) * XS + kb, sW + 32 * wn, g, t);
      else
        out_slice_t<kAS>(acc, sAB + kb * kAS + 32 * wm, sW + 32 * wn, g, t);
      __syncthreads();  // the next fetch overwrites this slice's buffer
    }
    const float* bor = bo + r * kD;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 32 * wn + 8 * nt + 2 * t + (e & 1);
          sum[mt][nt][e] +=
              (acc[mt][nt][e] + bor[c]) *
              sGate[((mt * 4 + nt) * 4 + e) * kThreads + tid];
        }
    __syncthreads();  // the next view's x overwrites the gate
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int jj = 32 * wm + 16 * mt + g + 8 * h;
      if (jj >= n_cols) continue;
      const size_t row = ((size_t)i * L + j0 + jj) * kD;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = 32 * wn + 8 * nt + 2 * t;
        float a0, a1;
        load2(attended + row + c, a0, a1);
        store2(out + row + c, a0 + sum[mt][nt][2 * h],
               a1 + sum[mt][nt][2 * h + 1]);
      }
    }
}

// Runs `body` with `device` current, then gives the caller its device back.
template <typename F>
int on_device(int device, F body) {
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidValue;
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  err = body();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

bool bad_shape(int Lr, int L, int Lp, int q0) {
  return Lr < 1 || L < 1 || Lr > L || q0 < 0 || Lp % kPad != 0 || Lp < L ||
         Lp - L >= kPad || L > 65535;
}

template <typename T, bool kOne>
cudaError_t launch_proj(const void* edge, const void* whole, const float* w,
                        const float* bias, const float* mask, int key_mask,
                        float* act_row, float* act_col, int Lr, int L, int Lp,
                        int q0, int view, int device, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err =
      prepare(tri_proj_kernel<T, kOne>, kProjSmem, device, ready);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // one block an SM over the (view, operand) pairs: four, or the one
  // view's two
  const int pairs = kOne ? 2 : 4;
  const dim3 grid((sms + pairs - 1) / pairs, pairs);
  tri_proj_kernel<T, kOne><<<grid, kProjThreads, kProjSmem, stream>>>(
      static_cast<const T*>(edge), static_cast<const T*>(whole), w, bias,
      mask, key_mask, act_row, act_col, Lr, L, Lp, q0, view);
  return cudaGetLastError();
}

// ab for `views` views: grid z over (view, channel)
cudaError_t launch_mm(const float* act_row, const float* act_col, float* ab,
                      int Lr, int L, int Lp, int views, int device,
                      cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t err = prepare(tri_mm_kernel, kMmSmem, device, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lp + kNB - 1) / kNB, (Lr + kMB - 1) / kMB, views * kD);
  tri_mm_kernel<<<grid, kThreads, kMmSmem, stream>>>(act_row, act_col, ab,
                                                      Lr, L, Lp);
  return cudaGetLastError();
}

template <typename T, bool kOne>
cudaError_t launch_out(const float* ab, const void* edge, const void* whole,
                       const void* attended, const float* w,
                       const float* bias, const float* wo, const float* bo,
                       void* out, int Lr, int L, int Lp, int q0, int device,
                       cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t err =
      prepare(tri_out_kernel<T, kOne>, kOutSmem, device, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(Lp / kJT, Lr);
  tri_out_kernel<T, kOne><<<grid, kThreads, kOutSmem, stream>>>(
      ab, static_cast<const T*>(edge), static_cast<const T*>(whole),
      static_cast<const T*>(attended), w, bias, wo, bo, static_cast<T*>(out),
      Lr, L, Lp, q0);
  return cudaGetLastError();
}

}  // namespace

// Every launcher runs on `stream` and returns cudaGetLastError() (0 = the
// launch was accepted); the caller's current device is left as it was.
// Layouts (all contiguous, 16-byte aligned; d = 128; Lp = L rounded up to a
// multiple of 64; Lr <= L; a rank's rows are [q0, q0 + Lr) of the window,
// rows past L its pad rows): edge [Lr, L, d] and whole [L, L, d] the
// normalised edge (the same pointer outside sequence parallelism),
// attended and out [Lr, L, d], all float32 (bf16 = 0) or bfloat16
// (bf16 = 1); act_w [d, 2, 5d], act_b [2, 5d], out_w [2, d, d], out_b
// [2, d], mask [L] float32; act_row [2, d, Lr, Lp], act_col [2, d, L, Lp]
// and ab [2, d, Lr, Lp] float32. key_mask = 1 also masks act_row's summed
// index k (pad_safe). `view` -1 runs both views; 0 or 1 the single-view
// form on that view, whose layouts have no view axis (act_w [d, 5d], act_b
// [5d], out_w [d, d], out_b [d]; act_row [d, Lr, Lp], act_col [d, L, Lp],
// ab [d, Lr, Lp]), the residual in attended's place (tri_mm takes the
// number of views, 2 or 1). Anything else is refused
// (cudaErrorInvalidValue).
extern "C" int tri_proj(const void* edge, const void* whole, const float* w,
                        const float* bias, const float* mask, int key_mask,
                        float* act_row, float* act_col, int Lr, int L, int Lp,
                        int q0, int view, int d, int bf16, int device,
                        cudaStream_t stream) {
  if (d != kD || bad_shape(Lr, L, Lp, q0) || view < -1 || view > 1)
    return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    if (view < 0)
      return bf16 ? launch_proj<__nv_bfloat16, false>(
                        edge, whole, w, bias, mask, key_mask, act_row,
                        act_col, Lr, L, Lp, q0, 0, device, stream)
                  : launch_proj<float, false>(edge, whole, w, bias, mask,
                                              key_mask, act_row, act_col, Lr,
                                              L, Lp, q0, 0, device, stream);
    return bf16 ? launch_proj<__nv_bfloat16, true>(
                      edge, whole, w, bias, mask, key_mask, act_row, act_col,
                      Lr, L, Lp, q0, view, device, stream)
                : launch_proj<float, true>(edge, whole, w, bias, mask,
                                           key_mask, act_row, act_col, Lr, L,
                                           Lp, q0, view, device, stream);
  });
}

extern "C" int tri_mm(const float* act_row, const float* act_col, float* ab,
                      int Lr, int L, int Lp, int views, int d, int device,
                      cudaStream_t stream) {
  if (d != kD || bad_shape(Lr, L, Lp, 0) || (views != 1 && views != 2))
    return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    return launch_mm(act_row, act_col, ab, Lr, L, Lp, views, device, stream);
  });
}

extern "C" int tri_out(const float* ab, const void* edge, const void* whole,
                       const void* attended, const float* w,
                       const float* bias, const float* out_w,
                       const float* out_b, void* out, int Lr, int L, int Lp,
                       int q0, int view, int d, int bf16, int device,
                       cudaStream_t stream) {
  if (d != kD || bad_shape(Lr, L, Lp, q0) || view < -1 || view > 1)
    return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    if (view < 0)
      return bf16 ? launch_out<__nv_bfloat16, false>(
                        ab, edge, whole, attended, w, bias, out_w, out_b, out,
                        Lr, L, Lp, q0, device, stream)
                  : launch_out<float, false>(ab, edge, whole, attended, w,
                                             bias, out_w, out_b, out, Lr, L,
                                             Lp, q0, device, stream);
    return bf16 ? launch_out<__nv_bfloat16, true>(
                      ab, edge, whole, attended, w, bias, out_w, out_b, out,
                      Lr, L, Lp, q0, device, stream)
                : launch_out<float, true>(ab, edge, whole, attended, w, bias,
                                          out_w, out_b, out, Lr, L, Lp, q0,
                                          device, stream);
  });
}

extern "C" const char* geom_triangle_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
