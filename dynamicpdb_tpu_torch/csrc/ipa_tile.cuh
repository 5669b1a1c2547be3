// The tile machinery shared by the four IPA kernels on the tensor cores:
// the forward (ipa_attention_fwd.cu) and the three kernels of the backward
// (ipa_attention_bwd.cu: dq, dk/dv, pair).
//
// Rectangular calls. A block of Nq query rows meets Nk keys: the query
// side (q, q_pts, g_o, g_opt, g_pair, lse, D, the query mask and every
// output but dk/dv) has Nq rows, the key side (k, v, their points and the
// key mask) Nk, and bias [Nq, Nk, H] and pair_z [Nq, Nk, Dz] have rows of
// Nk keys. Sequence parallelism gives each rank Nq = N / seq rows against
// all N keys; the square call passes Nq = Nk = N and one mask twice, and
// computes what it computed before the split. Indexing alone tells the two
// sides apart (atq, atk); no arithmetic depends on it.
//
// Row-stationary layout (the forward, dq and pair kernels): a block owns 32
// query rows of one (frame, head) and meets the keys 16 at a time: the
// forward and dq walk every key of the (frame, head), the pair kernel one
// key step of every (head, frame).
//
// Warps. A block has eight warps, four per 16-row query tile. The four
// warps of a tile split the C channels in quarters (of 64 channels, zero
// past C, for C up to 256; of 8 for C up to 32):
// each computes its quarter of every C-wide product on the tensor cores
// (q.k^T, and in the backward g_o.v^T), the quarters are swapped through
// shared memory ("exchange", one named barrier per tile and step), and all
// four then hold the same logits and probabilities, from which each
// accumulates its quarter of the C-wide output (p.v, dl.k). The small
// products are shared out: quarter 0 takes the point distances, quarter 1
// the value points, quarters 2 and 3 the pair term of the tile's first and
// last eight rows, each fetching, reading and refetching its own pair_z
// rows (single-buffered, a warp barrier, no block barrier). Two warps on
// each of the SM's four schedulers hide each other's latencies. The
// backward's recompute of a tile (tile_products, tile_a_dl) is one piece
// of code for dq and pair.
//
// Key-stationary layout (dk/dv): the same warps and exchange turned around.
// A block owns 32 keys, two tiles of 16 with four channel-quarter warps
// each, and meets the query rows 16 at a time; its products are the
// transposed tiles (keys x rows: k.q^T, v.g_o^T) with keys as the A
// operand, in the pass order of mma3t, so that each element is formed from
// the same products in the same order as in the row-stationary kernels.
//
// Logits. logit_ij = c_qk q_i.k_j + c_b bias_ijh - 0.5 w_h dist_ij
// + inf (m_i m_j - 1), dist_ij = |qp_i|^2 + |kp_j|^2 - 2 qp_i.kp_j, the
// terms added in that order by every kernel (ipa_logit), q.k_j and
// qp_i.kp_j computed by the same code (qk_partial, point_dist, row_norms,
// norms16), so all four kernels see the same logit. A pad row's logits sit
// near -1e5, where float32 steps by 2^-7: any other order would move a_ij
// there by whole steps.
//
// Key tiles. Each step's k and v rows (C floats), key points, key mask and
// bias tile [32 rows][16 keys] arrive by cp.async, double-buffered across
// the block, one block barrier per step. The bias is [Nq, Nk, H]: one float
// of each 32-byte sector belongs to this head. The head is the fastest grid
// axis of the forward and dq, so the H blocks of one (query tile, frame)
// run together and the other seven floats of each sector are read from L2
// by the neighbouring heads' blocks; the same holds for pair_z, which all
// F H blocks of a query tile read: it crosses device memory once per call.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace ipa_tc {

constexpr int kTiles = 2;             // 16-row query tiles per block
constexpr int kWarps = 4 * kTiles;    // four channel quarters per tile
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kTiles;    // query rows per block
constexpr int kKeys = 16;             // keys per step: 2 score n-tiles
constexpr int kMaxC = 256;            // C <= 256: CQ <= 64 per warp
constexpr int kMaxNT = kMaxC / 32;    // 8-channel tiles per warp
constexpr int kMaxP3q = 32;           // Pq <= 10: 4 k-steps of qp.kp
constexpr int kMaxP3v = 48;           // Pv <= 16: 6 n-tiles of p.vp
constexpr int kMaxDz = 32;            // 8 pair channels per lane
constexpr int kBS = kKeys + 8;        // bias tile row stride: 8 mod 32
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90
constexpr float kNegInit = -1e30f;    // running-max start, as the TPU kernel

constexpr int kKQ = kMaxP3q / 8;      // 8-deep steps of qp.kp^T
constexpr int kNV = kMaxP3v / 8;      // 8-column tiles of p.vp
constexpr int kP3qs = kMaxP3q + 4;    // row strides of the point tiles
constexpr int kP3vs = kMaxP3v + 4;
constexpr int kPZs = kKeys * kMaxDz + 4;  // a pair_z tile row: [key][32]

// Every loop of the tile code runs to a compile-time bound, so that nothing
// in it branches: the point columns past Pq*3 and Pv*3, the pair channels
// past Dz and the channels past C (up to 32 NT, the kernel's template
// argument: 8 for C <= 256, 1 for C <= 32) are zeros in shared memory and
// in the row fragments, and add nothing. Every stride read by fragment
// loads is 4 mod 8 floats, so the 32 lanes' loads A[g][t] (rows g, columns
// t) and B[2t][g] fall on 32 distinct banks.
struct Layout {
  int Nq, Nk;  // query rows and keys (equal in the square call)
  int H, C, P3q, P3v, Dz;
  int CQ;      // channels per warp quarter: 8 NT
  int Cs;      // row stride of the k and v tiles: 32 NT + 4
  int pz_vec;  // Dz == 32 and pair_z 16-byte aligned: 16-byte copies
  float c_qk, c_b, inf;
};

// NT (8-channel tiles per warp) of the kernel instance that takes C
inline int tiles_for(int C) { return C <= 32 ? 1 : kMaxNT; }

inline Layout make_layout(int Nq, int Nk, int H, int C, int P3q, int P3v,
                          int Dz, float c_qk, float c_b, float inf,
                          bool pz_aligned) {
  Layout L;
  L.Nq = Nq, L.Nk = Nk, L.H = H, L.C = C, L.P3q = P3q, L.P3v = P3v, L.Dz = Dz;
  L.CQ = 8 * tiles_for(C);
  L.Cs = 4 * L.CQ + 4;
  L.pz_vec = Dz == kMaxDz && pz_aligned;
  L.c_qk = c_qk, L.c_b = c_b, L.inf = inf;
  return L;
}

inline bool layout_ok(int Nq, int Nk, int H, int C, int P3q, int P3v,
                      int Dz) {
  return Nq >= 1 && Nk >= 1 && H >= 1 && C >= 4 && C % 4 == 0 && C <= kMaxC &&
         P3q >= 1 && P3q <= kMaxP3q && P3v >= 1 && P3v <= kMaxP3v &&
         Dz >= 1 && Dz <= kMaxDz && H <= 65535;
}

// Bump allocator over dynamic shared memory; with a null base it only
// counts, so the host sizes a launch with the code the kernel carves with.
// Every buffer starts on a 16-byte boundary.
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

// One key step's operands; two of them, one after the other, double-buffer
// the steps. A view computed from the buffer's base (an array of pointers
// indexed at run time would put the carve in local memory).
struct KeyTile {
  float *k, *v;     // [kKeys][Cs]
  float *kp, *vp;   // [kKeys][P3qs], [kKeys][P3vs]
  float *km;        // [kKeys]
  float *bias;      // [kRows][kBS]
};

__host__ __device__ inline KeyTile key_tile(Carver& c, const Layout& L) {
  KeyTile t;
  t.k = c.take((size_t)kKeys * L.Cs);
  t.v = c.take((size_t)kKeys * L.Cs);
  t.kp = c.take((size_t)kKeys * kP3qs);
  t.vp = c.take((size_t)kKeys * kP3vs);
  t.km = c.take(kKeys);
  t.bias = c.take((size_t)kRows * kBS);
  return t;
}

// Exchange slots, each 8 floats a lane ([value][lane]): the quarters of
// q.k^T and g_o.v^T, then the small products.
enum Slot { kQK = 0, kGV = 4, kDist = 8, kGVP, kGPZ, kSlots };
constexpr int kXchFloats = kSlots * 8 * 32;

struct Common {
  float* kt;    // two key tiles of tile_floats each
  size_t tile_floats;
  float* pz;    // [kTiles][16 rows][PZs]: quarters 2 and 3, 8 rows each
  float* ksq;   // [kTiles][kKeys]: |kp|^2 of the step, quarter 0 only
  float* xch;   // [kTiles][kXchFloats]
  __host__ __device__ void carve(Carver& c, const Layout& L) {
    Carver one(nullptr);
    key_tile(one, L);
    tile_floats = one.n;
    kt = c.take(2 * tile_floats);
    pz = c.take((size_t)kTiles * 16 * kPZs);
    ksq = c.take((size_t)kTiles * kKeys);
    xch = c.take((size_t)kTiles * kXchFloats);
  }
  __device__ KeyTile tile(int b, const Layout& L) const {
    Carver c(kt + b * tile_floats);
    return key_tile(c, L);
  }
};

// Calls fn(r, c) for each element (r, c) of [0, R) x [0, W) dealt to this
// thread when the elements go out row-major, `count` threads from `first`
// at a time: two divisions a call, none per element.
template <typename Fn>
__device__ __forceinline__ void deal(int R, int W, int first, int count,
                                     Fn fn) {
  int r = first / W, c = first - r * W;
  const int dr = count / W, dc = count - dr * W;
  while (r < R) {
    fn(r, c);
    r += dr;
    c += dc;
    if (c >= W) {
      c -= W;
      ++r;
    }
  }
}

// element (f, n, h, x) of a [F, rows, H, D] tensor: a query-side tensor
// (q, its points, g_o, g_opt, g_pair, the outputs; rows = Nq) with atq, a
// key-side one (k, v, their points; rows = Nk) with atk
__device__ __forceinline__ size_t at_rows(int rows, int H, int f, int n,
                                          int h, int D, int x) {
  return (((size_t)f * rows + n) * H + h) * D + x;
}
__device__ __forceinline__ size_t atq(const Layout& L, int f, int n, int h,
                                      int D, int x) {
  return at_rows(L.Nq, L.H, f, n, h, D, x);
}
__device__ __forceinline__ size_t atk(const Layout& L, int f, int n, int h,
                                      int D, int x) {
  return at_rows(L.Nk, L.H, f, n, h, D, x);
}

// Zero the padding of both key tiles and of the pair_z tiles once: the
// channels [C, 4 CQ) of k and v, the point columns past P3q and P3v and the
// pair channels past Dz (cp.async never writes them, the products read
// them).
__device__ void zero_padding(const Common& s, const Layout& L) {
  const int pc = 4 * L.CQ - L.C;
  const int pq = kMaxP3q - L.P3q, pv = kMaxP3v - L.P3v, pd = kMaxDz - L.Dz;
  for (int b = 0; b < 2; ++b) {
    const KeyTile t = s.tile(b, L);
    if (pc)
      deal(kKeys, pc, threadIdx.x, kThreads, [&](int r, int x) {
        t.k[r * L.Cs + L.C + x] = 0.f;
        t.v[r * L.Cs + L.C + x] = 0.f;
      });
    if (pq)
      deal(kKeys, pq, threadIdx.x, kThreads,
           [&](int r, int x) { t.kp[r * kP3qs + L.P3q + x] = 0.f; });
    if (pv)
      deal(kKeys, pv, threadIdx.x, kThreads,
           [&](int r, int x) { t.vp[r * kP3vs + L.P3v + x] = 0.f; });
  }
  if (pd)
    deal(kTiles * 16 * kKeys, pd, threadIdx.x, kThreads, [&](int rk, int x) {
      s.pz[(rk / kKeys) * kPZs + (rk % kKeys) * kMaxDz + L.Dz + x] = 0.f;
    });
}

// The key step at j0 into tile t, by the whole block, as one cp.async group
// (committed even when empty, so every thread counts the same groups).
// Keys past Nk and rows past Nq are zero-filled; kmask is the key mask
// [F, Nk].
__device__ void fetch_keys(const KeyTile& t, const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ kp,
                           const float* __restrict__ vp,
                           const float* __restrict__ kmask,
                           const float* __restrict__ bias, int f, int h,
                           int i0, int j0, bool any, const Layout& L) {
  const int tid = threadIdx.x;
  if (any) {
    const int nk = min(kKeys, L.Nk - j0);  // real keys of the step
    deal(kKeys, L.C / 4, tid, kThreads, [&](int r, int c4) {
      const bool ok = r < nk;
      const size_t src = ok ? atk(L, f, j0 + r, h, L.C, 4 * c4) : 0;
      cp_async16(t.k + r * L.Cs + 4 * c4, k + src, ok);
      cp_async16(t.v + r * L.Cs + 4 * c4, v + src, ok);
    });
    deal(kKeys, L.P3q, tid, kThreads, [&](int r, int x) {
      const bool ok = r < nk;
      cp_async4(t.kp + r * kP3qs + x,
                kp + (ok ? atk(L, f, j0 + r, h, L.P3q, x) : 0), ok);
    });
    deal(kKeys, L.P3v, tid, kThreads, [&](int r, int x) {
      const bool ok = r < nk;
      cp_async4(t.vp + r * kP3vs + x,
                vp + (ok ? atk(L, f, j0 + r, h, L.P3v, x) : 0), ok);
    });
    if (tid < kKeys) {
      const bool ok = tid < nk;
      cp_async4(t.km + tid, kmask + (ok ? (size_t)f * L.Nk + j0 + tid : 0),
                ok);
    }
    for (int e = tid; e < kRows * kKeys; e += kThreads) {
      const int r = e / kKeys, c = e % kKeys, i = i0 + r;
      const bool ok = i < L.Nq && c < nk;
      cp_async4(t.bias + r * kBS + c,
                bias + (ok ? ((size_t)i * L.Nk + j0 + c) * L.H + h : 0), ok);
    }
  }
  cp_async_commit();
}

// The block's rows i0.. i0 + 31 of the (f, h) rows of a query-side
// [F, Nq, H, D] tensor into dst [kRows][stride], columns [0, width) with
// zeros past D and past Nq, by the whole block; 4-byte cp.async, not
// committed (the caller's next commit takes them).
__device__ void fetch_rows(float* dst, int stride, int width,
                           const float* __restrict__ x, int f, int h, int i0,
                           int D, const Layout& L) {
  deal(kRows, width, threadIdx.x, kThreads, [&](int r, int c) {
    const int i = i0 + r;
    const bool ok = i < L.Nq && c < D;
    cp_async4(dst + r * stride + c, x + (ok ? atq(L, f, i, h, D, c) : 0), ok);
  });
}

// pair_z rows r0.. r0+7 and keys j0.. j0+15 into dst [8][kPZs] ([key][32]
// a row), by one warp, as one cp.async group: at Dz = 32 each row's 16 Dz
// floats are one contiguous run of [Nq, Nk, Dz], copied 16 bytes at a
// time.
__device__ void fetch_pz(float* dst, const float* __restrict__ pz, int r0,
                         int j0, const Layout& L) {
  const int lane = threadIdx.x & 31;
  const int nk = min(kKeys, L.Nk - j0);  // real keys of the step
  for (int r = 0; r < 8; ++r) {
    const int i = r0 + r;
    const float* src = pz + ((size_t)min(i, L.Nq - 1) * L.Nk + j0) * L.Dz;
    float* d = dst + r * kPZs;
    if (L.pz_vec) {
      for (int c = 4 * lane; c < kKeys * kMaxDz; c += 4 * 32) {
        const bool ok = i < L.Nq && c < nk * kMaxDz;
        cp_async16(d + c, ok ? src + c : pz, ok);
      }
    } else {
      for (int c = lane; c < kKeys * L.Dz; c += 32) {
        const int key = c / L.Dz, x = c - key * L.Dz;
        const bool ok = i < L.Nq && key < nk;
        cp_async4(d + key * kMaxDz + x, ok ? src + c : pz, ok);
      }
    }
  }
  cp_async_commit();
}

// A fragment (raw float32) of rows row0 + g, row0 + g + 8 and columns
// col + t, col + t + 4 of the (f, h) rows of a [F, rows, H, D] tensor
// (rows: L.Nq for a query-side tensor, L.Nk for a key-side one); zero past
// `rows` and past `cols`.
__device__ __forceinline__ void load_afrag(float (&a)[4],
                                           const float* __restrict__ x,
                                           const Layout& L, int rows, int f,
                                           int h, int row0, int D, int col,
                                           int cols) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = row0 + g + 8 * (e & 1), c = col + t + 4 * (e >> 1);
    a[e] = (i < rows && c < cols) ? x[at_rows(rows, L.H, f, i, h, D, c)]
                                  : 0.f;
  }
}

// A fragment (raw float32) of rows g, g + 8 of the 16 rows at `x` (row
// stride `stride`, shared memory) and columns col + t, col + t + 4.
__device__ __forceinline__ void smem_afrag(float (&a)[4], const float* x,
                                           int stride, int col) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = x + g * stride + col + t;
  a[0] = p[0];
  a[1] = p[8 * stride];
  a[2] = p[4];
  a[3] = p[8 * stride + 4];
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(a[e], hi[e], lo[e]);
}

// The A fragment of a C tile's columns 8 ks.. 8 ks + 7 (the permuted depth
// order of tf32_mma.cuh), split.
__device__ __forceinline__ void split_ctile(const float (&c)[4],
                                            uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// B fragment of B[k][n] = M[n][k] (M rows n = the step's keys, columns k):
// b0 = M[8 nt + g][col + t], b1 = M[8 nt + g][col + t + 4], split.
__device__ __forceinline__ void bfrag_rows(const float* m, int stride, int nt,
                                           int col, uint32_t (&hi)[2],
                                           uint32_t (&lo)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = m + (8 * nt + g) * stride + col + t;
  split(p[0], hi[0], lo[0]);
  split(p[4], hi[1], lo[1]);
}

// B fragment of B[k][n] = M[k][n] with the permuted depth order (k = t is
// row 8 ks + 2t, k = t + 4 row 8 ks + 2t + 1), columns col + g, split.
__device__ __forceinline__ void bfrag_cols(const float* m, int stride, int ks,
                                           int col, uint32_t (&hi)[2],
                                           uint32_t (&lo)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = m + (8 * ks + 2 * t) * stride + col + g;
  split(p[0], hi[0], lo[0]);
  split(p[stride], hi[1], lo[1]);
}

// s[nt] = X . M^T over this warp's CQ channels for the step's 16 keys
// (nt = 0, 1): X's A fragments from afrag(ks, a) (raw float32), M the key
// tile [kKeys][Cs] from column col. 3xTF32; even and odd k-steps in
// separate accumulators (two independent chains per n-tile), added last.
// kT: X holds the keys and M the 16 query rows (the key-stationary
// layout's transposed tile), the passes in mma3t's order.
template <int NT, bool kT = false, typename AFrag>
__device__ __forceinline__ void qk_partial(float (&s)[2][4], AFrag afrag,
                                           const float* m, int col,
                                           const Layout& L) {
  float acc[2][2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < NT; ++ks) {
    float a[4];
    afrag(ks, a);
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t bh[2], bl[2];
      bfrag_rows(m, L.Cs, n, col + 8 * ks, bh, bl);
      if (kT)
        mma3t(acc[ks & 1][n], ah, al, bh, bl);
      else
        mma3(acc[ks & 1][n], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = acc[0][n][e] + acc[1][n][e];
}

// |qp|^2 of rows g and g + 8 from this lane's A fragments of qp (zero past
// P3q), summed over the quad.
__device__ __forceinline__ void row_norms(float (&qsq)[2],
                                          const float (&qpa)[kKQ][4]) {
  qsq[0] = qsq[1] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKQ; ++ks) {
    qsq[0] += qpa[ks][0] * qpa[ks][0] + qpa[ks][2] * qpa[ks][2];
    qsq[1] += qpa[ks][1] * qpa[ks][1] + qpa[ks][3] * qpa[ks][3];
  }
  qsq[0] = quad_sum(qsq[0]);
  qsq[1] = quad_sum(qsq[1]);
}

// |x|^2 of 16 rows (stride `stride`, kMaxP3q columns, zero past P3q) into
// dst, by lanes 0..15 of one warp (the caller orders the reads with
// __syncwarp): the key points' norms of every kernel.
__device__ __forceinline__ void norms16(float* dst, const float* x,
                                        int stride) {
  const int lane = threadIdx.x & 31;
  if (lane < kKeys) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxP3q; ++c)  // zero past P3q
      s += x[lane * stride + c] * x[lane * stride + c];
    dst[lane] = s;
  }
}

// |kp|^2 of the step's keys into ksq
__device__ __forceinline__ void key_norms(float* ksq, const KeyTile& t,
                                          const Layout& L) {
  norms16(ksq, t.kp, kP3qs);
}

// dist[nt] = |qp_i|^2 + |kp_j|^2 - 2 qp_i.kp_j for the step's keys, the
// cross term on the tensor cores (3xTF32).
__device__ __forceinline__ void point_dist(float (&dist)[2][4],
                                           const float (&qpa)[kKQ][4],
                                           const float (&qsq)[2],
                                           const float* ksq, const KeyTile& t,
                                           const Layout& L) {
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  float cross[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) cross[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKQ; ++ks) {
    uint32_t ah[4], al[4];
    split4(qpa[ks], ah, al);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t bh[2], bl[2];
      bfrag_rows(t.kp, kP3qs, n, 8 * ks, bh, bl);
      mma3(cross[n], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dist[n][e] = qsq[e >> 1] + ksq[8 * n + 2 * t4 + (e & 1)] -
                   2.f * cross[n][e];
}

// The logit, its four terms in the order every IPA kernel adds them.
__device__ __forceinline__ float ipa_logit(float qk, float bias, float dist,
                                           float qm, float km, float w,
                                           const Layout& L) {
  float l = L.c_qk * qk;
  l += L.c_b * bias;
  l += -0.5f * w * dist;
  l += L.inf * (qm * km - 1.f);
  return l;
}

// This lane's 8 values of a [2][4] fragment to an exchange slot, and one
// of them (n-tile n, element e) back.
__device__ __forceinline__ void xput(float* xch, int s,
                                     const float (&v)[2][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 8; ++e) xch[(s * 8 + e) * 32 + lane] = v[e >> 2][e & 3];
}

__device__ __forceinline__ float xval(const float* xch, int s, int n, int e) {
  return xch[(s * 8 + 4 * n + e) * 32 + (threadIdx.x & 31)];
}

__device__ __forceinline__ void xset(float* xch, int s, int n, int e,
                                     float v) {
  xch[(s * 8 + 4 * n + e) * 32 + (threadIdx.x & 31)] = v;
}

// The sum of the four channel quarters of slot s (kQK or kGV), in the same
// order in every warp and kernel.
__device__ __forceinline__ float xsum4(const float* xch, int s, int n,
                                       int e) {
  return (xval(xch, s, n, e) + xval(xch, s + 1, n, e)) +
         (xval(xch, s + 2, n, e) + xval(xch, s + 3, n, e));
}

// ---- the backward's tile recompute (dq and pair kernels) -------------------
// Each warp's share of the products of its 16-row tile and the key step in
// kt, into the exchange: its channel quarter of q.k^T and g_o.v^T (qa, goa:
// its quarter of q and g_o as raw A fragments, 3xTF32); quarter 0 the point
// distances and quarter 1 g_opt.vp^T (sqp, sgopt: the tile's 16 rows of
// query points and their cotangents in shared memory, 3xTF32); quarters 2
// and 3 the pair term g_pair_i.pz_ij of rows g + 8 rr on the CUDA cores
// (spz: their 8 pair_z rows of the step; gp: the lane's pair channels
// t + 4 m of g_pair_i): lane (g, t) sums its channels for all 16 keys, then
// a reduce-scatter over the quad hands each lane the keys of its fragment.
// pz_read() runs in the pair warps once every lane has read spz (dq fetches
// the next step's rows there); read(0) once qa is read and read(1) once goa
// is (the pair kernel loads the next (h, f)'s rows into them there).
template <int NT, typename PzRead, typename Read>
__device__ __forceinline__ void tile_products(
    float* xch, float* sksq, const float (&qa)[NT][4],
    const float (&goa)[NT][4], const float* sqp, const float* sgopt,
    const float* spz, const float (&gp)[kMaxDz / 4], const KeyTile& kt,
    int col, int qt, PzRead pz_read, Read read, const Layout& L) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  {
    float x[2][4];
    qk_partial<NT>(
        x,
        [&](int ks, float (&a)[4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qa[ks][e];
        },
        kt.k, col, L);
    read(0);
    xput(xch, kQK + qt, x);
    qk_partial<NT>(
        x,
        [&](int ks, float (&a)[4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = goa[ks][e];
        },
        kt.v, col, L);
    read(1);
    xput(xch, kGV + qt, x);
  }
  if (qt == 0) {
    float qpa[kKQ][4], qsq[2], dist[2][4];
#pragma unroll
    for (int ks = 0; ks < kKQ; ++ks) smem_afrag(qpa[ks], sqp, kP3qs, 8 * ks);
    row_norms(qsq, qpa);
    key_norms(sksq, kt, L);
    __syncwarp();
    point_dist(dist, qpa, qsq, sksq, kt, L);
    xput(xch, kDist, dist);
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
      smem_afrag(a, sgopt, kP3vs, 8 * ks);
      uint32_t ah[4], al[4];
      split4(a, ah, al);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t bh[2], bl[2];
        bfrag_rows(kt.vp, kP3vs, n, 8 * ks, bh, bl);
        mma3(gvp[n], ah, al, bh, bl);
      }
    }
    xput(xch, kGVP, gvp);
  } else {
    // g_pair_i . pz_ij of row g + 8 rr: sums over this lane's pair
    // channels, then a reduce-scatter over the quad: keys (jj & 7) < 4 to
    // lanes t < 2 and the rest to t >= 2, then odd key pairs to odd t
    const int rr = qt & 1;
    cp_async_wait<1>();  // this step's pair_z rows (the key tile may wait)
    __syncwarp();
    float part[kKeys];
    const float* z = spz + g * kPZs + t;  // zeros past Dz
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      float a = 0.f;
#pragma unroll
      for (int m = 0; m < kMaxDz / 4; ++m)
        a = fmaf(gp[m], z[jj * kMaxDz + 4 * m], a);
      part[jj] = a;
    }
    __syncwarp();  // every lane has read the rows
    pz_read();
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
      xset(xch, kGPZ, u >> 1, 2 * rr + (u & 1),
           (even ? hf[sl] : hf[sh]) + recv);
    }
  }
}

// a, dl and the point distance of rows r0 + g, r0 + g + 8 (tile `tile` of
// the block) and keys j0 + 8 n + 2 t + {0, 1} of the step in kt, from the
// exchange: the four warps of the tile read the same operands and compute
// the same values. a = dl = 0 past Nq and past Nk.
__device__ __forceinline__ void tile_a_dl(
    float (&a)[2][4], float (&dl)[2][4], float (&dist)[2][4],
    const float* xch, const KeyTile& kt, int tile, const float (&qm)[2],
    const float (&lse)[2], const float (&dvec)[2], float w, int r0, int j0,
    const Layout& L) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, c = 8 * n + 2 * t + (e & 1);
      const bool valid = r0 + g + 8 * r < L.Nq && j0 + c < L.Nk;
      dist[n][e] = xval(xch, kDist, n, e);
      const float l = ipa_logit(
          xsum4(xch, kQK, n, e), kt.bias[(16 * tile + g + 8 * r) * kBS + c],
          dist[n][e], qm[r], kt.km[c], w, L);
      const float av = expf(l - lse[r]);
      const float v = av * ((xsum4(xch, kGV, n, e) + xval(xch, kGVP, n, e) +
                             xval(xch, kGPZ, n, e)) -
                            dvec[r]);
      a[n][e] = valid ? av : 0.f;
      dl[n][e] = valid ? v : 0.f;
    }
}

}  // namespace ipa_tc
