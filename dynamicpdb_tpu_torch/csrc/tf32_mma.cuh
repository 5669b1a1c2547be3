// Building blocks shared by the tensor-core kernels of this directory
// (geom_attention.cu, ipa_attention_fwd.cu, ipa_attention_bwd.cu): the PTX
// primitives (asynchronous copies, the TF32 tensor-core product, named
// barriers, the quad shuffles) and the 3xTF32 split.
//
// Fragment layouts of mma.m16n8k8 (lane = 4 g + t, g = lane / 4, t = lane % 4):
//   A (16 x 8, row major): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//                          a3 = A[g+8][t+4]
//   B (8 x 8, column):     b0 = B[t][g], b1 = B[t+4][g]
//   C (16 x 8):            c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
//                          c3 = C[g+8][2t+1]
// A C tile becomes the next product's A fragment without shuffles when the
// next product's depth index k = t stands for column 2t and k = t + 4 for
// column 2t + 1 (a0, a1, a2, a3 = c0, c2, c1, c3), and its B operand is read
// with the same permutation.
#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

// ---- PTX primitives --------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D += A . B on the tensor cores, m16n8k8, TF32 in, float32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Barrier `id` (1-15; 0 is __syncthreads) over `count` threads, whole warps.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// ---- end of PTX primitives -------------------------------------------------

// x = hi + lo: hi is x cut to TF32 (its 13 low mantissa bits cleared, one
// LOP3), lo = x - hi is exact in float32 and reaches the tensor cores cut to
// TF32 in turn (its lost bits are below 2^-20 |x|). Two instructions, no
// conversion. A product in three passes, lo.hi + hi.lo + hi.hi, keeps
// about 2^-21 of each term: float32 accuracy from TF32 tensor cores.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a . b in three passes (3xTF32), both operands already split.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(c, al, bh);
  mma(c, ah, bl);
  mma(c, ah, bh);
}
