// f32 matrix products on Hopper's tensor cores in three TF32 passes
// ("3xTF32"), shared by attention.cu and decode.cu.
//
// Each operand x is split into hi = tf32(x) and lo = tf32(x - hi), and
// acc += lo*hi + hi*lo + hi*hi, the small terms first: the three passes
// carry the operands' f32 precision into the product.  The error left is
// the tensor cores' f32 accumulation, which does not round each sum to
// nearest.
//
// Fragments of mma.sync.m16n8k8 (lane = 4 gr + t): A holds rows gr, gr + 8
// and columns t, t + 4 of a 16x8 tile (a[0] = (gr, t), a[1] = (gr + 8, t),
// a[2] = (gr, t + 4), a[3] = (gr + 8, t + 4)); B holds rows t, t + 4 of
// column gr of an 8x8 tile; the accumulator holds rows gr, gr + 8 and
// columns 2t, 2t + 1 of a 16x8 tile (c[0] = (gr, 2t), c[1] = (gr, 2t + 1),
// c[2] = (gr + 8, 2t), c[3] = (gr + 8, 2t + 1)).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x rounded to TF32, to nearest with ties away from zero: the result of
// cvt.rna.tf32.f32 for finite x, by an integer add of half a TF32 ulp and a
// mask.  Every operand element is split once per use, and with the
// conversion instruction the attention kernels took 16-17% longer on the
// H100.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[n] += A B_n for N tiles whose B fragments come split (bh, bl), in
// three TF32 passes, the small terms first.  Each pass runs over all N
// tiles, so that N independent products separate two that share an
// accumulator (in-order issue would otherwise wait out the mma latency
// twice a tile).
template <int N>
__device__ __forceinline__ void mma3_split(float (*acc)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (*bh)[2],
                                           const uint32_t (*bl)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], ah, bh[n]);
}

// acc[e][n] += A_e B_en for E x N tiles, operands split, the three passes
// each over all E x N tiles (E A fragments, each with its own N B
// fragments).
template <int E, int N>
__device__ __forceinline__ void mma3_batch(float (*acc)[N][4],
                                           const uint32_t (*ah)[4],
                                           const uint32_t (*al)[4],
                                           const uint32_t (*bh)[N][2],
                                           const uint32_t (*bl)[N][2]) {
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(acc[e][n], al[e], bh[e][n]);
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(acc[e][n], ah[e], bl[e][n]);
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(acc[e][n], ah[e], bh[e][n]);
}

// The same with raw f32 B fragments (b[n]: k = t and k = t + 4), split here.
template <int N>
__device__ __forceinline__ void mma3(float (*acc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const float (&b)[N][2]) {
  uint32_t bh[N][2], bl[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split(b[n][0], bh[n][0], bl[n][0]);
    split(b[n][1], bh[n][1], bl[n][1]);
  }
  mma3_split<N>(acc, ah, al, bh, bl);
}

}  // namespace
