// 3xTF32 building blocks shared by the mma.sync kernels (ssd_chunk.cu,
// kmeans_assign.cu): 16-byte cp.async, the hi/lo split of an fp32 value
// into two TF32 values, and the m16n8k8 TF32 mma.  A product a·b in 3xTF32
// is ahi·blo + alo·bhi accumulated before ahi·bhi, into fp32: within fp32
// rounding of the plain fp32 product, where single TF32 (ahi·bhi alone)
// keeps about three decimal digits.
//
// Fragment layouts of mma.sync.m16n8k8 (row.col, TF32), with gq = lane / 4
// and q = lane % 4: A (16 x 8, row-major) a0 = (gq, q), a1 = (gq + 8, q),
// a2 = (gq, q + 4), a3 = (gq + 8, q + 4); B (8 x 8, k x n) b0 = (q, gq),
// b1 = (q + 4, gq); C/D (16 x 8) d0 = (gq, 2q), d1 = (gq, 2q + 1),
// d2 = (gq + 8, 2q), d3 = (gq + 8, 2q + 1).  The k index may be permuted
// within a slab of 8 as long as A and B use the same permutation.

#pragma once

#include <cuda_runtime.h>

namespace tf32x3 {

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// v = hi + lo with hi = rna_tf32(v), lo = rna_tf32(v - hi).  Rounded by
// adding half a TF32 unit to the bits: the mma reads the top 19 bits of an
// operand, so that is cvt.rna.tf32.f32 (nearest, ties away from zero) for
// every finite v, in two integer ops where cvt compiles to a sequence with
// NaN checks; hi is masked before the subtraction
__device__ __forceinline__ void split(float v, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(v) + 0x1000u;
  const float rest = v - __uint_as_float(hi & 0xffffe000u);
  lo = __float_as_uint(rest) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 8, row-major) of four fp32 values, split
__device__ __forceinline__ void split_a(float v0, float v1, float v2, float v3, unsigned* hi,
                                       unsigned* lo) {
  split(v0, hi[0], lo[0]);
  split(v1, hi[1], lo[1]);
  split(v2, hi[2], lo[2]);
  split(v3, hi[3], lo[3]);
}

}  // namespace tf32x3
