// The TF32 tensor-core helpers shared by K13 (mxu.cu) and K7's lossy
// instance (fmm.cu): rounding to TF32, the split of an fp32 value into a
// TF32 part and a TF32 remainder, and one mma.sync m16n8k8 TF32 product.
//
// mma.sync.m16n8k8 .tf32 fragments (PTX ISA, "Matrix Fragments for
// mma.m16n8k8"): in a warp, lane = 4 g + t holds A's (row g, col t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B's (row t, col g), (t + 4, g);
// C's (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
#pragma once

#include <cuda_runtime.h>

namespace murb {

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// half a TF32 ulp added to the magnitude bits, the 13 low bits cleared
// (the bits of cvt.rna.tf32.f32 for finite x).
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ void tf32_split(float x, float& big,
                                           float& small) {
  big = tf32_rna(x);
  small = tf32_rna(__fsub_rn(x, big));
}

// d += a b on the tensor cores: m16n8k8, TF32 operands, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], float a0, float a1,
                                         float a2, float a3, float b0,
                                         float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)),
        "r"(__float_as_uint(a2)), "r"(__float_as_uint(a3)),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

}  // namespace murb
