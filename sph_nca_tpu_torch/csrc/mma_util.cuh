// Tensor-core helpers shared by the table kernels (table_kernels.cu) and the
// update-MLP kernel (mlp_kernel.cu), for sm_90a: TF32 rounding and the 3xTF32
// operand split, mma.sync products into fresh sums, and the round-to-nearest
// f32 addition of those sums.
#pragma once

#include <stdint.h>

namespace {

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero, as
// cvt.rna.tf32.f32) by integer arithmetic on the full-rate ALUs
__device__ __forceinline__ uint32_t rna_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small in TF32: big = rna(x), small = rna(x - big), to ~2^-22 of x
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
    big = rna_tf32(x);
    small = rna_tf32(x - __uint_as_float(big));
}

// c += a b
__device__ __forceinline__ void mma_tf32_acc(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a b: a the m16 x k8 A fragment (a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4)), b the k8 x n8 B fragment (b0 (t, g), b1 (t+4, g)), c the
// m16 x n8 sums (c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)),
// g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.0f));
}

// c = a b in bf16, m16n8k16: a0 (g, 2t..2t+1), a1 (g+8, 2t..2t+1), a2 (g,
// 2t+8..2t+9), a3 (g+8, 2t+8..2t+9), two bf16 a register, the lower column
// in the low half; b0 (2t..2t+1, g), b1 (2t+8..2t+9, g); c as mma_tf32's
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.0f));
}

// acc += c in round-to-nearest f32 (the tensor core's own sums truncate)
__device__ __forceinline__ void add4(float* acc, const float* c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

}  // namespace
