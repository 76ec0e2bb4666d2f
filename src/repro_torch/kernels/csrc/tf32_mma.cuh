// f32-accurate products on the TF32 tensor cores (3xTF32), shared by the
// SSD forward (ssd/csrc/ssd.cu) and flash attention's f32 instance
// (flash_attention/csrc/flash_attention_mma.cu).
//
// A float a is split into a_hi and a_lo = a - a_hi, both TF32; a product is
// then a_lo b_hi + a_hi b_lo + a_hi b_hi, issued in that order (the small
// terms first) into one f32 accumulator, which keeps the error near f32's.
// One TF32 product (~2^-11 relative) breaks the kernels' 1e-4 tolerances.
// Two splits: split_tf32 rounds both parts to nearest (cvt.rna; the SSD
// forward), split_tf32_trunc truncates a_hi to its TF32 bits and hands
// a_lo over unrounded, for the tensor core to truncate (two integer/float
// instructions instead of two conversions; flash attention's f32 instance).
//
// mma.sync m16n8k8 .tf32 fragments (PTX ISA), with g = lane / 4 and
// t = lane % 4:
//   A (16 x 8, row)  a = {A(g, t), A(g+8, t), A(g, t+4), A(g+8, t+4)}
//   B (8 x 8, col)   b = {B(t, g), B(t+4, g)}
//   C, D (16 x 8)    d = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}
#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& hi,
                                                 uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
