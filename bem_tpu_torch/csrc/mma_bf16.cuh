// bf16 tensor-core building blocks shared by the stem's, the gdMlp's and
// the tail's tensor-core forms: mma.sync m16n8k16 (bf16 in, fp32
// accumulate), its A and B fragments from bf16 matrices in shared memory
// (by 32-bit loads or ldmatrix), the split of an fp32 value into two
// bf16 terms, and mma3, the three products that keep an fp32 product to
// about 2^-16 (the gdMlp's fp32 form); and the tf32 counterparts,
// mma.sync m16n8k8 on tf32 splits, mma3_tf32 keeping it to about 2^-22
// (the stem's fp32 form).
//
// Fragments (lane = 4 g + t): A rows g and g + 8, columns 2t, 2t + 1 and
// 2t + 8, 2t + 9; B (K x N, "col") column g, rows 2t, 2t + 1 (b0) and
// 2t + 8, 2t + 9 (b1); D rows g (d0, d1) and g + 8 (d2, d3), columns 2t and
// 2t + 1. A row stride S of Kp + 8 bf16 (S / 2 = 4 mod 8 words) puts the
// 8 rows x 4 words of a fragment load on 32 distinct banks.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace bem {

using bf16_t = __nv_bfloat16;

constexpr int kTcMaxC = 256;  // widest C and output width of the tensor-core forms

// fp32 w as hi = bf16(w) at p and lo = bf16(w - hi) at p + lo_off
__device__ __forceinline__ void split_store(bf16_t* p, int lo_off, float w) {
  const bf16_t hi = __float2bfloat16_rn(w);
  p[0] = hi;
  p[lo_off] = __float2bfloat16_rn(w - __bfloat162float(hi));
}

// two bf16 as one 32-bit word, a in the low half (the lower address)
__device__ __forceinline__ uint32_t pack2(bf16_t a, bf16_t b) {
  const __nv_bfloat162 h = __halves2bfloat162(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const bf16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a . b on a 16x8x16 bf16 tile, fp32 accumulators in place
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b for fp32 operands held as bf16 splits a = ah + al, b = bh + bl:
// hi.hi, lo.hi and hi.lo into the same fp32 accumulators. The dropped
// lo.lo and the splits' rests are each at most about 2^-16 of |a| |b|.
__device__ __forceinline__ void mma3(float* d, const uint32_t* ah, const uint32_t* al,
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma16816(d, ah, bh0, bh1);
  mma16816(d, al, bh0, bh1);
  mma16816(d, ah, bl0, bl1);
}

// fp32 v as tf32 big = v rounded to 10 fraction bits (to nearest, ties away
// from zero) and small = v - big rounded the same way: big + small is v to
// about 2^-22
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(v - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

// d += a . b on a 16x8x8 tf32 tile, fp32 accumulators in place (fragments:
// A rows g, g + 8, columns t, t + 4 in a0 (g, t), a1 (g + 8, t), a2 (g,
// t + 4), a3 (g + 8, t + 4); B column g, rows t (b0) and t + 4 (b1); D as
// mma16816's)
__device__ __forceinline__ void mma1688_tf32(float* d, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b for fp32 operands held as tf32 splits (3xTF32): small.big,
// big.small, then big.big into the same fp32 accumulators; the dropped
// small.small and the splits' rests are about 2^-22 of |a| |b|
__device__ __forceinline__ void mma3_tf32(float* d, const uint32_t* ab, const uint32_t* as,
                                          const uint32_t* bb, const uint32_t* bs) {
  mma1688_tf32(d, as, bb[0], bb[1]);
  mma1688_tf32(d, ab, bs[0], bs[1]);
  mma1688_tf32(d, ab, bb[0], bb[1]);
}

// the tf32 A fragment, split, of rows row0..row0+15, columns k0..k0+7 of a
// row-major fp32 matrix with row stride S (S = 4 mod 8: conflict-free)
__device__ __forceinline__ void load_a_tf32(uint32_t* big, uint32_t* small, const float* m, int S,
                                            int row0, int k0, int g, int t) {
  const float* p = m + (row0 + g) * S + k0 + t;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8 * S], big[1], small[1]);
  split_tf32(p[4], big[2], small[2]);
  split_tf32(p[8 * S + 4], big[3], small[3]);
}

// the tf32 B fragment, split, of columns n0..n0+7, rows k0..k0+7 of a
// K x N fp32 operand stored N-major (row n of stride S holds column n)
__device__ __forceinline__ void load_b_tf32(uint32_t* big, uint32_t* small, const float* m, int S,
                                            int n0, int k0, int g, int t) {
  const float* p = m + (n0 + g) * S + k0 + t;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[4], big[1], small[1]);
}

// the A fragment of rows row0..row0+15, columns k0..k0+15 of a row-major
// bf16 matrix with row stride S (lane: group g = lane/4, thread t = lane%4)
__device__ __forceinline__ void load_a(uint32_t* a, const bf16_t* m, int S, int row0, int k0,
                                       int g, int t) {
  const bf16_t* p = m + (row0 + g) * S + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * S);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * S + 8);
}

// ldmatrix .x4: the same A fragment as load_a, in one instruction (lanes
// 0-15 give rows row0..row0+15 at k0, lanes 16-31 the same rows at k0 + 8;
// 16-byte aligned rows)
__device__ __forceinline__ void ldsm_a(uint32_t* a, const bf16_t* m, int S, int row0, int k0,
                                       int lane) {
  const bf16_t* p = m + (row0 + (lane & 15)) * S + k0 + ((lane >> 4) << 3);
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// ldmatrix .x2: the B fragment (b0, b1) of columns n0..n0+7, rows k0..k0+15
// of a K x N operand stored N-major (row n of stride S holds column n)
__device__ __forceinline__ void ldsm_b(uint32_t& b0, uint32_t& b1, const bf16_t* m, int S, int n0,
                                       int k0, int lane) {
  const bf16_t* p = m + (n0 + (lane & 7)) * S + k0 + (((lane >> 3) & 1) << 3);
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

}  // namespace bem
