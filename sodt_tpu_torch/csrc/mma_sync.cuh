// Register-level bf16 tensor-core helpers: mma.sync m16n8k16 (f32
// accumulation) on operands that ldmatrix brings from shared memory, and
// the lane addresses that ldmatrix.x4 takes for an A tile and for two B
// tiles. K8 and K10 (global_attention.cuh) issue their products through
// these; the GEMM core of K6 and K7 (gemm_core.cuh, wgmma) takes its
// shared-window addresses and bf16 packing from here.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane l, g = l / 4,
// t = l % 4. The accumulator of a 16 x 8 tile holds rows g (c0, c1) and
// g + 8 (c2, c3) at columns 2t, 2t + 1. The A operand (16 x 16, row major)
// holds a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..), a2 = (g, 2t+8..),
// a3 = (g + 8, 2t+8..).
#pragma once

#include "common.cuh"

namespace sodt {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b  (16 x 8 f32 += 16 x 16 bf16 . 16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (the lower column in the low half)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Address a lane hands to ldmatrix.x4 so that the four 8 x 8 matrices are
// (rows r0..r0+7, cols c0..c0+7), (r0+8.., c0..), (r0.., c0+8..),
// (r0+8.., c0+8..): the A operand of a 16 x 16 tile at (r0, c0) of a
// row-major bf16 array with row stride ld.
__device__ __forceinline__ const bf16* a_tile_addr(const bf16* base, int ld, int r0, int c0,
                                                   int lane) {
  const int mi = lane >> 3;
  return base + (size_t)(r0 + (mi & 1) * 8 + (lane & 7)) * ld + c0 + (mi >> 1) * 8;
}

// The B operands of two n8 tiles (rows n0..n0+15 of an n-major array whose
// k runs along the row, k0..k0+15): registers {b0, b1} of tile n0 and of
// tile n0 + 8, without .trans. With .trans the same address order serves a
// k-major array (rows k0..k0+15, cols n0..n0+15): use b_tile_addr_t.
__device__ __forceinline__ const bf16* b_tile_addr(const bf16* base, int ld, int n0, int k0,
                                                   int lane) {
  const int mi = lane >> 3;
  return base + (size_t)(n0 + (mi >> 1) * 8 + (lane & 7)) * ld + k0 + (mi & 1) * 8;
}
__device__ __forceinline__ const bf16* b_tile_addr_t(const bf16* base, int ld, int k0, int n0,
                                                     int lane) {
  const int mi = lane >> 3;
  return base + (size_t)(k0 + (mi & 1) * 8 + (lane & 7)) * ld + n0 + (mi >> 1) * 8;
}

// ---- the windowed-attention register bodies' pieces (K1 / K5 / K11 forward,
// K9): a 4-byte cp.async, stmatrix, ex2 and the reductions over the four
// lanes of an accumulator row

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem_dst)),
               "l"(gmem_src), "r"(pred ? 4 : 0));
}

// four 8 x 8 bf16 matrices from accumulator-layout registers (lane l holds
// row l / 4, columns 2 (l % 4), +1 of each) to the rows lanes 8i..8i+7 address
__device__ __forceinline__ void stsm_x4(const void* p, unsigned r0, unsigned r1, unsigned r2,
                                        unsigned r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_addr(p)),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ float ex2_approx(float x) {  // 2^x, -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}


}  // namespace sodt
