// K13: LayerNorm over the last axis, and the fused residual add + LayerNorm.
// Replaces sodt_tpu/pallas/layernorm.py _ln_kernel / _add_ln_kernel
// (_pallas_ln, _pallas_add_ln). Bound by bytes: one read and one write per
// tensor. One warp owns one row: it reads the row once as 16-byte vectors
// (the row stays in registers, up to C = 1024), takes sum and sum of
// squares in f32 with warp shuffles, var = E[x^2] - mu^2 as the Pallas
// kernel does, and writes (x - mu) * rsqrt(var + eps) * g + b in one bf16
// rounding. The add variant forms s = a + b rounded to bf16 first, writes
// it, and normalizes that rounded sum (`s = a_ref + b_ref` is a bf16 add in
// the Pallas kernel). The MXU-ones reduction of the TPU kernel is a TPU
// device and is not carried over. A third instantiation reads f32 rows (K2's
// LN2 over its f32 residual stream, sodt_layernorm_f32rows; not a K13 call
// of its own): the same statistics, one bf16 rounding at the store.
#include "common.cuh"

namespace sodt {

constexpr int LN_WARPS = 8;  // rows per CTA
constexpr int LN_MAXV = 4;   // 8-wide vectors per lane: C <= 32 * 8 * 4

// 8 consecutive values of a row as f32: one 16-byte load of bf16, two of f32
__device__ __forceinline__ void ln_load8(const bf16* p, float (&v)[8]) {
  uint4 q = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&q);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void ln_load8(const float* p, float (&v)[8]) {
  *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(p);
  *reinterpret_cast<float4*>(v + 4) = *reinterpret_cast<const float4*>(p + 4);
}

// T: the type of the rows (bf16, or f32 without ADD)
template <bool ADD, class T = bf16>
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_kernel(const T* __restrict__ a, const bf16* __restrict__ b,
                 const float* __restrict__ g, const float* __restrict__ beta,
                 bf16* __restrict__ sum_out, bf16* __restrict__ y, int R, int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LN_WARPS + warp;
  if (row >= R) return;
  const size_t off = (size_t)row * C;
  float v[LN_MAXV][8];
  float s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c < C) {
      if constexpr (ADD) {
        uint4 pa = *reinterpret_cast<const uint4*>(a + off + c);
        const bf16* ea = reinterpret_cast<const bf16*>(&pa);
        uint4 pb = *reinterpret_cast<const uint4*>(b + off + c);
        const bf16* eb = reinterpret_cast<const bf16*>(&pb);
        uint4 ps;
        bf16* es = reinterpret_cast<bf16*>(&ps);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          es[e] = __float2bfloat16(__bfloat162float(ea[e]) + __bfloat162float(eb[e]));
          v[i][e] = __bfloat162float(es[e]);
        }
        *reinterpret_cast<uint4*>(sum_out + off + c) = ps;
      } else {
        ln_load8(a + off + c, v[i]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[i][e];
        s2 += v[i][e] * v[i][e];
      }
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / C;
  const float rstd = rsqrtf(s2 / C - mu * mu + eps);
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c < C) {
      float gg[8], bb[8];
      *reinterpret_cast<float4*>(gg) = *reinterpret_cast<const float4*>(g + c);
      *reinterpret_cast<float4*>(gg + 4) = *reinterpret_cast<const float4*>(g + c + 4);
      *reinterpret_cast<float4*>(bb) = *reinterpret_cast<const float4*>(beta + c);
      *reinterpret_cast<float4*>(bb + 4) = *reinterpret_cast<const float4*>(beta + c + 4);
      uint4 po;
      bf16* eo = reinterpret_cast<bf16*>(&po);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        eo[e] = __float2bfloat16((v[i][e] - mu) * rstd * gg[e] + bb[e]);
      *reinterpret_cast<uint4*>(y + off + c) = po;
    }
  }
}

}  // namespace sodt

extern "C" int sodt_layernorm(const void* x, const void* g, const void* beta, void* y, int R,
                              int C, float eps, void* stream) {
  if (C % 8 != 0 || C > 32 * 8 * sodt::LN_MAXV || R <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (R + sodt::LN_WARPS - 1) / sodt::LN_WARPS;
  sodt::layernorm_kernel<false><<<grid, sodt::LN_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const sodt::bf16*)x, nullptr, (const float*)g, (const float*)beta, nullptr,
      (sodt::bf16*)y, R, C, eps);
  return (int)cudaGetLastError();
}

extern "C" int sodt_add_layernorm(const void* a, const void* b, const void* g,
                                  const void* beta, void* sum, void* y, int R, int C,
                                  float eps, void* stream) {
  if (C % 8 != 0 || C > 32 * 8 * sodt::LN_MAXV || R <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (R + sodt::LN_WARPS - 1) / sodt::LN_WARPS;
  sodt::layernorm_kernel<true><<<grid, sodt::LN_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const sodt::bf16*)a, (const sodt::bf16*)b, (const float*)g, (const float*)beta,
      (sodt::bf16*)sum, (sodt::bf16*)y, R, C, eps);
  return (int)cudaGetLastError();
}

// x: (R, C) f32 rows -> y (R, C) bf16; K2's LN2 (its launches count as K2's)
extern "C" int sodt_layernorm_f32rows(const void* x, const void* g, const void* beta, void* y,
                                      int R, int C, float eps, void* stream) {
  if (C % 8 != 0 || C > 32 * 8 * sodt::LN_MAXV || R <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (R + sodt::LN_WARPS - 1) / sodt::LN_WARPS;
  sodt::layernorm_kernel<false, float><<<grid, sodt::LN_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)x, nullptr, (const float*)g, (const float*)beta, nullptr, (sodt::bf16*)y, R,
      C, eps);
  return (int)cudaGetLastError();
}
