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
// of its own): the same statistics, one bf16 rounding at the store. A fourth
// body is K4's front (sodt_unshift_add_layernorm, shifted_block_chain.cu):
// res1 = x + a read at its un-shifted position, formed and written in f32,
// and LN(res1) rounded once, in one pass over x and a.
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

// The lane's part of one row, v (its 8-wide vectors), with the lane's sums
// s and s2: the warp's statistics (var = E[x^2] - mu^2), then
// bf16((v - mu) * rstd * g + beta) stored 16 bytes at a time at y
__device__ __forceinline__ void ln_store(const float (&v)[LN_MAXV][8], float s, float s2,
                                         const float* __restrict__ g,
                                         const float* __restrict__ beta, bf16* __restrict__ y,
                                         int C, float eps, int lane) {
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
      *reinterpret_cast<uint4*>(y + c) = po;
    }
  }
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
  ln_store(v, s, s2, g, beta, y + off, C, eps, lane);
}

// K4's front: token `row` = (b, i, j) of a (B, H, W, C) map forms
// res1 = x[b, i, j] + a[b, (i - shift) mod H, (j - shift) mod W] in f32 (K3's
// output is in shifted coordinates: this is the un-shift on read), writes it
// in f32 and y = bf16(LN(res1)) with f32 statistics. 0 <= shift < H, W.
__global__ void __launch_bounds__(LN_WARPS * 32)
unshift_add_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                      const float* __restrict__ g, const float* __restrict__ beta,
                      float* __restrict__ res1, bf16* __restrict__ y, int R, int H, int W,
                      int C, int shift, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LN_WARPS + warp;
  if (row >= R) return;
  const int j = (int)(row % W), i = (int)((row / W) % H);
  int ai = i - shift, aj = j - shift;
  ai += ai < 0 ? H : 0;
  aj += aj < 0 ? W : 0;
  const size_t off = (size_t)row * C;
  const size_t aoff = (size_t)(row + (long long)(ai - i) * W + (aj - j)) * C;
  float v[LN_MAXV][8];
  float s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int q = 0; q < LN_MAXV; ++q) {
    const int c = (lane + 32 * q) * 8;
    if (c < C) {
      float av[8];
      ln_load8(x + off + c, v[q]);
      ln_load8(a + aoff + c, av);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[q][e] += av[e];
        s += v[q][e];
        s2 += v[q][e] * v[q][e];
      }
      *reinterpret_cast<float4*>(res1 + off + c) =
          make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);
      *reinterpret_cast<float4*>(res1 + off + c + 4) =
          make_float4(v[q][4], v[q][5], v[q][6], v[q][7]);
    }
  }
  ln_store(v, s, s2, g, beta, y + off, C, eps, lane);
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

// K4's front (its launches count as K4's): x, a (R = B * H * W, C) bf16 ->
// res1 (R, C) f32 = x + a un-shifted by `shift`, y (R, C) bf16 = LN(res1)
extern "C" int sodt_unshift_add_layernorm(const void* x, const void* a, const void* g,
                                          const void* beta, void* res1, void* y, int R, int H,
                                          int W, int C, int shift, float eps, void* stream) {
  if (C % 8 != 0 || C > 32 * 8 * sodt::LN_MAXV || R <= 0 || H <= 0 || W <= 0 ||
      R % ((long long)H * W) != 0 || shift < 0 || shift >= H || shift >= W)
    return (int)cudaErrorInvalidValue;
  const int grid = (R + sodt::LN_WARPS - 1) / sodt::LN_WARPS;
  sodt::unshift_add_ln_kernel<<<grid, sodt::LN_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const sodt::bf16*)x, (const sodt::bf16*)a, (const float*)g, (const float*)beta,
      (float*)res1, (sodt::bf16*)y, R, H, W, C, shift, eps);
  return (int)cudaGetLastError();
}
