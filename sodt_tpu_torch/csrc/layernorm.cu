// K13: LayerNorm over the last axis, and the fused residual add + LayerNorm.
// Replaces sodt_tpu/pallas/layernorm.py _ln_kernel / _add_ln_kernel
// (_pallas_ln, _pallas_add_ln). Bound by bytes: one read and one write per
// tensor. Statistics in f32, var = E[x^2] - mu^2 as the Pallas kernel takes
// it, and (x - mu) * rsqrt(var + eps) * g + b written in one bf16
// rounding. The add variant forms s = a + b rounded to bf16 first, writes
// it, and normalizes that rounded sum (`s = a_ref + b_ref` is a bf16 add in
// the Pallas kernel). The MXU-ones reduction of the TPU kernel is a TPU
// device and is not carried over.
//
// One row body, four fronts (the MODE template argument, resolved at
// compile time; no branch per element):
//   LN_ROWS          bf16 rows                       sodt_layernorm (K13, and
//                                                    K2's / K3's LN1 from C)
//   LN_F32ROWS       f32 rows                        sodt_layernorm_f32rows
//                                                    (K2's LN2, from C)
//   LN_ADD           s = bf16(a + b), written        sodt_add_layernorm
//   LN_UNSHIFT_ADD   res1 = x + a[(i - s) mod H,     sodt_unshift_add_layernorm
//                    (j - s) mod W] in f32, written  (K4's front, from C)
//                    in f32; LN(res1)
//
// Design: rows packed to their width. A row is taken by a group of L lanes,
// each holding V 16-byte vectors (8 values) of it, lane `sub` of the group
// the vectors at columns (sub + L * i) * 8: neighbouring lanes read
// neighbouring 16 bytes. Every width the system runs is 24 * 2^k (SwinV2's
// cross-channel block 24, the flagship's four maps 48, 96, 192, 384, 768),
// so V = 3 fills every lane: L = C / 24 lanes a row, 32 / L rows a warp.
// Any other C (a multiple of 8, at most 1024) takes a whole warp a row with
// V = 4, a lane's vectors past C idle. The statistics are shuffles of width
// L (log2 L butterfly steps inside the group); all of a row's loads are
// issued before them. g and beta are read once per lane, into registers,
// for the columns it keeps; the CTAs (8 warps) walk the row groups with a
// grid stride, their number sized to fill the SMs once. A row group past
// R loads nothing and stores nothing but still joins the warp's shuffles.
// (A warp a row would leave 29 of 32 lanes idle at C = 24 and 26 at 48.)
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, §6) every shape of >= 12
// MB reads at >= 80% of its bytes bound (C 48: 3.9 us against 3.76; warm
// inputs in L2 read above it), the flagship step's 23 LN launches take 0.28
// ms, SwinV2's 31 a forward 0.10.
#include "common.cuh"

namespace sodt {

constexpr int LN_THREADS = 256;  // 8 warps a CTA

enum { LN_ROWS = 0, LN_F32ROWS = 1, LN_ADD = 2, LN_UNSHIFT_ADD = 3 };

struct LnArgs {
  const void* x;      // (R, C) rows: f32 for LN_F32ROWS, else bf16 (LN_ADD's a)
  const bf16* b;      // LN_ADD: b (R, C); LN_UNSHIFT_ADD: a, read un-shifted
  const float* g;     // (C,)
  const float* beta;  // (C,)
  void* side;         // LN_ADD: the bf16 sum; LN_UNSHIFT_ADD: res1 in f32
  bf16* y;            // (R, C)
  int R, C;
  float eps;
  int H, W, shift;    // LN_UNSHIFT_ADD: rows are the tokens of (B, H, W, C)
};

__device__ __forceinline__ void bf16x8_to_f32(const uint4& q, float* v) {
  const bf16* e = reinterpret_cast<const bf16*>(&q);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}

// The lane's V vectors of one row as f32 values in v (0 where a vector is
// off the row or the row past R), with the add fronts' side output written.
// Every load of the row is issued before any value is formed.
template <int MODE, int V>
__device__ __forceinline__ void ln_front(const LnArgs& p, long long row, bool ok,
                                         const bool (&on)[V], const int (&col)[V], int C,
                                         float (&v)[V][8]) {
  const size_t off = (size_t)row * C;
  const uint4 z4 = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (MODE == LN_F32ROWS) {
    const float* x = static_cast<const float*>(p.x) + off;
    float4 q[V][2];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const bool ld = ok && on[i];
      q[i][0] = ld ? *reinterpret_cast<const float4*>(x + col[i]) : make_float4(0, 0, 0, 0);
      q[i][1] = ld ? *reinterpret_cast<const float4*>(x + col[i] + 4) : make_float4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      *reinterpret_cast<float4*>(v[i]) = q[i][0];
      *reinterpret_cast<float4*>(v[i] + 4) = q[i][1];
    }
  } else if constexpr (MODE == LN_ROWS) {
    const bf16* x = static_cast<const bf16*>(p.x) + off;
    uint4 q[V];
#pragma unroll
    for (int i = 0; i < V; ++i)
      q[i] = ok && on[i] ? *reinterpret_cast<const uint4*>(x + col[i]) : z4;
#pragma unroll
    for (int i = 0; i < V; ++i) bf16x8_to_f32(q[i], v[i]);
  } else {
    // LN_ADD: a + b at the row; LN_UNSHIFT_ADD: x + a at the row's
    // un-shifted token (K3's output is in shifted coordinates)
    size_t boff = off;
    if constexpr (MODE == LN_UNSHIFT_ADD) {
      if (ok) {
        const int j = (int)(row % p.W), i = (int)((row / p.W) % p.H);
        int ai = i - p.shift, aj = j - p.shift;
        ai += ai < 0 ? p.H : 0;
        aj += aj < 0 ? p.W : 0;
        boff = (size_t)(row + (long long)(ai - i) * p.W + (aj - j)) * C;
      }
    }
    const bf16* a = static_cast<const bf16*>(p.x) + off;
    const bf16* b = p.b + boff;
    uint4 qa[V], qb[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const bool ld = ok && on[i];
      qa[i] = ld ? *reinterpret_cast<const uint4*>(a + col[i]) : z4;
      qb[i] = ld ? *reinterpret_cast<const uint4*>(b + col[i]) : z4;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float fa[8], fb[8];
      bf16x8_to_f32(qa[i], fa);
      bf16x8_to_f32(qb[i], fb);
      if constexpr (MODE == LN_ADD) {
        uint4 ps;
        bf16* es = reinterpret_cast<bf16*>(&ps);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          es[e] = __float2bfloat16(fa[e] + fb[e]);
          v[i][e] = __bfloat162float(es[e]);
        }
        if (ok && on[i])
          *reinterpret_cast<uint4*>(static_cast<bf16*>(p.side) + off + col[i]) = ps;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[i][e] = fa[e] + fb[e];
        if (ok && on[i]) {
          float* r = static_cast<float*>(p.side) + off + col[i];
          *reinterpret_cast<float4*>(r) = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
          *reinterpret_cast<float4*>(r + 4) = make_float4(v[i][4], v[i][5], v[i][6], v[i][7]);
        }
      }
    }
  }
}

// V vectors a lane, L lanes a row (a power of two dividing 32). V == 3:
// C is exactly 24 * L (the packed widths); V == 4, L == 32: a whole warp a
// row, C <= 1024.
template <int MODE, int V, int L>
__global__ void __launch_bounds__(LN_THREADS) layernorm_kernel(const LnArgs p) {
  constexpr bool PACKED = V == 3;
  constexpr int ROWS = 32 / L;  // rows a warp takes at once
  const int C = PACKED ? 8 * V * L : p.C;
  const int lane = threadIdx.x & 31, sub = lane % L;
  int col[V];
  bool on[V];
  float gg[V][8], bb[V][8];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    col[i] = (sub + L * i) * 8;
    on[i] = PACKED || col[i] < C;
    const float4 z = make_float4(0, 0, 0, 0);
    *reinterpret_cast<float4*>(gg[i]) = on[i] ? *reinterpret_cast<const float4*>(p.g + col[i]) : z;
    *reinterpret_cast<float4*>(gg[i] + 4) =
        on[i] ? *reinterpret_cast<const float4*>(p.g + col[i] + 4) : z;
    *reinterpret_cast<float4*>(bb[i]) =
        on[i] ? *reinterpret_cast<const float4*>(p.beta + col[i]) : z;
    *reinterpret_cast<float4*>(bb[i] + 4) =
        on[i] ? *reinterpret_cast<const float4*>(p.beta + col[i] + 4) : z;
  }
  const long long step = (long long)gridDim.x * (LN_THREADS / 32) * ROWS;
  for (long long r0 = ((long long)blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5)) * ROWS;
       r0 < p.R; r0 += step) {  // warp-uniform: every lane joins the shuffles
    const long long row = r0 + lane / L;
    const bool ok = row < p.R;
    float v[V][8];
    ln_front<MODE, V>(p, row, ok, on, col, C, v);
    float s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[i][e];
        s2 += v[i][e] * v[i][e];
      }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mu = s / C;
    const float rstd = rsqrtf(s2 / C - mu * mu + p.eps);
    if (!ok) continue;
    bf16* y = p.y + (size_t)row * C;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (!on[i]) continue;
      uint4 po;
      bf16* eo = reinterpret_cast<bf16*>(&po);
#pragma unroll
      for (int e = 0; e < 8; ++e) eo[e] = __float2bfloat16((v[i][e] - mu) * rstd * gg[i][e] + bb[i][e]);
      *reinterpret_cast<uint4*>(y + col[i]) = po;
    }
  }
}

// One launch: CTAs enough for every row group, at most the number that
// fills the card once (SMs x the CTAs of this instantiation an SM holds)
template <int MODE, int V, int L>
inline int ln_launch(const LnArgs& p, cudaStream_t stream) {
  static int fill = 0;
  auto kern = layernorm_kernel<MODE, V, L>;
  if (fill == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, LN_THREADS, 0);
    fill = (sms > 0 ? sms : 1) * (per > 0 ? per : 1);
  }
  constexpr long long rows = (LN_THREADS / 32) * (32 / L);  // a CTA's rows a step
  const long long need = (p.R + rows - 1) / rows;
  const int grid = need < fill ? (int)need : fill;
  kern<<<grid, LN_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// The body for the width (kernels/layernorm.py `ln_body` mirrors it)
template <int MODE>
inline int ln_dispatch(const LnArgs& p, void* stream) {
  if (p.C <= 0 || p.C % 8 != 0 || p.C > 1024 || p.R <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (p.C) {
    case 24: return ln_launch<MODE, 3, 1>(p, st);
    case 48: return ln_launch<MODE, 3, 2>(p, st);
    case 96: return ln_launch<MODE, 3, 4>(p, st);
    case 192: return ln_launch<MODE, 3, 8>(p, st);
    case 384: return ln_launch<MODE, 3, 16>(p, st);
    case 768: return ln_launch<MODE, 3, 32>(p, st);
    default: return ln_launch<MODE, 4, 32>(p, st);
  }
}

}  // namespace sodt

extern "C" int sodt_layernorm(const void* x, const void* g, const void* beta, void* y, int R,
                              int C, float eps, void* stream) {
  const sodt::LnArgs p{x, nullptr, (const float*)g, (const float*)beta, nullptr,
                       (sodt::bf16*)y, R, C, eps, 0, 0, 0};
  return sodt::ln_dispatch<sodt::LN_ROWS>(p, stream);
}

extern "C" int sodt_add_layernorm(const void* a, const void* b, const void* g,
                                  const void* beta, void* sum, void* y, int R, int C,
                                  float eps, void* stream) {
  const sodt::LnArgs p{a, (const sodt::bf16*)b, (const float*)g, (const float*)beta, sum,
                       (sodt::bf16*)y, R, C, eps, 0, 0, 0};
  return sodt::ln_dispatch<sodt::LN_ADD>(p, stream);
}

// x: (R, C) f32 rows -> y (R, C) bf16; K2's LN2 (its launches count as K2's)
extern "C" int sodt_layernorm_f32rows(const void* x, const void* g, const void* beta, void* y,
                                      int R, int C, float eps, void* stream) {
  const sodt::LnArgs p{x, nullptr, (const float*)g, (const float*)beta, nullptr,
                       (sodt::bf16*)y, R, C, eps, 0, 0, 0};
  return sodt::ln_dispatch<sodt::LN_F32ROWS>(p, stream);
}

// K4's front (its launches count as K4's): x, a (R = B * H * W, C) bf16 ->
// res1 (R, C) f32 = x + a un-shifted by `shift`, y (R, C) bf16 = LN(res1)
extern "C" int sodt_unshift_add_layernorm(const void* x, const void* a, const void* g,
                                          const void* beta, void* res1, void* y, int R, int H,
                                          int W, int C, int shift, float eps, void* stream) {
  if (H <= 0 || W <= 0 || R % ((long long)H * W) != 0 || shift < 0 || shift >= H ||
      shift >= W)
    return (int)cudaErrorInvalidValue;
  const sodt::LnArgs p{x, (const sodt::bf16*)a, (const float*)g, (const float*)beta, res1,
                       (sodt::bf16*)y, R, C, eps, H, W, shift};
  return sodt::ln_dispatch<sodt::LN_UNSHIFT_ADD>(p, stream);
}
