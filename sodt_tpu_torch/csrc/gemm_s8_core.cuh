// The s8 tensor-core GEMM core of K12's int8 bodies (int8_chains.cu: the
// twins of K2, K3 / K5, K4 / K7 and K6), and the per-row pass that makes
// their activation codes:
//
//   acc[m, n] = sum_k A[m, k] * W[n, k]           exact, int32
//   v[m, n]   = float(acc) * (sw[n] * sx(m))      rounded as JAX's
//                                                 acc.astype(f32) * (ws * sx)
//   out       = epi(m, n, v)
//
// A is a matrix of int8 codes (M, K) (or the 2x2 conv's gather over one),
// W the (N, K) int8 weight as `kernels/quant.py` builds it (per output
// channel scales sw), sx(m) the scale of row m's strip (quant.cuh says why
// a body is split into launches at its quantization points).
//
// What bounds it on the H100: at the flagship's stage 1 (M = 65,536
// tokens, C 192) K2's twin performs 58 GOP of s8 a call, 29 us at 1,979
// TOP/s, against ~0.65 GB its launches move (~0.2 ms at 3.35 TB/s); its
// GEMMs' main loops run at ~870 TOP/s (fc1: 22 us), their epilogues (the
// dequantization, GELU, codes and stores of 12.6 to 50 M outputs) take
// most of their time. The WMMA GEMM it replaced read A in f32 once per 64
// output columns and quantized it while staging, and every intermediate
// crossed device memory in f32 (30-50 TOP/s).
//
// Design:
//  * wgmma m64nBNk32 .s32.s8.s8, both operands from shared memory, int32
//    accumulators in registers; two warpgroups a CTA (128 rows, 64 each,
//    sharing the W tile), two CTAs an SM; BN = the whole N where N <= 192,
//    else equal widths of 192 (576 = 3 x 192, 768 = 4 x 192, 384 = 2 x
//    192) or 128, so a row block's codes come from device memory about
//    once (N tiles are fastest in the grid; W stays in L2);
//  * tiles stored K-major with the 128-byte swizzle (a row of 128 codes is
//    one 128-byte row: gemm_core.cuh's layout and descriptors, a k32 step
//    of s8 being 32 bytes like a k16 step of bf16), written by cp.async
//    through a STAGES-deep ring filled up front (K <= 256 arrives whole); a
//    stage takes the next step as soon as its wgmma is retired; a step's
//    k32 slices past K are not issued (K = 192 runs 6 slices, not 8);
//  * loaders (16-byte chunks of 16 codes): GS_ROWS, the rows of an (M, K)
//    code matrix; GS_CONV2X2, the 2x2 conv's implicit-GEMM gather over f1's
//    codes (K = 4C in (kh, kw, in) order, C % 16 == 0, so a chunk lies in
//    one tap): token (b, i, j) reads tap (di, dj) at row i + di, column
//    j + dj; below the last row of its strip that is the strip's halo row
//    (rows M.. of f1, one map row a strip, in strip order), right of the
//    last column it is a zero fill (the reference's pad on fc1's output);
//  * the epilogue stages the accumulators in the ring's shared memory (a
//    row stride of BN + 8 words: conflict-free) and gives each thread the
//    same 8-column chunks of four rows, so its weight scales and bias stay
//    in registers: the dequantization (`__fmul_rn`, no contraction), then
//    a terminal epilogue that writes the output (GsBf16, GsRes1, GsOut) or
//    a producer (GsGelu, GsBiasHalo) whose values feed the next
//    quantization point, each in the f32 order of the reference's int8
//    body. A producer launch runs in one of three modes: GS_FOLD folds max
//    |value| into the strip slots (atomicMax on the bit pattern: exact,
//    order-free) and stores nothing; GS_CODES recomputes the same values
//    and writes their int8 codes under the finished scale; GS_F32 stores
//    the f32 values and folds. The int32 sum is exact and both runs call
//    the same producer function with explicit rounding intrinsics, so
//    GS_FOLD and GS_CODES see the same f32 values (tests/
//    test_torch_port_cuda.py holds the codes to those of the stored
//    values). GELU's fold evaluates the GELU only where the largest value
//    can be (gelu_fold_threshold), exactly; the codes take the true
//    division only near a tie (q8_codes_rcp), exactly.
// No split-K and no atomics on an output: repeats are bit-equal.
#pragma once

#include "gemm_core.cuh"
#include "quant.cuh"

namespace sodt {

enum { GS_ROWS = 0, GS_CONV2X2 = 1 };            // A loaders
enum { GS_FOLD = 0, GS_CODES = 1, GS_F32 = 2 };  // what a producer launch writes

struct S8Args {
  const signed char* A;  // GS_ROWS: (M, K); GS_CONV2X2: f1 (M + halo rows, K / 4)
  const signed char* W;  // (N, K)
  const float* sw;       // (N,) the weight's scales
  const float* amax_in;  // A's strip slots
  Strips sin;            // the strip of an output row (= of its A rows)
  int M, N, K;
  int H, Wd, ws;          // GS_CONV2X2: M = B * H * Wd tokens, strips of ws map rows
  float* amax_out;        // producers: the slots of the next quantization point
  Strips sout;
  signed char* codes;     // GS_CODES: (M, N)
  float* f32;             // GS_F32: (M, N)
};

// tanh-GELU in f32 with every rounding explicit, so that two kernels that
// call it compute the same bits (common.cuh's gelu_tanh leaves the
// contraction to the compiler): 0.5 x (1 + tanh(x (k0 + k1 x^2))), with
// tanh(u) = sign(u) (1 - 2 / (1 + e^{2|u|})) on the card's exp2 (no branch:
// tanhf picks one of two forms per lane). From the errors of ex2.approx and
// of the approximate division, its absolute error is a few 1e-7 and
// GELU's relative error of order 3e-7, the size of tanhf's f32 noise.
__device__ __forceinline__ float tanh_rn(float u) {
  const float e = __expf(__fmul_rn(2.0f, fabsf(u)));
  return copysignf(__fsub_rn(1.0f, __fdividef(2.0f, __fadd_rn(1.0f, e))), u);
}

__device__ __forceinline__ float gelu_tanh_rn(float x) {
  const float k0 = 0.7978845608028654f;   // sqrt(2 / pi)
  const float k1 = 0.035677408136300125f;  // sqrt(2 / pi) * 0.044715
  const float u = __fmul_rn(x, __fmaf_rn(k1, __fmul_rn(x, x), k0));
  const float h = __fmul_rn(0.5f, x);
  return __fmaf_rn(h, tanh_rn(u), h);
}

// quant.cuh's q8_code(v, s) = clip(rint(v / s)) of N values, with the true
// division taken only near a tie: with inv = 1 / s rounded, d = v * inv is
// within 1.6e-5 of v / s for |v / s| < 128, so where d is 1e-4 or more from
// a half-integer both round to the same integer (and clip alike). The
// values near a tie (rare) take one branch for all N, to a division kept
// out of line.
__device__ __noinline__ signed char q8_code_tie(float v, float s) { return q8_code(v, s); }

template <int N>
__device__ __forceinline__ void q8_codes_rcp(const float* v, float s, float inv, char* q) {
  unsigned tie = 0;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float d = __fmul_rn(v[e], inv), r = rintf(d);
    tie |= (unsigned)(fabsf(__fsub_rn(fabsf(__fsub_rn(d, r)), 0.5f)) < 1e-4f) << e;
    q[e] = (char)max(-127, min(127, (int)r));
  }
  if (tie)
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (tie >> e & 1u) q[e] = q8_code_tie(v[e], s);
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(p);
  *reinterpret_cast<float4*>(v + 4) = *reinterpret_cast<const float4*>(p + 4);
}
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __low2float(h[e]);
    v[2 * e + 1] = __high2float(h[e]);
  }
}

// ------------------------------------------------------------- epilogues
// v[8]: the dequantized products of row m, columns n..n+7 (N % 16 == 0),
// bb[8] the bias there (bf16, staged in shared memory in f32). Terminal:
// prefetch(m, n, N, q) loads what the output adds (a few chunks' loads are
// in flight together), store(m, n, N, v, bb, q) writes it. Producer:
// value(m, v, bb) turns v into the values of the next quantization point,
// in place; GsGelu also as act(v + b).

struct NoPre {};

struct GsBf16 {  // bf16(v + b): qkv
  static constexpr bool PRODUCER = false, GELU = false;
  using Pre = NoPre;
  const bf16* b;
  bf16* out;
  __device__ __forceinline__ void prefetch(int, int, int, Pre&) const {}
  __device__ __forceinline__ void store(int m, int n, int N, const float (&v)[8],
                                        const float (&bb)[8], const Pre&) const {
    unsigned u[4];
    for (int e = 0; e < 4; ++e)
      u[e] = pack_bf16(__fadd_rn(v[2 * e], bb[2 * e]), __fadd_rn(v[2 * e + 1], bb[2 * e + 1]));
    *reinterpret_cast<uint4*>(out + (size_t)m * N + n) = make_uint4(u[0], u[1], u[2], u[3]);
  }
};

struct GsRes1 {  // (x + v) + b in f32: K2's first residual, never rounded
  static constexpr bool PRODUCER = false, GELU = false;
  struct Pre {
    float x[8];
  };
  const bf16* x;
  const bf16* b;
  float* out;
  __device__ __forceinline__ void prefetch(int m, int n, int N, Pre& q) const {
    load8(x + (size_t)m * N + n, q.x);
  }
  __device__ __forceinline__ void store(int m, int n, int N, const float (&v)[8],
                                        const float (&bb)[8], const Pre& q) const {
    float o[8];
    for (int e = 0; e < 8; ++e) o[e] = __fadd_rn(__fadd_rn(q.x[e], v[e]), bb[e]);
    const size_t e0 = (size_t)m * N + n;
    *reinterpret_cast<float4*>(out + e0) = *reinterpret_cast<const float4*>(o);
    *reinterpret_cast<float4*>(out + e0 + 4) = *reinterpret_cast<const float4*>(o + 4);
  }
};

// The block output in bf16: the residual resf (f32), or x (+ a read at its
// shifted position: K4's un-shift), then res_first ? (res + v) + b :
// res + (v + b), each in its body's order.
struct GsOut {
  static constexpr bool PRODUCER = false, GELU = false;
  struct Pre {
    float r[8];
  };
  const float* resf;
  const bf16 *x, *a;
  int H, W, shift;
  const bf16* b;
  bf16* out;
  int res_first;
  __device__ __forceinline__ void prefetch(int m, int n, int N, Pre& q) const {
    const size_t e0 = (size_t)m * N + n;
    if (resf) {
      load8(resf + e0, q.r);
    } else {
      load8(x + e0, q.r);
      if (a) {
        const int j = m % W, i = (m / W) % H, bi = m / (W * H);
        const size_t ar = (size_t)(bi * H + (i - shift + H) % H) * W + (j - shift + W) % W;
        float aa[8];
        load8(a + ar * N + n, aa);
        for (int e = 0; e < 8; ++e) q.r[e] = __fadd_rn(q.r[e], aa[e]);
      }
    }
  }
  __device__ __forceinline__ void store(int m, int n, int N, const float (&v)[8],
                                        const float (&bb)[8], const Pre& q) const {
    float o[8];
    for (int e = 0; e < 8; ++e)
      o[e] = res_first ? __fadd_rn(__fadd_rn(q.r[e], v[e]), bb[e])
                       : __fadd_rn(q.r[e], __fadd_rn(v[e], bb[e]));
    unsigned u[4];
    for (int e = 0; e < 4; ++e) u[e] = pack_bf16(o[2 * e], o[2 * e + 1]);
    *reinterpret_cast<uint4*>(out + (size_t)m * N + n) = make_uint4(u[0], u[1], u[2], u[3]);
  }
};

struct GsGelu {  // tanh-GELU(v + b): fc1 of K2, the conv of K4 / K7
  static constexpr bool PRODUCER = true, GELU = true;
  using Pre = NoPre;
  const bf16* b;
  __device__ __forceinline__ void prefetch(int, int, int, Pre&) const {}
  __device__ __forceinline__ static float act(float t) { return gelu_tanh_rn(t); }
  __device__ __forceinline__ void value(int, float (&v)[8], const float (&bb)[8]) const {
    for (int e = 0; e < 8; ++e) v[e] = act(__fadd_rn(v[e], bb[e]));
  }
};

// v + b; the halo rows of an image's last strip are 0 (the pad on fc1's
// output): fc1 of K4 / K7 over the map rows and the halo rows
struct GsBiasHalo {
  static constexpr bool PRODUCER = true, GELU = false;
  using Pre = NoPre;
  const bf16* b;
  int M0, W, nr;
  __device__ __forceinline__ void prefetch(int, int, int, Pre&) const {}
  __device__ __forceinline__ void value(int m, float (&v)[8], const float (&bb)[8]) const {
    const bool zero = m >= M0 && ((m - M0) / W) % nr == nr - 1;
    for (int e = 0; e < 8; ++e) v[e] = zero ? 0.0f : __fadd_rn(v[e], bb[e]);
  }
};

// The GELU fold's threshold for one thread's elements of one strip, whose
// largest pre-activation is t: G(x) = 0.5 x (1 + tanh(x (k0 + k1 x^2)))
// rises with slope >= 0.5 for x >= 0, and gelu_tanh_rn is within 3e-7 x of
// it, so where gelu_tanh_rn(t) >= 0.2 no element below t (1 - 1e-4) can
// reach the largest |GELU| (and a negative one stays under 0.171): only the
// elements at or above the threshold need evaluating. Else every one does.
__device__ __forceinline__ float gelu_fold_threshold(float t) {
  if (t == -INFINITY) return INFINITY;
  return gelu_tanh_rn(t) >= 0.2f ? __fmul_rn(t, 1.0f - 1e-4f) : -INFINITY;
}

// ---------------------------------------------------------------- loaders
// The copies of one 128-deep K step into the swizzled tiles of a stage:
// each of the 256 threads moves the 16-byte chunk cc = tid % 8 of rows
// ar + 32 q (ar = tid / 8) of the 128 x 128 A tile and of the BN x 128 W
// tile. Row r's chunk c lands at byte r * 128 + 16 (c ^ (r % 8)).
template <int LOADER, int BN>
struct GsCopy {
  static constexpr int BK = 128, A_PASSES = 128 / 32, W_PASSES = BN / 32;
  const signed char* ga;  // GS_ROWS: this thread's first A row, at its chunk
  const signed char* gw;  // this thread's first W row, at its chunk
  unsigned aok[A_PASSES];  // bit 0 row < M; GS_CONV2X2: bit 1 column j + 1 exists
  int row1[A_PASSES];      // GS_CONV2X2: the f1 row of tap di = 1 (next row, or the halo row)
  unsigned dst;
  int cc, ar, C, kt, kch;  // GS_CONV2X2: tap and channel of the next K step's chunk

  __device__ __forceinline__ GsCopy(const S8Args& p, int m0, int n0, int tid) {
    cc = tid % 8;
    ar = tid / 8;
    dst = (unsigned)(ar * 128 + ((cc ^ (ar & 7)) << 4));
    C = p.K / 4;
#pragma unroll
    for (int q = 0; q < A_PASSES; ++q) {
      const int m = m0 + ar + q * 32;
      aok[q] = m < p.M;
      if constexpr (LOADER == GS_CONV2X2) {
        const int j = m % p.Wd, i = (m / p.Wd) % p.H, b = m / (p.Wd * p.H);
        aok[q] |= (unsigned)(j + 1 < p.Wd) << 1;
        row1[q] = i % p.ws == p.ws - 1 ? p.M + (b * (p.H / p.ws) + i / p.ws) * p.Wd + j
                                       : m + p.Wd;
      }
    }
    if constexpr (LOADER == GS_CONV2X2) {
      kt = cc * 16 / C;
      kch = cc * 16 - kt * C;
    } else {
      ga = p.A + (size_t)(m0 + ar) * p.K + cc * 16;
    }
    gw = p.W + (size_t)(n0 + ar) * p.K + cc * 16;
  }

  // K step kb into the tiles at shared addresses sa (A) and sw (W); called
  // for kb = 0, 1, 2, ... in order (GS_CONV2X2 steps its tap along)
  __device__ __forceinline__ void issue(const S8Args& p, int m0, int kb, int n0, unsigned sa,
                                        unsigned sw) {
    const int k = kb * BK + cc * 16;  // the chunk's column
    if constexpr (LOADER == GS_CONV2X2) {
      const int di = kt >> 1, dj = kt & 1;
#pragma unroll
      for (int q = 0; q < A_PASSES; ++q) {
        const bool ok = kt < 4 && (aok[q] & 1u) && (!dj || (aok[q] & 2u));
        const int row = (di ? row1[q] : m0 + ar + q * 32) + dj;
        cp_async16_s(sa + dst + q * 32 * 128, ok ? p.A + (size_t)row * C + kch : p.A, ok);
      }
      kch += BK;
      while (kch >= C) {
        kch -= C;
        ++kt;
      }
    } else {
#pragma unroll
      for (int q = 0; q < A_PASSES; ++q) {
        const bool ok = aok[q] && k < p.K;
        cp_async16_s(sa + dst + q * 32 * 128, ok ? ga + (size_t)q * 32 * p.K + kb * BK : p.A,
                     ok);
      }
    }
#pragma unroll
    for (int q = 0; q < W_PASSES; ++q) {
      const bool ok = n0 + ar + q * 32 < p.N && k < p.K;
      cp_async16_s(sw + dst + q * 32 * 128, ok ? gw + (size_t)q * 32 * p.K + kb * BK : p.W, ok);
    }
  }
};

// ------------------------------------------------------------------ wgmma
// d += A (64 x 32, s8) . B (32 x N, s8), both K-major from shared memory

__device__ __forceinline__ void wgmma_s8_m64n64k32(int (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[16][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_m64n192k32(int (&d)[24][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n"
      "}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3]),
        "+r"(d[16][0]), "+r"(d[16][1]), "+r"(d[16][2]), "+r"(d[16][3]),
        "+r"(d[17][0]), "+r"(d[17][1]), "+r"(d[17][2]), "+r"(d[17][3]),
        "+r"(d[18][0]), "+r"(d[18][1]), "+r"(d[18][2]), "+r"(d[18][3]),
        "+r"(d[19][0]), "+r"(d[19][1]), "+r"(d[19][2]), "+r"(d[19][3]),
        "+r"(d[20][0]), "+r"(d[20][1]), "+r"(d[20][2]), "+r"(d[20][3]),
        "+r"(d[21][0]), "+r"(d[21][1]), "+r"(d[21][2]), "+r"(d[21][3]),
        "+r"(d[22][0]), "+r"(d[22][1]), "+r"(d[22][2]), "+r"(d[22][3]),
        "+r"(d[23][0]), "+r"(d[23][1]), "+r"(d[23][2]), "+r"(d[23][3])
      : "l"(da), "l"(db), "r"(1));
}

template <int NI>
__device__ __forceinline__ void gs_fence_acc(int (&d)[NI][4]) {
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[j][e])::"memory");
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 8][4], uint64_t da, uint64_t db) {
  if constexpr (BN == 192)
    wgmma_s8_m64n192k32(d, da, db);
  else if constexpr (BN == 128)
    wgmma_s8_m64n128k32(d, da, db);
  else
    wgmma_s8_m64n64k32(d, da, db);
}

template <int BN, int STAGES>
struct GsLayout {
  static constexpr int BM = 128, BK = 128, NI = BN / 8;
  static constexpr unsigned A_BYTES = BM * 128, STAGE = (BM + BN) * 128;
  // int32 row stride of the output staging tile: BN + 8 = 8 (mod 32), so
  // the accumulator fragments land on distinct banks
  static constexpr int LDS = BN + 8;
  static constexpr size_t RING = (size_t)STAGES * STAGE, STAGING = (size_t)BM * LDS * 4;
  static constexpr size_t SMEM = (RING > STAGING ? RING : STAGING) + 1024;  // + alignment
  static_assert(BN % 64 == 0 && STAGES >= 2, "tile shape");
  static_assert(2 * (SMEM + 1024 + 3 * 1024) <= 232448, "two CTAs an SM");
};

// The strips of a tile's rows: most tiles lie in one strip; a tile that
// spans two keeps a running max for each, a third (strips of fewer than 128
// rows: small maps) folds element by element.
template <int LOADER, class Epi, int MODE, int BN, int STAGES>
__global__ void __launch_bounds__(256, 2) gemm_s8_kernel(S8Args p, Epi epi) {
  using L = GsLayout<BN, STAGES>;
  constexpr int BM = L::BM, BK = L::BK, NI = L::NI;
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ float sx[BM], sxo[BM], sxi[BM], red[2][8];
  __shared__ __align__(16) float s_w[BN], s_b[BN];  // the tile's weight scales and bias
  const unsigned raw = smem_addr(smem), base = (raw + 1023u) & ~1023u;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = tid >> 7;
  const int nk = (p.K + BK - 1) / BK;
  if (tid < BM) {
    const int m = m0 + tid;
    sx[tid] = m < p.M ? q8_scale(p.amax_in[p.sin(m)]) : 1.0f;
    if constexpr (MODE == GS_CODES) {
      const float so = m < p.M ? q8_scale(p.amax_out[p.sout(m)]) : 1.0f;
      sxo[tid] = so;
      sxi[tid] = __frcp_rn(so);
    }
  }
  for (int c = tid; c < BN; c += 256) {
    s_w[c] = n0 + c < p.N ? p.sw[n0 + c] : 0.0f;
    s_b[c] = n0 + c < p.N ? __bfloat162float(epi.b[n0 + c]) : 0.0f;
  }
  GsCopy<LOADER, BN> cp(p, m0, n0, tid);
  auto load = [&](int kb, int s) {
    cp.issue(p, m0, kb, n0, base + s * L::STAGE, base + s * L::STAGE + L::A_BYTES);
  };

  int acc[NI][4];
#pragma unroll
  for (int j = 0; j < NI; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  // every stage is filled up front (K <= STAGES * 128: the whole K), and a
  // stage takes step kb + STAGES as soon as step kb's wgmma is retired
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    // step kb has landed; the copies went through the generic proxy, wgmma
    // reads through the async proxy
    cp_async_wait<STAGES - 1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const unsigned sa = base + (kb % STAGES) * L::STAGE + wg * 64 * 128;  // this warpgroup's rows
    const unsigned sb = base + (kb % STAGES) * L::STAGE + L::A_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    gs_fence_acc(acc);
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks)
      if (kb * BK + ks * 32 < p.K)
        wgmma_s8<BN>(acc, gc_wgmma_desc(sa + ks * 32), gc_wgmma_desc(sb + ks * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    gs_fence_acc(acc);
    __syncthreads();  // every warp is done with the stage
    if (kb + STAGES < nk) load(kb + STAGES, kb % STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the staging tile

  // lane (g, t4) of warp w holds rows 16 w + g (+ 8), columns 8 j + 2 t4 (+ 1)
  int* st = reinterpret_cast<int*>(smem + (base - raw));
  const int g = lane >> 2, t4 = lane & 3, r0 = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<int2*>(st + (r0 + 8 * hr) * L::LDS + j * 8 + 2 * t4) =
          make_int2(acc[j][2 * hr], acc[j][2 * hr + 1]);
  __syncthreads();

  // Thread t takes the 8-column chunks cq + 8 q (cq = t % 8, q < NI / 8) of
  // rows t / 8 + 32 k (k < 4): its weight scales and bias are loaded once,
  // and a warp covers 4 rows of 8 contiguous chunks. The dequantization has
  // no contraction into an FMA (the product rounds as JAX's does).
  constexpr int QN = NI / 8, RK = 4;
  static_assert(BM == 32 * RK && NI % 8 == 0, "the epilogue's chunks");
  const int cq = tid & 7, rb = tid >> 3;
  float swq[QN][8], bbq[QN][8];
  bool qok[QN];
#pragma unroll
  for (int q = 0; q < QN; ++q) {
    const int c = (cq + 8 * q) * 8;
    qok[q] = n0 + c < p.N;
    load8(s_w + c, swq[q]);
    load8(s_b + c, bbq[q]);
  }
  int rowk[RK], srk[RK];
#pragma unroll
  for (int k = 0; k < RK; ++k) {
    rowk[k] = m0 + rb + 32 * k;
    srk[k] = p.sout(min(rowk[k], p.M - 1));
  }
  auto deq = [&](int k, int q, float (&y)[8]) {
    const int r = rb + 32 * k;
    const int* sr = st + r * L::LDS + (cq + 8 * q) * 8;
    const int4 a0 = *reinterpret_cast<const int4*>(sr);
    const int4 a1 = *reinterpret_cast<const int4*>(sr + 4);
    const int a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float s = sx[r];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = __fmul_rn((float)a[e], __fmul_rn(swq[q][e], s));
  };
  const int s_first = p.sout(m0), s_last = p.sout(min(m0 + BM, p.M) - 1);
  float mx0 = 0.0f, mx1 = 0.0f;

  if constexpr (Epi::PRODUCER && MODE == GS_FOLD && Epi::GELU) {
    // the fold of a GELU (gelu_fold_threshold): the two largest
    // pre-activations of each strip; the GELU of the largest, and of the
    // others only where the second reaches the threshold or the largest
    // GELU is small. Rows in a third strip (small maps) fold one by one
    float t0 = -INFINITY, u0 = -INFINITY, t1 = -INFINITY, u1 = -INFINITY;
#pragma unroll
    for (int q = 0; q < QN; ++q)
#pragma unroll
      for (int k = 0; k < RK; ++k) {
        if (!qok[q] || rowk[k] >= p.M) continue;
        float y[8];
        deq(k, q, y);
        if (srk[k] == s_first || srk[k] == s_last) {
          float& t = srk[k] == s_first ? t0 : t1;
          float& u = srk[k] == s_first ? u0 : u1;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float x = __fadd_rn(y[e], bbq[q][e]);
            u = fmaxf(u, fminf(t, x));
            t = fmaxf(t, x);
          }
        } else {
          epi.value(rowk[k], y, bbq[q]);
          float am = 0.0f;
#pragma unroll
          for (int e = 0; e < 8; ++e) am = fmaxf(am, fabsf(y[e]));
          atomic_max_nonneg(p.amax_out + srk[k], am);
        }
      }
    const float th0 = gelu_fold_threshold(t0), th1 = gelu_fold_threshold(t1);
    if (th0 > -INFINITY && t0 > -INFINITY) mx0 = fabsf(Epi::act(t0));
    if (th1 > -INFINITY && t1 > -INFINITY) mx1 = fabsf(Epi::act(t1));
    if (u0 >= th0 || u1 >= th1) {
#pragma unroll
      for (int q = 0; q < QN; ++q)
#pragma unroll
        for (int k = 0; k < RK; ++k) {
          if (!qok[q] || rowk[k] >= p.M) continue;
          const float th = srk[k] == s_first ? th0 : srk[k] == s_last ? th1 : INFINITY;
          float y[8];
          deq(k, q, y);
          float am = 0.0f;
          for (int e = 0; e < 8; ++e) {
            const float x = __fadd_rn(y[e], bbq[q][e]);
            if (x >= th) am = fmaxf(am, fabsf(Epi::act(x)));
          }
          if (srk[k] == s_first)
            mx0 = fmaxf(mx0, am);
          else if (srk[k] == s_last)
            mx1 = fmaxf(mx1, am);
        }
    }
  } else {
#pragma unroll
    for (int q = 0; q < QN; ++q) {
      if (!qok[q]) continue;
      const int col = n0 + (cq + 8 * q) * 8;
      typename Epi::Pre pre[RK];
#pragma unroll
      for (int k = 0; k < RK; ++k)
        if (rowk[k] < p.M) epi.prefetch(rowk[k], col, p.N, pre[k]);
#pragma unroll
      for (int k = 0; k < RK; ++k) {
        if (rowk[k] >= p.M) continue;
        const int row = rowk[k];
        float y[8];
        deq(k, q, y);
        if constexpr (!Epi::PRODUCER) {
          epi.store(row, col, p.N, y, bbq[q], pre[k]);
        } else {
          epi.value(row, y, bbq[q]);
          const size_t e0 = (size_t)row * p.N + col;
          if constexpr (MODE == GS_CODES) {
            const int r = rb + 32 * k;
            const float so = sxo[r], si = sxi[r];
            char qc[8];
            q8_codes_rcp<8>(y, so, si, qc);
            *reinterpret_cast<uint2*>(p.codes + e0) = *reinterpret_cast<const uint2*>(qc);
          } else {
            if constexpr (MODE == GS_F32) {
              *reinterpret_cast<float4*>(p.f32 + e0) = *reinterpret_cast<const float4*>(y);
              *reinterpret_cast<float4*>(p.f32 + e0 + 4) =
                  *reinterpret_cast<const float4*>(y + 4);
            }
            float am = 0.0f;
#pragma unroll
            for (int e = 0; e < 8; ++e) am = fmaxf(am, fabsf(y[e]));
            if (srk[k] == s_first)
              mx0 = fmaxf(mx0, am);
            else if (srk[k] == s_last)
              mx1 = fmaxf(mx1, am);
            else
              atomic_max_nonneg(p.amax_out + srk[k], am);
          }
        }
      }
    }
  }
  if constexpr (Epi::PRODUCER && MODE != GS_CODES) {
    mx0 = warp_max(mx0);
    mx1 = warp_max(mx1);
    if (lane == 0) red[0][warp] = mx0, red[1][warp] = mx1;
    __syncthreads();
    if (tid < 2) {
      float m = red[tid][0];
      for (int w = 1; w < 8; ++w) m = fmaxf(m, red[tid][w]);
      if (tid == 0 || s_last != s_first) atomic_max_nonneg(p.amax_out + (tid ? s_last : s_first), m);
    }
  }
}

template <int LOADER, int MODE, int BN, int STAGES, class Epi>
inline int launch_gemm_s8_tile(const S8Args& a, const Epi& epi, cudaStream_t stream) {
  using L = GsLayout<BN, STAGES>;
  static int smem_set = 0;
  auto kern = gemm_s8_kernel<LOADER, Epi, MODE, BN, STAGES>;
  ensure_smem(kern, L::SMEM, smem_set);
  const dim3 grid((a.N + BN - 1) / BN, (a.M + L::BM - 1) / L::BM);
  kern<<<grid, 256, L::SMEM, stream>>>(a, epi);
  return (int)cudaGetLastError();
}

// The tile width for an output width N: N itself (rounded up to 64) up to
// 192, else equal widths of 192 or 128, else 192 with a ragged last tile.
// Two CTAs an SM (the staging tile, 128 x (BN + 4) int32, shares the ring):
// 2 stages of 128 x 128 + 192 x 128 codes (80 KB, staging 98 KB), 3 of 128
// wide (96 KB), 4 of 64 wide (96 KB).
inline int gs_width(int N) {
  if (N <= 192) return (N + 63) / 64 * 64;
  return N % 192 == 0 ? 192 : N % 128 == 0 ? 128 : 192;
}

template <int LOADER, int MODE, class Epi>
inline int launch_gemm_s8(const S8Args& a, const Epi& epi, cudaStream_t stream) {
  if (a.M <= 0 || a.N <= 0 || a.N % 16 || a.K <= 0 || a.K % 32 ||
      (a.M + 127) / 128 > 65535 || (LOADER == GS_CONV2X2 && (a.K / 4) % 16))
    return (int)cudaErrorInvalidValue;
  switch (gs_width(a.N)) {
    case 64:
      return launch_gemm_s8_tile<LOADER, MODE, 64, 4>(a, epi, stream);
    case 128:
      return launch_gemm_s8_tile<LOADER, MODE, 128, 3>(a, epi, stream);
    default:
      return launch_gemm_s8_tile<LOADER, MODE, 192, 2>(a, epi, stream);
  }
}

// ------------------------------------------------------------ row passes
// A CTA of 8 warps takes 16 consecutive rows, a warp 2 of them (rows w and
// w + 8), both loaded before either is reduced; a row's values
// stay in registers (4 channels a lane at c = 4 lane + 128 i, C <= 128 V,
// C % 4 == 0), read once. With LN the values are LN(row) * g + b
// (statistics E[x^2] - mu^2, eps 1e-5: `_ln_rows_vpu`) with every rounding
// explicit, so the folding run and the run that writes the codes compute
// the same values; with BF16 they are then rounded to bf16 (K3's LN output,
// which the reference quantizes in the working dtype). The fold reduces
// over the CTA before its atomicMax.
constexpr int RP_ROWS = 2;

template <class P>  // a row source that hands out a pointer to element (m, c)
struct Ptr4 {
  P p;
  __device__ __forceinline__ void load(int m, int c, float v[4]) const { load4(p(m, c), v); }
};

// LN of a warp's rows in place (the one function both runs of a
// quantization point call), the rows' butterfly reductions interleaved;
// lanes past C hold zeros and keep them
template <int V>
__device__ __forceinline__ void q8_rows_ln(float (&v)[RP_ROWS][V][4], int C, int lane,
                                           const float* g, const float* b) {
  float s[RP_ROWS], s2[RP_ROWS];
#pragma unroll
  for (int k = 0; k < RP_ROWS; ++k) {
    s[k] = s2[k] = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[k] = __fadd_rn(s[k], v[k][i][e]);
        s2[k] = __fmaf_rn(v[k][i][e], v[k][i][e], s2[k]);
      }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < RP_ROWS; ++k) {
      s[k] = __fadd_rn(s[k], __shfl_xor_sync(0xffffffffu, s[k], o));
      s2[k] = __fadd_rn(s2[k], __shfl_xor_sync(0xffffffffu, s2[k], o));
    }
#pragma unroll
  for (int k = 0; k < RP_ROWS; ++k) {
    const float mu = __fdiv_rn(s[k], (float)C);
    const float var = __fsub_rn(__fdiv_rn(s2[k], (float)C), __fmul_rn(mu, mu));
    const float rstd = rsqrtf(__fadd_rn(var, 1e-5f));
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = 4 * lane + 128 * i;
      if (c < C)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[k][i][e] = __fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(v[k][i][e], mu), rstd), g[c + e]), b[c + e]);
    }
  }
}

// MODE GS_FOLD: max |value| into the strip slots; GS_CODES: the codes
// under the strip's finished scale, (rows, C) int8; GS_F32: the values in
// f32 and the fold
template <bool LN, int MODE, int V, bool BF16, class Src>
__global__ void __launch_bounds__(256)
q8_rowpass_kernel(Src src, int rows, int C, const float* __restrict__ g,
                  const float* __restrict__ b, float* __restrict__ amax, Strips strips,
                  signed char* __restrict__ codes, float* __restrict__ f32) {
  __shared__ float red[8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * 8 * RP_ROWS;
  // every load first, with no branch between them (rows past the end and
  // lanes past C read a valid element, then drop it)
  float v[RP_ROWS][V][4], so[RP_ROWS], si[RP_ROWS];
#pragma unroll
  for (int k = 0; k < RP_ROWS; ++k) {
    const int row = min(row0 + warp + 8 * k, rows - 1);
    if constexpr (MODE == GS_CODES) so[k] = amax[strips(row)];
#pragma unroll
    for (int i = 0; i < V; ++i) src.load(row, min(4 * lane + 128 * i, C - 4), v[k][i]);
  }
#pragma unroll
  for (int k = 0; k < RP_ROWS; ++k) {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (4 * lane + 128 * i >= C) v[k][i][0] = v[k][i][1] = v[k][i][2] = v[k][i][3] = 0.0f;
    if constexpr (MODE == GS_CODES) {
      so[k] = q8_scale(so[k]);
      si[k] = __frcp_rn(so[k]);
    }
  }
  if constexpr (LN) q8_rows_ln(v, C, lane, g, b);
  if constexpr (BF16)
#pragma unroll
    for (int k = 0; k < RP_ROWS; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[k][i][e] = __bfloat162float(__float2bfloat16_rn(v[k][i][e]));
  const int s0 = strips(row0);
  float mx = 0.0f;
#pragma unroll
  for (int k = 0; k < RP_ROWS; ++k) {
    const int row = row0 + warp + 8 * k;
    if (row >= rows) continue;  // a whole warp
    float am = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = 4 * lane + 128 * i;
      if (c >= C) continue;
      const size_t e0 = (size_t)row * C + c;
      if constexpr (MODE == GS_CODES) {
        char q[4];
        q8_codes_rcp<4>(v[k][i], so[k], si[k], q);
        *reinterpret_cast<char4*>(codes + e0) = *reinterpret_cast<const char4*>(q);
      } else {
        if constexpr (MODE == GS_F32)
          *reinterpret_cast<float4*>(f32 + e0) =
              make_float4(v[k][i][0], v[k][i][1], v[k][i][2], v[k][i][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) am = fmaxf(am, fabsf(v[k][i][e]));
      }
    }
    if constexpr (MODE != GS_CODES) {
      am = warp_max(am);
      if (strips(row) == s0)
        mx = fmaxf(mx, am);
      else if (lane == 0)
        atomic_max_nonneg(amax + strips(row), am);
    }
  }
  if constexpr (MODE != GS_CODES) {
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    if (threadIdx.x == 0) {
      float m = red[0];
      for (int w = 1; w < 8; ++w) m = fmaxf(m, red[w]);
      atomic_max_nonneg(amax + s0, m);
    }
  }
}

template <bool LN, int MODE, bool BF16 = false, class Src>
inline int q8_rowpass(const Src& src, int rows, int C, const void* g, const void* b,
                      float* amax, Strips strips, void* codes, float* f32,
                      cudaStream_t stream) {
  if (rows <= 0 || C % 4 || C > 512) return (int)cudaErrorInvalidValue;
  const int grid = (rows + 8 * RP_ROWS - 1) / (8 * RP_ROWS);
  if (C <= 256)
    q8_rowpass_kernel<LN, MODE, 2, BF16><<<grid, 256, 0, stream>>>(
        src, rows, C, (const float*)g, (const float*)b, amax, strips, (signed char*)codes, f32);
  else
    q8_rowpass_kernel<LN, MODE, 4, BF16><<<grid, 256, 0, stream>>>(
        src, rows, C, (const float*)g, (const float*)b, amax, strips, (signed char*)codes, f32);
  return (int)cudaGetLastError();
}

}  // namespace sodt
