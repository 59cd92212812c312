// The tensor-core GEMM core of K6, K7 and K2:
//
//   out[m, n] = bf16(epi(sum_k A[m, k] * W[n, k] + b[n]))
//
// W is a torch Linear weight (N, K), read K-contiguous. It replaces the
// bodies of sodt_tpu/pallas/swin_block.py `_mlp_tail_kernel` (K6,
// `fused_mlp_tail`) and `_conv_tail_noln_kernel` + `_conv_gelu_fc2` (K7,
// `fused_conv_mlp_tail_noln`): K6 is two launches (fc1 + GELU, then fc2 +
// the residual), K7 three (fc1, the 2x2 conv as one GEMM over a gathered
// A + GELU, fc2 + the residual). The hidden activation and f1 go through
// device memory in bf16, which are the Pallas kernels' own rounding points.
// K2 (swin_block_chain.cu) runs four of its launches: qkv, the projection
// with its f32 residual, fc1 and fc2.
//
// What bounds it on the H100: operations. At stage 2 of the flagship
// (M = 16384 tokens, C = 384, hidden 1536) K6 is 38.7 GFLOP, 39 us at the
// bf16 peak, against ~15 us for its bytes, the hidden's round trip included.
//
// Design:
//  * CTA tile 128 x BN (BN 128 where N > 512, else 96), two warpgroups of
//    wgmma m64nBNk16 (bf16 in, f32 accumulators in registers, operands
//    from shared memory), 64-deep K steps;
//  * the tiles are stored K-major with the 128-byte swizzle (rows of 128
//    bytes, 16-byte chunk c of row r at chunk c ^ (r % 8), 1024-byte atoms
//    of 8 rows), written by cp.async through a STAGES-deep ring with one
//    barrier per K step; each warpgroup keeps one K step's wgmma in flight
//    while the next is issued, so the ring runs STAGES - 2 steps ahead;
//  * N tiles fastest in the grid: the CTAs that read one A row block run
//    side by side and A comes from HBM about once (W stays in L2);
//  * A loaders: GC_ROWS, the rows of an (M, K) activation; GC_CONV2X2, the
//    implicit-GEMM gather of the 2x2 conv over f1 (M = B*H*W tokens, C
//    channels, K = 4C in (kh, kw, in) order: the (out, 2, 2, in) conv
//    weight viewed as (C, 4C) is W as it stands). Each 16-byte chunk (8
//    channels) lies in one tap t = k / C (C % 8 == 0); token (b, i, j)
//    reads f1 at (b, i + (t >> 1), j + (t & 1)), and a tap below the last
//    row or right of the last column, like a row past M or a column past
//    K, is zero-filled by cp.async with source size 0: the bottom/right
//    pad of fc1's output (the TPU kernel's zeroed last-strip halo);
//  * the epilogue stages the f32 accumulators in the ring's shared memory
//    and writes 16-byte chunks of 8 columns: f32 arithmetic and one bf16
//    rounding, GC_GELU (+ b, tanh GELU), GC_BIAS (+ b), GC_RESIDUAL
//    (+ b + r, r read in bf16); and two for K2's f32 residual stream,
//    which is never rounded: GC_RESIDUAL_OUT_F32 (+ b + r, r read in bf16,
//    the sum written in f32, no rounding) and GC_RESIDUAL_F32 (+ b + r, r
//    read in f32, one bf16 rounding).
// No atomics and no split-K: repeats are bit-equal. The kernel allocates
// nothing; the wrapper allocates every output and scratch buffer.
#pragma once

#include "mma_sync.cuh"

namespace sodt {

enum { GC_ROWS = 0, GC_CONV2X2 = 1 };                // A loaders
enum {  // epilogues
  GC_GELU = 0,
  GC_BIAS = 1,
  GC_RESIDUAL = 2,
  GC_RESIDUAL_OUT_F32 = 3,
  GC_RESIDUAL_F32 = 4
};

struct GemmArgs {
  const bf16* A;     // (M, K); GC_CONV2X2: f1 (M, C) with C = K / 4
  const bf16* W;     // (N, K)
  const bf16* bias;  // (N,)
  const bf16* R;     // (M, N), GC_RESIDUAL and GC_RESIDUAL_OUT_F32
  bf16* out;         // (M, N), but for GC_RESIDUAL_OUT_F32
  int M, N, K;
  int H, Wd;         // GC_CONV2X2: the map's height and width
  const float* R32;  // (M, N), GC_RESIDUAL_F32
  float* out32;      // (M, N), GC_RESIDUAL_OUT_F32
};

// cp.async of 16 bytes to a shared-window address (zero-filled unless pred)
__device__ __forceinline__ void cp_async16_s(unsigned dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0));
}

// The copies of one 64-deep K step into the swizzled tiles of a stage:
// each of the 256 threads moves the 16-byte chunk cc = tid % 8 of rows
// ar + 32 q (ar = tid / 8) of the 128 x 64 A tile and of the BN x 64 W
// tile. Row r's chunk c lands at byte r * 128 + 16 (c ^ (r % 8)), and
// r % 8 = ar % 8 for all of a thread's rows.
template <int LOADER, int BN>
struct GcCopy {
  static constexpr int BK = 64, A_PASSES = 128 / 32, W_PASSES = BN / 32;
  static_assert(BN % 32 == 0, "whole copy passes");
  const bf16* ga;  // this thread's first A row (GC_ROWS: at its chunk)
  const bf16* gw;  // this thread's first W row, at its chunk
  // per pass: bit 0 row < M; GC_CONV2X2: bit 1 row i + 1 exists, bit 2 col j + 1
  unsigned aok[A_PASSES];
  unsigned dst;            // the chunk's byte offset in a stage's tile, first row
  int cc, ar, C, kt, kch;  // GC_CONV2X2: tap and channel of the next K step's chunk

  __device__ __forceinline__ GcCopy(const GemmArgs& p, int m0, int n0, int tid) {
    cc = tid % 8;
    ar = tid / 8;
    dst = (unsigned)(ar * 128 + ((cc ^ (ar & 7)) << 4));
    C = p.K / 4;
#pragma unroll
    for (int q = 0; q < A_PASSES; ++q) {
      const int m = m0 + ar + q * 32;
      aok[q] = m < p.M;
      if constexpr (LOADER == GC_CONV2X2) {
        const int j = m % p.Wd, i = (m / p.Wd) % p.H;
        aok[q] |= ((i + 1 < p.H) << 1) | ((j + 1 < p.Wd) << 2);
      }
    }
    if constexpr (LOADER == GC_CONV2X2) {
      ga = p.A + (size_t)(m0 + ar) * C;
      kt = cc * 8 / C;
      kch = cc * 8 - kt * C;
    } else {
      ga = p.A + (size_t)(m0 + ar) * p.K + cc * 8;
    }
    gw = p.W + (size_t)(n0 + ar) * p.K + cc * 8;
  }

  // K step kb into the tiles at shared addresses sa (A) and sw (W); called
  // for kb = 0, 1, 2, ... in order (GC_CONV2X2 steps its tap along)
  __device__ __forceinline__ void issue(const GemmArgs& p, int kb, int n0, unsigned sa,
                                        unsigned sw) {
    const int k = kb * BK + cc * 8;  // the chunk's column
    if constexpr (LOADER == GC_CONV2X2) {
      const size_t o = ((size_t)(kt >> 1) * p.Wd + (kt & 1)) * C + kch;
      const unsigned need = 1u | ((kt >> 1) << 1) | ((kt & 1) << 2);
#pragma unroll
      for (int q = 0; q < A_PASSES; ++q) {
        const bool ok = kt < 4 && (aok[q] & need) == need;
        cp_async16_s(sa + dst + q * 32 * 128, ok ? ga + (size_t)q * 32 * C + o : p.A, ok);
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

// wgmma's shared-memory matrix descriptor of a K-major tile with the
// 128-byte swizzle: start address, leading offset 16 B (unused by this
// layout), 1024 bytes between 8-row atoms, layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t gc_wgmma_desc(unsigned saddr) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[12][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[16][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

// Pins the accumulators in their registers around the asynchronous wgmma
// that reads and writes them (the compiler may not move them meanwhile).
template <int NI>
__device__ __forceinline__ void gc_fence_acc(float (&d)[NI][4]) {
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

template <int BN, int STAGES>
struct GcLayout {
  static constexpr int BM = 128, BK = 64, NI = BN / 8;
  static constexpr unsigned A_BYTES = BM * 128, STAGE = (BM + BN) * 128;
  static constexpr int LDS = BN + 4;  // f32 row stride of the output staging tile
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 1024;  // + the 1024-byte alignment
  static constexpr int MIN_CTAS = 2 * SMEM <= 227 * 1024 ? 2 : 1;
  static_assert(BN % 16 == 0 && STAGES >= 3, "tile shape");
  static_assert((size_t)BM * LDS * 4 <= (size_t)STAGES * STAGE, "staging fits in the ring");
};

template <int LOADER, int EPI, int BN, int STAGES>
__global__ void __launch_bounds__(256, (GcLayout<BN, STAGES>::MIN_CTAS))
    gemm_core_kernel(GemmArgs p) {
  using L = GcLayout<BN, STAGES>;
  constexpr int BM = L::BM, BK = L::BK, NI = L::NI, PD = STAGES - 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const unsigned raw = smem_addr(smem), base = (raw + 1023u) & ~1023u;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int nk = (p.K + BK - 1) / BK;
  GcCopy<LOADER, BN> cp(p, m0, n0, tid);
  auto load = [&](int kb, int s) {
    cp.issue(p, kb, n0, base + s * L::STAGE, base + s * L::STAGE + L::A_BYTES);
  };

  float acc[NI][4];
#pragma unroll
  for (int j = 0; j < NI; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

#pragma unroll
  for (int s = 0; s < PD; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    // step kb has landed, and every warpgroup has retired its wgmma of
    // step kb - 2, whose stage now takes step kb + PD: one barrier per step.
    // The copies went through the generic proxy, wgmma reads through the
    // async proxy
    cp_async_wait<PD - 1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kb + PD < nk) load(kb + PD, (kb + PD) % STAGES);
    cp_async_commit();
    const unsigned sa = base + (kb % STAGES) * L::STAGE + wg * 64 * 128;
    const unsigned sb = base + (kb % STAGES) * L::STAGE + L::A_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    gc_fence_acc(acc);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      if constexpr (BN == 128)
        wgmma_m64n128k16(acc, gc_wgmma_desc(sa + ks * 32), gc_wgmma_desc(sb + ks * 32));
      else
        wgmma_m64n96k16(acc, gc_wgmma_desc(sa + ks * 32), gc_wgmma_desc(sb + ks * 32));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    gc_fence_acc(acc);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  gc_fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the ring: it takes the staging tile

  // epilogue: lane (g, t4) of warp w in its warpgroup holds rows 16 w + g
  // (+ 8) of the warpgroup's 64, columns 8 j + 2 t4 (+ 1)
  float* st = reinterpret_cast<float*>(smem + (base - raw));
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + g;
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<float2*>(st + (r0 + 8 * hr) * L::LDS + j * 8 + 2 * t4) =
          make_float2(acc[j][2 * hr], acc[j][2 * hr + 1]);
  __syncthreads();
  // 8 columns a thread: 16-byte loads of bias and a bf16 residual (32-byte
  // of an f32 one), 16-byte stores (32-byte in f32)
  for (int v = tid; v < BM * NI; v += 256) {
    const int r = v / NI, c = (v % NI) * 8;
    const int row = m0 + r, col = n0 + c;
    if (row >= p.M || col >= p.N) continue;  // N % 8 == 0
    const float4 x0 = *reinterpret_cast<const float4*>(st + r * L::LDS + c);
    const float4 x1 = *reinterpret_cast<const float4*>(st + r * L::LDS + c + 4);
    float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const uint4 bq = *reinterpret_cast<const uint4*>(p.bias + col);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bq);
    const size_t at = (size_t)row * p.N + col;
    uint4 rq = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (EPI == GC_RESIDUAL || EPI == GC_RESIDUAL_OUT_F32)
      rq = *reinterpret_cast<const uint4*>(p.R + at);
    const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rq);
    float rf[8];
    if constexpr (EPI == GC_RESIDUAL_F32) {
      *reinterpret_cast<float4*>(rf) = *reinterpret_cast<const float4*>(p.R32 + at);
      *reinterpret_cast<float4*>(rf + 4) = *reinterpret_cast<const float4*>(p.R32 + at + 4);
    }
    float y[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v0 = x[2 * e] + __low2float(b2[e]), v1 = x[2 * e + 1] + __high2float(b2[e]);
      if constexpr (EPI == GC_GELU) {
        v0 = gelu_tanh(v0);
        v1 = gelu_tanh(v1);
      } else if constexpr (EPI == GC_RESIDUAL || EPI == GC_RESIDUAL_OUT_F32) {
        v0 += __low2float(r2[e]);
        v1 += __high2float(r2[e]);
      } else if constexpr (EPI == GC_RESIDUAL_F32) {
        v0 += rf[2 * e];
        v1 += rf[2 * e + 1];
      }
      y[2 * e] = v0;
      y[2 * e + 1] = v1;
    }
    if constexpr (EPI == GC_RESIDUAL_OUT_F32) {
      *reinterpret_cast<float4*>(p.out32 + at) = make_float4(y[0], y[1], y[2], y[3]);
      *reinterpret_cast<float4*>(p.out32 + at + 4) = make_float4(y[4], y[5], y[6], y[7]);
    } else {
      *reinterpret_cast<uint4*>(p.out + at) =
          make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                     pack_bf16(y[6], y[7]));
    }
  }
}

template <int LOADER, int EPI, int BN, int STAGES>
inline int launch_gemm_core_tile(const GemmArgs& a, cudaStream_t stream) {
  using L = GcLayout<BN, STAGES>;
  if ((a.M + L::BM - 1) / L::BM > 65535) return (int)cudaErrorInvalidValue;
  static int smem_set = 0;
  auto kern = gemm_core_kernel<LOADER, EPI, BN, STAGES>;
  ensure_smem(kern, L::SMEM, smem_set);
  const dim3 grid((a.N + BN - 1) / BN, (a.M + L::BM - 1) / L::BM);
  kern<<<grid, 256, L::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// Tile widths: 128 for a wide N such as K6's fc1 (N = hidden 1536: 12
// column tiles); 96 for N <= 512, where M = 16384 gives 512 CTAs (1.94
// waves of two CTAs on each of 132 SMs) against 384 (1.45) with 128. The
// ring is as deep as two CTAs an SM allow: 3 stages of 128 x 128 (99 KB a
// CTA), 4 of 128 x 96 (113 KB); a fourth stage at 128 wide leaves one CTA
// an SM, and fc1 read slower so (PERF.md, PR 7).
template <int LOADER, int EPI>
inline int launch_gemm_core(const GemmArgs& a, cudaStream_t stream) {
  return a.N > 512 ? launch_gemm_core_tile<LOADER, EPI, 128, 3>(a, stream)
                   : launch_gemm_core_tile<LOADER, EPI, 96, 4>(a, stream);
}

}  // namespace sodt
