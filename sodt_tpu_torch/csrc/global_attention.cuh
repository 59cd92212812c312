// Pieces that K8 (global_attention.cu) and K10 (global_attention_bwd.cu)
// share: bf16 tensor-core products issued from registers (mma.sync
// m16n8k16, f32 accumulation, through the helpers of mma_sync.cuh) with
// operands brought from shared memory by ldmatrix, a cp.async copy ring,
// and the flash-style forward body, which K10 also runs (in its statistics
// mode) when it is not handed K8's log-sum-exp.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane l, g = l / 4,
// t = l % 4. The accumulator of a 16 x 8 tile holds rows g (c0, c1) and
// g + 8 (c2, c3) at columns 2t, 2t + 1. The A operand (16 x 16, row major)
// holds a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..), a2 = (g, 2t+8..),
// a3 = (g + 8, 2t+8..), so two neighbouring accumulator tiles re-pack into
// one A operand with no data movement across lanes (P and dS stay in the
// registers they were computed in).
#pragma once

#include "mma_sync.cuh"

namespace sodt {

constexpr float GA_LOG2E = 1.4426950408889634f;
constexpr float GA_LN2 = 0.6931471805599453f;

// The addressing of one window: map index of token t of window `win`
// (b * nW + window index) in a (B, H, W, .) map cut into ws x ws windows.
// The copies compute it for every 16-byte chunk, so the three divisions
// by runtime values go through multiply-shift reciprocals: n / d =
// (n * ceil(2^40 / d)) >> 40, exact for n, d < 2^20.
struct GaWindows {
  int H, W, ws, gx, nw;
  int wsh;                           // log2(ws) when ws is a power of two, else -1
  unsigned long long rws, rgx, rnw;  // ceil(2^40 / d)
  static GaWindows make(int H, int W, int ws) {
    auto rcp = [](int d) { return ((1ull << 40) + d - 1) / (unsigned long long)d; };
    const int gx = W / ws, nw = (H / ws) * gx;
    int wsh = -1;
    for (int k = 0; k < 31; ++k)
      if ((1 << k) == ws) wsh = k;
    return GaWindows{H, W, ws, gx, nw, wsh, rcp(ws), rcp(gx), rcp(nw)};
  }
  __device__ __forceinline__ static int quot(int n, unsigned long long r) {
    return (int)(((unsigned long long)n * r) >> 40);
  }
  __device__ __forceinline__ size_t tok(int win, int t) const {
    const int b = quot(win, rnw), widx = win - b * nw;
    const int wr = quot(widx, rgx), wc = widx - wr * gx;
    const int tr = quot(t, rws), tc = t - tr * ws;
    return (size_t)(b * H + wr * ws + tr) * W + wc * ws + tc;
  }
};

// rows x (cols * 4 floats) of an f32 matrix (row stride ld_src) into shared
// memory (row stride ld_dst), 16 bytes per cp.async
__device__ __forceinline__ void cp_f32_tile(float* dst, int ld_dst, const float* src,
                                            size_t ld_src, int rows, int cols4) {
  for (int v = threadIdx.x; v < rows * cols4; v += blockDim.x) {
    const int r = v / cols4, c = (v % cols4) * 4;
    cp_async16(dst + r * ld_dst + c, src + (size_t)r * ld_src + c, true);
  }
}

// bf16 slices (HD wide, starting at column col) of the tokens t0..t0+rows-1
// of a window, from a token-major map of row pitch `pitch`. t0 is a
// multiple of rows (32 or 64); with a power-of-two window the tile's tokens
// then sit at fixed offsets (r / ws) * W + r % ws from token t0, so only
// t0's map index takes the divisions.
template <int HD>
__device__ __forceinline__ void cp_rows(bf16* dst, int ld, const bf16* src, int pitch, int col,
                                        const GaWindows& m, int win, int t0, int rows) {
  constexpr int VPR = HD / 8;
  const bf16* p0 = src + m.tok(win, t0) * pitch + col;
  for (int v = threadIdx.x; v < rows * VPR; v += blockDim.x) {
    const int r = v / VPR, cv = (v % VPR) * 8;
    const bf16* p = m.wsh >= 0
                        ? p0 + (size_t)(((r >> m.wsh) * m.W + (r & (m.ws - 1))) * pitch) + cv
                        : src + m.tok(win, t0 + r) * pitch + col + cv;
    cp_async16(dst + r * ld + cv, p, true);
  }
}

// ---------------------------------------------------------------------------
// Flash-style forward body. One CTA of 4 warps owns 64 query rows of one
// (window, head); warp w the rows 16w..16w+15, whose scores, softmax state
// and output accumulator live in its registers for the whole key loop.
// 64-key blocks of K, V and the f32 bias (+ mask) tile come through a
// GA_STAGES-deep cp.async ring, so block j+1's copies overlap block j's
// products, with one barrier per block. Three modes:
//   GA_FORWARD        K8: q scaled in bf16 before QK^T (the Pallas body),
//                     bf16 output;
//   GA_FORWARD_STATS  the same output, and for K10 each row's natural
//                     log-sum-exp and O in f32 (below);
//   GA_STATS          K10's statistics when K8's are not at hand: S =
//                     (q k^T) * scale + bias in f32 (the backward's S),
//                     log-sum-exp and delta = rowsum(dO * O).
// delta must be rowsum(dP * P) with P in f32, as the Pallas body forms it:
// from a PV product whose P was rounded to bf16 it misses DBIAS_TOL (read
// 1.04e-3 of max |dbias| over four masked windows). So the two statistics
// modes also accumulate P's rounding residue, P - bf16(P) (exact in f32,
// itself rounded to bf16: 2^-18 of P), times V into a second accumulator;
// the output (GA_FORWARD_STATS) still comes from the bf16 P alone.
// ---------------------------------------------------------------------------
constexpr int GA_KB = 64, GA_STAGES = 2, GA_WARPS = 4;
constexpr int GA_Q = 16 * GA_WARPS;  // query rows of a CTA
enum { GA_FORWARD = 0, GA_FORWARD_STATS = 1, GA_STATS = 2 };

template <int HD>
struct GaLayout {
  static constexpr int LDH = HD + 8;     // bf16 row stride: conflict-free ldmatrix
  static constexpr int LDB = GA_KB + 8;  // f32 row stride of the bias / mask tiles
  static constexpr int KV = GA_KB * LDH;  // bf16 elements of one K (or V) tile
  static constexpr int BT = GA_Q * LDB;   // floats of one bias (or mask) tile
  __host__ __device__ static size_t stage_bytes(bool mask) {
    return (size_t)2 * KV * 2 + (size_t)(mask ? 2 : 1) * BT * 4;
  }
  __host__ __device__ static size_t smem_bytes(bool mask) {
    return GA_STAGES * stage_bytes(mask);
  }
};

template <int HD, int MODE>
__global__ void __launch_bounds__(GA_WARPS * 32)
global_attn_fwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                       const float* __restrict__ mask, bf16* __restrict__ out,
                       float* __restrict__ lse_out, float* __restrict__ o_full,
                       const bf16* __restrict__ gy, float* __restrict__ delta_out, GaWindows m,
                       int C, int nh, int total, float scale) {
  using L = GaLayout<HD>;
  constexpr bool FWD = MODE != GA_STATS;  // K8's S and output
  constexpr bool LO = MODE != GA_FORWARD;  // P's rounding residue, for delta
  constexpr int NLO = LO ? HD / 8 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const bool has_mask = mask != nullptr;
  const size_t stage = L::stage_bytes(has_mask);
  auto Ks = [&](int s) { return reinterpret_cast<bf16*>(smem + s * stage); };
  auto Vs = [&](int s) { return Ks(s) + L::KV; };
  auto Bs = [&](int s) { return reinterpret_cast<float*>(Vs(s) + L::KV); };
  auto Ms = [&](int s) { return Bs(s) + L::BT; };

  const int N = m.ws * m.ws;
  const int nqb = N / GA_Q;
  // raster: the windows (batch fastest) of one (head, query block) are
  // neighbours in launch order, so its bias tile comes from HBM ~once
  const int win = blockIdx.x % total;
  const int qb = (blockIdx.x / total) % nqb;
  const int h = blockIdx.x / (total * nqb);
  const int q0 = qb * GA_Q, widx = win % m.nw;
  const int C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* base = qkv + h * HD;
  const float* bias_q = bias + ((size_t)h * N + q0) * N;
  const float* mask_q = has_mask ? mask + ((size_t)widx * N + q0) * N : nullptr;

  auto issue = [&](int kb, int s) {
    const int k0 = kb * GA_KB;
    cp_rows<HD>(Ks(s), L::LDH, base, C3, C, m, win, k0, GA_KB);
    cp_rows<HD>(Vs(s), L::LDH, base, C3, 2 * C, m, win, k0, GA_KB);
    cp_f32_tile(Bs(s), L::LDB, bias_q + k0, N, GA_Q, GA_KB / 4);
    if (has_mask) cp_f32_tile(Ms(s), L::LDB, mask_q + k0, N, GA_Q, GA_KB / 4);
  };

  // Q goes through the last stage's K tile, then into registers as A
  // operands; the loop's first barrier comes before that stage is refilled
  const int nkb = N / GA_KB;
  cp_rows<HD>(Ks(GA_STAGES - 1), L::LDH, base, C3, 0, m, win, q0, GA_Q);
  issue(0, 0);
  cp_async_commit();
#pragma unroll
  for (int i = 1; i < GA_STAGES - 1; ++i) {
    if (i < nkb) issue(i, i);
    cp_async_commit();
  }
  cp_async_wait<GA_STAGES - 2>();
  __syncthreads();
  // warp w owns rows 16w .. 16w + 15
  unsigned qa[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    ldsm_x4(qa[ks], a_tile_addr(Ks(GA_STAGES - 1), L::LDH, warp * 16, ks * 16, lane));
    if constexpr (FWD) {  // q * scale, rounded to bf16 (the Pallas body)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&qa[ks][e]);
        qa[ks][e] = pack_bf16(__bfloat162float(v.x) * scale, __bfloat162float(v.y) * scale);
      }
    }
  }

  const float s_mul = (FWD ? 1.0f : scale) * GA_LOG2E;
  const int rloc = warp * 16 + g;  // this lane's first row in the CTA tile
  float o[HD / 8][4], ol[NLO][4];
  float mx[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.0f, 0.0f};  // log2 domain
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
#pragma unroll
  for (int i = 0; i < NLO; ++i) ol[i][0] = ol[i][1] = ol[i][2] = ol[i][3] = 0.0f;

  for (int kb = 0; kb < nkb; ++kb) {
    // block kb has landed and every warp is done with block kb - 1, whose
    // stage now takes block kb + GA_STAGES - 1: one barrier per block
    cp_async_wait<GA_STAGES - 2>();
    __syncthreads();
    if (kb + GA_STAGES - 1 < nkb) issue(kb + GA_STAGES - 1, (kb + GA_STAGES - 1) % GA_STAGES);
    cp_async_commit();
    const int s = kb % GA_STAGES;

    float sc[GA_KB / 8][4];
#pragma unroll
    for (int i = 0; i < GA_KB / 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < GA_KB / 16; ++np) {
        unsigned b[4];
        ldsm_x4(b, b_tile_addr(Ks(s), L::LDH, np * 16, ks * 16, lane));
        mma_bf16(sc[2 * np], qa[ks], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qa[ks], b[2], b[3]);
      }
    }
    // S (+ bias, + mask) in the log2 domain, the running max per row
    float rmax[2] = {mx[0], mx[1]};
#pragma unroll
    for (int nt = 0; nt < GA_KB / 8; ++nt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int off = (rloc + 8 * hr) * L::LDB + nt * 8 + 2 * t4;
        float2 bv = *reinterpret_cast<const float2*>(Bs(s) + off);
        if (has_mask) {
          const float2 mv = *reinterpret_cast<const float2*>(Ms(s) + off);
          bv.x += mv.x;
          bv.y += mv.y;
        }
        float& x0 = sc[nt][2 * hr];
        float& x1 = sc[nt][2 * hr + 1];
        x0 = x0 * s_mul + bv.x * GA_LOG2E;
        x1 = x1 * s_mul + bv.y * GA_LOG2E;
        rmax[hr] = fmaxf(rmax[hr], fmaxf(x0, x1));
      }
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rmax[hr] = fmaxf(rmax[hr], __shfl_xor_sync(0xffffffffu, rmax[hr], 1));
      rmax[hr] = fmaxf(rmax[hr], __shfl_xor_sync(0xffffffffu, rmax[hr], 2));
      alpha[hr] = exp2f(mx[hr] - rmax[hr]);
      mx[hr] = rmax[hr];
      lsum[hr] *= alpha[hr];
    }
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
      if constexpr (LO) {
        ol[i][0] *= alpha[0];
        ol[i][1] *= alpha[0];
        ol[i][2] *= alpha[1];
        ol[i][3] *= alpha[1];
      }
    }
    // P = exp(S - m) in f32 for the sums, bf16 for PV, from the same registers
    unsigned pa[GA_KB / 16][4], pl[LO ? GA_KB / 16 : 1][4];  // P, and its residue
#pragma unroll
    for (int nt = 0; nt < GA_KB / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = exp2f(sc[nt][e] - mx[e >> 1]);
        lsum[e >> 1] += sc[nt][e];
      }
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(sc[nt][0], sc[nt][1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(sc[nt][2], sc[nt][3]);
      if constexpr (LO) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(&pa[nt >> 1][(nt & 1) * 2 + hr]);
          pl[nt >> 1][(nt & 1) * 2 + hr] =
              pack_bf16(sc[nt][2 * hr] - __low2float(r), sc[nt][2 * hr + 1] - __high2float(r));
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < GA_KB / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        unsigned b[4];
        ldsm_x4_t(b, b_tile_addr_t(Vs(s), L::LDH, kk * 16, np * 16, lane));
        mma_bf16(o[2 * np], pa[kk], b[0], b[1]);
        mma_bf16(o[2 * np + 1], pa[kk], b[2], b[3]);
        if constexpr (LO) {
          mma_bf16(ol[2 * np], pl[kk], b[0], b[1]);
          mma_bf16(ol[2 * np + 1], pl[kk], b[2], b[3]);
        }
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    lsum[hr] += __shfl_xor_sync(0xffffffffu, lsum[hr], 1);
    lsum[hr] += __shfl_xor_sync(0xffffffffu, lsum[hr], 2);
    inv[hr] = 1.0f / lsum[hr];
  }
  const size_t srow = ((size_t)win * nh + h) * N + q0 + rloc;  // stats index, row g
  if constexpr (FWD) {
    bf16* ob = out + h * HD;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const size_t tk = m.tok(win, q0 + rloc + 8 * hr);
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const int c = nt * 8 + 2 * t4;
        *reinterpret_cast<unsigned*>(ob + tk * C + c) =
            pack_bf16(o[nt][2 * hr] * inv[hr], o[nt][2 * hr + 1] * inv[hr]);
        if constexpr (LO)
          *reinterpret_cast<float2*>(o_full + tk * C + h * HD + c) =
              make_float2((o[nt][2 * hr] + ol[nt][2 * hr]) * inv[hr],
                          (o[nt][2 * hr + 1] + ol[nt][2 * hr + 1]) * inv[hr]);
      }
    }
  } else {
    const bf16* gb = gy + h * HD;
    float d[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const bf16* grow = gb + m.tok(win, q0 + rloc + 8 * hr) * C;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const __nv_bfloat162 gv =
            *reinterpret_cast<const __nv_bfloat162*>(grow + nt * 8 + 2 * t4);
        d[hr] += __bfloat162float(gv.x) * (o[nt][2 * hr] + ol[nt][2 * hr]) +
                 __bfloat162float(gv.y) * (o[nt][2 * hr + 1] + ol[nt][2 * hr + 1]);
      }
      d[hr] += __shfl_xor_sync(0xffffffffu, d[hr], 1);
      d[hr] += __shfl_xor_sync(0xffffffffu, d[hr], 2);
      d[hr] *= inv[hr];
    }
    if (t4 == 0) {
      delta_out[srow] = d[0];
      delta_out[srow + 8] = d[1];
    }
  }
  if (LO && t4 == 0) {  // natural log-sum-exp
    lse_out[srow] = (mx[0] + log2f(lsum[0])) * GA_LN2;
    lse_out[srow + 8] = (mx[1] + log2f(lsum[1])) * GA_LN2;
  }
}

// Launch the forward body for head dims 16..128 (multiples of 16).
template <int MODE>
inline int launch_global_fwd(const void* qkv, const void* bias, const void* mask, void* out,
                             float* lse, float* o_full, const void* gy, float* delta, int B,
                             int H, int W,
                             int C, int nh, int ws, float scale, cudaStream_t stream) {
  const int hd = C / nh, N = ws * ws;
  const int total = B * (H / ws) * (W / ws);
  const GaWindows m = GaWindows::make(H, W, ws);
  const dim3 grid(nh * (N / GA_Q) * total);
  int err = (int)cudaErrorInvalidValue;
  auto go = [&](auto kern, size_t smem, int& set) {
    ensure_smem(kern, smem, set);
    kern<<<grid, GA_WARPS * 32, smem, stream>>>(
        (const bf16*)qkv, (const float*)bias, (const float*)mask, (bf16*)out, lse, o_full,
        (const bf16*)gy, delta, m, C, nh, total, scale);
    err = (int)cudaGetLastError();
  };
#define SODT_GA_CASE(D)                                                               \
  case D: {                                                                           \
    static int set = 0;                                                               \
    go(global_attn_fwd_kernel<D, MODE>, GaLayout<D>::smem_bytes(mask != nullptr), set); \
    break;                                                                            \
  }
  switch (hd) {
    SODT_GA_CASE(16)
    SODT_GA_CASE(32)
    SODT_GA_CASE(48)
    SODT_GA_CASE(64)
    SODT_GA_CASE(80)
    SODT_GA_CASE(96)
    SODT_GA_CASE(112)
    SODT_GA_CASE(128)
    default:
      break;
  }
#undef SODT_GA_CASE
  return err;
}

}  // namespace sodt
