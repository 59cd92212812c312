// The windowed attention forward for windows of up to 64 tokens, with the
// scores in registers: K1 (sodt_tpu/pallas/window_attention.py
// _strip_kernel), K11's forward (_kernel), K5's shifted core
// (_block_attn_kernel's attention) and the bf16 cores of K12's int8
// bodies. Per (window, head), as the Pallas forwards compute it:
//   out = softmax(bf16(q * bf16(scale)) K^T + bias (+ mask)) V
// q is scaled in bf16 before QK^T (the scale itself rounded to bf16, as
// `q * jnp.asarray(scale, dtype)` does; K9 instead scales the f32 scores),
// the scores and the softmax are f32, P is rounded to bf16 before PV, and
// the output is rounded once, at the store.
//
// What bounds it on the H100: the function moves 4 * C * 2 bytes per token
// (q, k, v read, out written) against 4 * N * C operations, so bytes, by
// ~10x at N = 64 against the bf16 peak. On an NVIDIA H100 80GB HBM3 at
// 700 W the kernel runs at 1.8-2.4x that bound at the flagship's and
// SwinV2's shapes (PERF.md, §6): at 164-168 registers a thread (head
// dims 16 / 32) three CTAs fit an SM, and one wave of them timed best; a
// 128-register cap for four was slower at all but one shape.
//
// Design (K9's body, window_attention_bwd.cuh, less dP, dS and dbias). One
// CTA of 4 warps per (head, group of windows), the head fastest in the
// raster, so the CTAs that read the same token rows run side by side. A
// stage holds 64 token rows of the head's Q, K and V: one window at
// N <= 64 padded to 64, four at N <= 16 padded to 16 (warp w then takes
// window slot w). Stages come through a two-stage cp.async ring (with the
// 64 mask rows, when there is a mask), so the next windows load while
// these compute. Per warp, 16 query rows, all in registers: S = Q K^T with
// mma.sync m16n8k16 on ldmatrix operands (the q fragments scaled and
// rounded to bf16 as they come), the bias and the mask added in log2 units
// (the bias rows of the warp's queries sit in registers for the whole CTA,
// which owns one head; keys >= n folded in as -inf), the softmax with quad
// shuffles and ex2.approx, P rounded to bf16 and packed straight from the
// accumulator into the A fragments of O = P V, with V read by
// ldmatrix.trans. No score touches shared memory. O is staged by stmatrix
// into the warp's own Q rows (read by no other warp) and stored 16 bytes a
// lane. The TPU kernels' strip and pack layout (_pick_pack) is not carried
// over.
//
// Four addressings (the template parameter Addr), each taking its runtime
// divisions once per window and once per kernel for a thread's token
// offsets, never per 16-byte copy: FwdMap (the unpartitioned map at shift
// 0, K9's WrMap: K1, K12, K2), FwdShiftedMap (read at ((r + s) mod H,
// (c + s) mod W) and written at (r, c), the wrap a compare-and-subtract:
// K5), FwdRolledMap (read AND written at ((r + s) mod H, (c + s) mod W):
// K2's shifted blocks, whose output then stays in map order) and FwdTokens
// (pre-partitioned (Wn, N, 3C) windows, the mask of window w is
// mask[w mod nw]: K11).
#pragma once

#include "mma_sync.cuh"
#include "window_attention.cuh"

namespace sodt {

// NP: the window padded to 16 or 64 tokens
template <int HD, int NP>
struct WfLayout {
  static constexpr int LDH = HD + 8;          // bf16 rows: conflict-free ldmatrix
  static constexpr int LDM = NP + 8;          // f32 mask rows: conflict-free float2
  static constexpr int TILE = WR_ROWS * LDH;  // bf16 elements of Q (K, V)
  __host__ __device__ static size_t stage_bytes(bool mask) {
    return (size_t)3 * TILE * 2 + (mask ? (size_t)WR_ROWS * LDM * 4 : 0);
  }
  __host__ __device__ static size_t smem_bytes(bool mask) { return 2 * stage_bytes(mask); }
};

// K1 and K12's cores: the map at shift 0. Token t of window win sits
// m.offset(t) rows past the window's first row m.base(win).
struct FwdMap {
  WrMap m;
  typedef int Tok;
  struct Win {
    size_t base;
    int widx;  // the window's index within its image: its mask
  };
  __device__ __forceinline__ Tok token(int t) const { return m.offset(t); }
  __device__ __forceinline__ Win window(int win) const {
    Win w;
    w.base = m.base(win, w.widx);
    return w;
  }
  __device__ __forceinline__ size_t src(const Win& w, Tok k) const { return w.base + k; }
  __device__ __forceinline__ size_t dst(const Win& w, Tok k) const { return w.base + k; }
};

// K5's core: token (r, c) of a window is read at ((r + shift) mod H,
// (c + shift) mod W) and written at (r, c), 0 < shift < ws; since
// r + shift < 2H the modulo is one compare-and-subtract.
struct FwdShiftedMap {
  int H, W, ws, gx, nw, shift;
  struct Tok {
    int tr, tc;  // the token's row and column within its window
  };
  struct Win {
    size_t img;      // the image's first map row
    int r0, c0;      // the window's first row and column
    int widx;
  };
  __device__ __forceinline__ Tok token(int t) const {
    const int tr = t / ws;
    return Tok{tr, t - tr * ws};
  }
  __device__ __forceinline__ Win window(int win) const {
    const int b = win / nw, widx = win - b * nw;
    const int wr = widx / gx, wc = widx - wr * gx;
    return Win{(size_t)b * H * W, wr * ws, wc * ws, widx};
  }
  __device__ __forceinline__ size_t src(const Win& w, Tok k) const {
    int r = w.r0 + shift + k.tr, c = w.c0 + shift + k.tc;
    r -= r >= H ? H : 0;
    c -= c >= W ? W : 0;
    return w.img + (size_t)r * W + c;
  }
  __device__ __forceinline__ size_t dst(const Win& w, Tok k) const {
    return w.img + (size_t)(w.r0 + k.tr) * W + w.c0 + k.tc;
  }
};

// K2's core at a shift: FwdShiftedMap's windows of the rolled map, but each
// token's output goes back to where its q, k, v were read, so the block's
// per-token steps around the core need no roll at all.
struct FwdRolledMap : FwdShiftedMap {
  __device__ __forceinline__ size_t dst(const Win& w, Tok k) const { return src(w, k); }
};

// K11: pre-partitioned windows (Wn, n, .): token t of window win is row
// win * n + t; the mask of window win is mask[win mod nw].
struct FwdTokens {
  int n, nw;
  typedef int Tok;
  struct Win {
    size_t base;
    int widx;
  };
  __device__ __forceinline__ Tok token(int t) const { return t; }
  __device__ __forceinline__ Win window(int win) const {
    return Win{(size_t)win * n, win % nw};
  }
  __device__ __forceinline__ size_t src(const Win& w, Tok k) const { return w.base + k; }
  __device__ __forceinline__ size_t dst(const Win& w, Tok k) const { return w.base + k; }
};

// bf16(x * s) of both halves of a bf16x2 register (the product of two bf16
// values is exact in f32, so this rounds once, as a bf16 multiply does)
__device__ __forceinline__ unsigned scale_bf16x2(unsigned v, float s) {
  return pack_bf16(__uint_as_float(v << 16) * s, __uint_as_float(v & 0xffff0000u) * s);
}

// grid (nh * groups): CTA b takes head b % nh and group b / nh, which walks
// the stages (chunks of 64 / NP windows) group, group + groups, ...; qkv
// rows are 3C wide ([q | k | v]), out rows C wide; mask may be null; scale
// is already rounded to bf16
template <int HD, int NP, class Addr>
__global__ void __launch_bounds__(WR_WARPS * 32)
window_attn_fwd_kernel(Addr a, const bf16* __restrict__ qkv, const float* __restrict__ bias,
                       const float* __restrict__ mask, bf16* __restrict__ out, int C, int nh,
                       int n, float scale, int total, int groups) {
  using L = WfLayout<HD, NP>;
  using Tok = typename Addr::Tok;
  using Win = typename Addr::Win;
  constexpr int WPI = WR_ROWS / NP;  // windows of a stage
  constexpr int NT = NP / 8;         // n8 key tiles of a score row
  constexpr int DT = HD / 8;         // n8 tiles of a head row
  constexpr int VPR = HD / 8;        // 16-byte pieces of a head row
  extern __shared__ __align__(128) unsigned char smem[];
  const bool has_mask = mask != nullptr;
  const size_t stage = L::stage_bytes(has_mask);
  auto Qs = [&](int s) { return reinterpret_cast<bf16*>(smem + s * stage); };
  auto Ms = [&](int s) { return reinterpret_cast<float*>(Qs(s) + 3 * L::TILE); };

  const int h = blockIdx.x % nh, grp = blockIdx.x / nh;
  const int chunks = (total + WPI - 1) / WPI;
  const int C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;       // the warp's 16 rows of the stage
  const int wb = (r0 / NP) * NP;  // the first row of its window in the stage
  const int rw = r0 - wb;         // its first row within the window
  const int slot = r0 / NP;

  // the bias rows of this warp's queries in log2 units (the softmax takes
  // 2^x), in the accumulator layout; keys >= n get -inf, padding query rows
  // any finite row (they are not stored)
  float bs[NT][4];
  const float* bias_h = bias + (size_t)h * n * n;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rw + g + 8 * (e >> 1), col = nt * 8 + 2 * t4 + (e & 1);
      bs[nt][e] = col >= n ? -INFINITY : row < n ? bias_h[row * n + col] * WR_LOG2E : 0.0f;
    }

  // this thread's copies: their tokens, fixed per kernel
  constexpr int ITEMS = WR_ROWS * VPR / (WR_WARPS * 32);
  Tok ltok[ITEMS];
  bool lok[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int t = ((threadIdx.x + k * WR_WARPS * 32) / VPR) % NP;
    lok[k] = t < n;
    ltok[k] = a.token(lok[k] ? t : 0);
  }
  // window slot sl of stage `chunk`, and whether it exists
  auto window_at = [&](int chunk, int sl, bool& ok) -> Win {
    const int win = chunk * WPI + sl;
    ok = win < total;
    return a.window(ok ? win : 0);
  };

  auto issue = [&](int chunk, int s) {
    bool ok0;
    const Win w0 = window_at(chunk, 0, ok0);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int v = threadIdx.x + k * WR_WARPS * 32;
      const int r = v / VPR, cv = (v % VPR) * 8;
      bool ok = ok0;
      Win w = w0;
      if (WPI > 1) w = window_at(chunk, r / NP, ok);
      ok = ok && lok[k];
      const size_t p = ok ? a.src(w, ltok[k]) : 0;
      const bf16* src = qkv + p * C3 + h * HD + cv;
      bf16* dst = Qs(s) + r * L::LDH + cv;
      cp_async16(dst, src, ok);
      cp_async16(dst + L::TILE, src + C, ok);
      cp_async16(dst + 2 * L::TILE, src + 2 * C, ok);
    }
    if (has_mask) {
      float* mdst = Ms(s);
      // (r, c): row r of the stage, key c; r / NP the window slot
      auto copy = [&](int r, int c, bool wide) {
        bool ok = ok0;
        Win w = w0;
        if (WPI > 1) w = window_at(chunk, r / NP, ok);
        const int t = r % NP;
        ok = ok && t < n && c < n;
        const float* src = ok ? mask + ((size_t)w.widx * n + t) * n + c : mask;
        if (wide)
          cp_async16(mdst + r * L::LDM + c, src, ok);
        else
          cp_async4(mdst + r * L::LDM + c, src, ok);
      };
      if ((n & 3) == 0) {  // 16-byte pieces of whole rows
#pragma unroll
        for (int k = 0; k < WR_ROWS * NP / 4 / (WR_WARPS * 32); ++k) {
          const int v = threadIdx.x + k * WR_WARPS * 32;
          copy(v / (NP / 4), (v % (NP / 4)) * 4, true);
        }
      } else {
        for (int v = threadIdx.x; v < WR_ROWS * NP; v += WR_WARPS * 32)
          copy(v / NP, v % NP, false);
      }
    }
    cp_async_commit();
  };

  // this lane's 16-byte pieces of the warp's 16 output rows: their tokens
  constexpr int OV = HD / 16;
  Tok otok[OV];
  bool ook[OV];
#pragma unroll
  for (int k = 0; k < OV; ++k) {
    const int t = rw + (lane + 32 * k) / VPR;
    ook[k] = t < n;
    otok[k] = a.token(ook[k] ? t : 0);
  }

  issue(grp, 0);
  int s = 0;
  for (int chunk = grp; chunk < chunks; chunk += groups, s ^= 1) {
    cp_async_wait<0>();  // this stage has landed,
    __syncthreads();     // and every warp is done with the other one
    if (chunk + groups < chunks) issue(chunk + groups, s ^ 1);
    bf16* Q = Qs(s);
    const bf16* K = Q + L::TILE;
    const bf16* V = Q + 2 * L::TILE;

    // S = bf16(q * scale) K^T
    unsigned qa[HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      ldsm_x4(qa[ks], a_tile_addr(Q, L::LDH, r0, ks * 16, lane));
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[ks][i] = scale_bf16x2(qa[ks][i], scale);
    }
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < NP / 16; ++kt)
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        unsigned b[4];
        ldsm_x4(b, b_tile_addr(K, L::LDH, wb + kt * 16, ks * 16, lane));
        mma_bf16(sc[2 * kt], qa[ks], b[0], b[1]);
        mma_bf16(sc[2 * kt + 1], qa[ks], b[2], b[3]);
      }
    // + bias (+ mask) in log2 units; rows g (hr 0) and g + 8 (hr 1) of the
    // tile
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float x0 = fmaf(sc[nt][2 * hr], WR_LOG2E, bs[nt][2 * hr]);
        float x1 = fmaf(sc[nt][2 * hr + 1], WR_LOG2E, bs[nt][2 * hr + 1]);
        if (has_mask) {
          const float2 mv = *reinterpret_cast<const float2*>(
              Ms(s) + (r0 + g + 8 * hr) * L::LDM + nt * 8 + 2 * t4);
          x0 = fmaf(mv.x, WR_LOG2E, x0);
          x1 = fmaf(mv.y, WR_LOG2E, x1);
        }
        sc[nt][2 * hr] = x0;
        sc[nt][2 * hr + 1] = x1;
        mx[hr] = fmaxf(mx[hr], fmaxf(x0, x1));
      }
    float sm[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) mx[hr] = quad_max(mx[hr]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = ex2_approx(sc[nt][e] - mx[e >> 1]);
        sm[e >> 1] += sc[nt][e];
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) sm[hr] = 1.0f / quad_sum(sm[hr]);

    // O = P V: P normalized in f32, rounded to bf16 and packed from the
    // accumulator into A fragments (rows g | g + 8, keys of tile kt)
    float acc[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < NP / 16; ++kt) {
      const unsigned pa[4] = {
          pack_bf16(sc[2 * kt][0] * sm[0], sc[2 * kt][1] * sm[0]),
          pack_bf16(sc[2 * kt][2] * sm[1], sc[2 * kt][3] * sm[1]),
          pack_bf16(sc[2 * kt + 1][0] * sm[0], sc[2 * kt + 1][1] * sm[0]),
          pack_bf16(sc[2 * kt + 1][2] * sm[1], sc[2 * kt + 1][3] * sm[1])};
#pragma unroll
      for (int dt = 0; dt < HD / 16; ++dt) {
        unsigned b[4];
        ldsm_x4_t(b, b_tile_addr_t(V, L::LDH, wb + kt * 16, dt * 16, lane));
        mma_bf16(acc[2 * dt], pa, b[0], b[1]);
        mma_bf16(acc[2 * dt + 1], pa, b[2], b[3]);
      }
    }

    // O as bf16, staged by stmatrix in the warp's own Q rows, stored 16
    // bytes a lane
    bool wok;
    const Win w = window_at(chunk, slot, wok);
    bf16* st = Q + r0 * L::LDH;
#pragma unroll
    for (int dt = 0; dt < HD / 16; ++dt)
      stsm_x4(a_tile_addr(st, L::LDH, 0, dt * 16, lane),
              pack_bf16(acc[2 * dt][0], acc[2 * dt][1]),
              pack_bf16(acc[2 * dt][2], acc[2 * dt][3]),
              pack_bf16(acc[2 * dt + 1][0], acc[2 * dt + 1][1]),
              pack_bf16(acc[2 * dt + 1][2], acc[2 * dt + 1][3]));
    __syncwarp();
#pragma unroll
    for (int k = 0; k < OV; ++k) {
      const int e = lane + 32 * k, cv = (e % VPR) * 8;
      if (wok && ook[k])
        *reinterpret_cast<uint4*>(out + a.dst(w, otok[k]) * C + h * HD + cv) =
            *reinterpret_cast<const uint4*>(st + (e / VPR) * L::LDH + cv);
    }
  }
}

template <int HD, int NP, class Addr>
inline int launch_window_attn_fwd(const Addr& a, const void* qkv, const void* bias,
                                  const void* mask, void* out, int total, int C, int nh,
                                  int n, float scale, int groups, cudaStream_t stream) {
  static int smem_set = 0;
  const size_t smem = WfLayout<HD, NP>::smem_bytes(mask != nullptr);
  const int chunks = (total + WR_ROWS / NP - 1) / (WR_ROWS / NP);
  if (smem > SMEM_MAX || groups < 1 || groups > chunks || (long long)nh * groups > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  ensure_smem(window_attn_fwd_kernel<HD, NP, Addr>, smem, smem_set);
  window_attn_fwd_kernel<HD, NP, Addr><<<nh * groups, WR_WARPS * 32, smem, stream>>>(
      a, (const bf16*)qkv, (const float*)bias, (const float*)mask, (bf16*)out, C, nh, n, scale,
      total, groups);
  return (int)cudaGetLastError();
}

// the instantiation for the window's padding (16 or 64 tokens) and the
// head dim (16, 32, 48 or 64)
template <class Addr>
inline int dispatch_window_attn_fwd(const Addr& a, const void* qkv, const void* bias,
                                    const void* mask, void* out, int total, int C, int nh,
                                    int n, float scale, int groups, cudaStream_t st) {
  if (n > 64 || C % nh != 0) return (int)cudaErrorInvalidValue;
  const bool small = n <= 16;
  switch (C / nh) {
    case 16: return small ? launch_window_attn_fwd<16, 16>(a, qkv, bias, mask, out, total, C, nh, n, scale, groups, st)
                          : launch_window_attn_fwd<16, 64>(a, qkv, bias, mask, out, total, C, nh, n, scale, groups, st);
    case 32: return small ? launch_window_attn_fwd<32, 16>(a, qkv, bias, mask, out, total, C, nh, n, scale, groups, st)
                          : launch_window_attn_fwd<32, 64>(a, qkv, bias, mask, out, total, C, nh, n, scale, groups, st);
    case 48: return small ? launch_window_attn_fwd<48, 16>(a, qkv, bias, mask, out, total, C, nh, n, scale, groups, st)
                          : launch_window_attn_fwd<48, 64>(a, qkv, bias, mask, out, total, C, nh, n, scale, groups, st);
    case 64: return small ? launch_window_attn_fwd<64, 16>(a, qkv, bias, mask, out, total, C, nh, n, scale, groups, st)
                          : launch_window_attn_fwd<64, 64>(a, qkv, bias, mask, out, total, C, nh, n, scale, groups, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The windowed attention forward over `total` windows of n tokens: the
// register body above at n <= 64 (`groups` groups of windows per head,
// the Python wrapper's fwd_groups), the strip body of window_attention.cuh
// above (one CTA per (head, window); `groups` is not read).
inline int launch_window_attention(const MapWindows& w, const void* qkv, const void* bias,
                                   const void* mask, void* out, int total, int C, int nh,
                                   int n, float scale, int groups, void* stream) {
  if (n > 64)
    return launch_window_attention_strips(w, qkv, bias, mask, out, total, C, nh, n, scale,
                                          stream);
  const int gx = w.W / w.ws, nw = (w.H / w.ws) * gx;
  const cudaStream_t st = (cudaStream_t)stream;
  if (w.shift == 0)
    return dispatch_window_attn_fwd(FwdMap{WrMap{w.H, w.W, w.ws, gx, nw}}, qkv, bias, mask,
                                    out, total, C, nh, n, scale, groups, st);
  return dispatch_window_attn_fwd(FwdShiftedMap{w.H, w.W, w.ws, gx, nw, w.shift}, qkv, bias,
                                  mask, out, total, C, nh, n, scale, groups, st);
}

inline int launch_window_attention(const TokenWindows& w, const void* qkv, const void* bias,
                                   const void* mask, void* out, int total, int C, int nh,
                                   int n, float scale, int groups, void* stream) {
  if (n > 64)
    return launch_window_attention_strips(w, qkv, bias, mask, out, total, C, nh, n, scale,
                                          stream);
  return dispatch_window_attn_fwd(FwdTokens{w.n, w.nw}, qkv, bias, mask, out, total, C, nh, n,
                                  scale, groups, (cudaStream_t)stream);
}

}  // namespace sodt
