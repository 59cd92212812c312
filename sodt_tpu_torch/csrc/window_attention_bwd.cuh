// The windowed attention backward for windows of up to 64 tokens, with the
// scores in registers: K9 (sodt_tpu/pallas/window_attention.py
// _bwd_strip_kernel, on the map) and K11's backward (_bwd_kernel, on
// pre-partitioned windows), the same function term for term. Per (window,
// head), in f32:
//   S = scale * Q K^T + bias (+ mask[window mod nW]),  P = softmax(S)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(dP * P))
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dbias = sum over windows of dS
// q is NOT pre-scaled in bf16 (the Pallas backward scales the f32 scores).
// P is rounded to bf16 before dV, dS before dQ and dK; dq, dk and dv are
// rounded once, at the store; dbias is summed in f32.
//
// What bounds it on the H100: the function moves 7 * C * 2 bytes per token
// (qkv and dO read, dqkv written) against 10 * N * C operations, so bytes,
// by ~2x at N = 64. The kernel runs at ~2.4x that bound: at 223 / 249
// registers a thread (head dims 16 / 32) two CTAs fit an SM, and each warp's
// chain of products, shuffles and stores is latency-bound; holding the bias
// or the dbias partial in shared memory to fit three CTAs cost more than it
// gained (PERF.md, PR 8).
//
// Design. One CTA of 4 warps per (head, group of windows), the head fastest
// in the raster, so the CTAs that read the same token rows run side by
// side. A stage holds 64 token rows of Q, K, V and dO of the head: one
// window at N <= 64 padded to 64, four at N <= 16 padded to 16 (warp w then
// takes window slot w). Stages come through a two-stage cp.async ring (with
// the 64 mask rows, when there is a mask), so the next windows load while
// these compute; the window addressing divides once per window, not per
// copy. Phase A, warp w: its 16 query rows against its window's keys, all
// in registers - S = Q K^T and dP = dO V^T (mma.sync m16n8k16 on ldmatrix
// operands), scale, bias and mask added in log2 units, the softmax with
// quad shuffles and ex2, delta, dS, dS added into a dbias accumulator that
// lives in registers across all of the CTA's windows, dQ = dS K with dS
// packed to bf16 A fragments straight from the accumulator; P and dS
// written once as bf16 into two shared tiles (stmatrix). Phase B, after one
// barrier, warp w: its 16 KEY rows, dV = P^T dO and dK = dS^T Q, with P^T
// and dS^T read from those tiles by ldmatrix.trans. No score is computed
// twice and no f32 score tile touches shared memory. dq, dk and dv are
// staged by stmatrix and stored 16 bytes a lane. The bias rows of a warp's
// queries sit in registers for the whole CTA (a CTA owns one head), keys
// >= n folded in as -inf. At the end the CTA writes its dbias partial to
// part[group, head] once (every address one owner: a warp's rows, or at
// N <= 16 the four slots summed in order), and dbias_reduce_kernel sums the
// partials in group order: deterministic, no f32 atomics.
//
// Two addressings (the template parameter Map, window_attention.cuh), each
// taking its runtime divisions once per window (`base`) and once per kernel
// for a thread's token offsets (`offset`), never per 16-byte copy: WrMap
// (the unpartitioned map at shift 0: K9) and WrTokens (pre-partitioned
// (Wn, N, 3C) windows, the mask of window w is mask[w mod nw]: K11).
#pragma once

#include "mma_sync.cuh"
#include "window_attention.cuh"

namespace sodt {

// NP: the window padded to 16 or 64 tokens
template <int HD, int NP>
struct WrLayout {
  static constexpr int LDH = HD + 8;          // bf16 rows: conflict-free ldmatrix
  static constexpr int LDP = NP + 8;          // bf16 P / dS rows
  static constexpr int LDM = NP + 8;          // f32 mask rows: conflict-free float2
  static constexpr int TILE = WR_ROWS * LDH;  // bf16 elements of Q (K, V, dO)
  __host__ __device__ static size_t stage_bytes(bool mask) {
    return (size_t)4 * TILE * 2 + (mask ? (size_t)WR_ROWS * LDM * 4 : 0);
  }
  // the ring, the P and dS tiles, the output staging rows
  __host__ __device__ static size_t smem_bytes(bool mask) {
    return 2 * stage_bytes(mask) + (size_t)2 * WR_ROWS * LDP * 2 + (size_t)TILE * 2;
  }
};

// grid (nh * groups): CTA b takes head b % nh and group b / nh, which walks
// the stages (chunks of 64 / NP windows) group, group + groups, ...;
// part is the (groups, nh, n, n) f32 dbias scratch; mask may be null
template <int HD, int NP, class Map>
__global__ void __launch_bounds__(WR_WARPS * 32)
window_attn_bwd_regs_kernel(Map m, const bf16* __restrict__ qkv,
                            const bf16* __restrict__ gy, const float* __restrict__ bias,
                            const float* __restrict__ mask, bf16* __restrict__ dqkv,
                            float* __restrict__ part, int C, int nh, int n, float scale,
                            int total, int groups) {
  using L = WrLayout<HD, NP>;
  constexpr int WPI = WR_ROWS / NP;  // windows of a stage
  constexpr int NT = NP / 8;         // n8 key tiles of a score row
  constexpr int DT = HD / 8;         // n8 tiles of a head row
  extern __shared__ __align__(128) unsigned char smem[];
  const bool has_mask = mask != nullptr;
  const size_t stage = L::stage_bytes(has_mask);
  auto Qs = [&](int s) { return reinterpret_cast<bf16*>(smem + s * stage); };
  auto Ks = [&](int s) { return Qs(s) + L::TILE; };
  auto Vs = [&](int s) { return Qs(s) + 2 * L::TILE; };
  auto Gs = [&](int s) { return Qs(s) + 3 * L::TILE; };
  auto Ms = [&](int s) { return reinterpret_cast<float*>(Qs(s) + 4 * L::TILE); };
  bf16* Ps = reinterpret_cast<bf16*>(smem + 2 * stage);
  bf16* Ds = Ps + WR_ROWS * L::LDP;
  bf16* Os = Ds + WR_ROWS * L::LDP;  // each warp's 16 output rows, staged

  const int h = blockIdx.x % nh, grp = blockIdx.x / nh;
  const int chunks = (total + WPI - 1) / WPI;
  const int C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;         // the warp's 16 rows of the stage
  const int wb = (r0 / NP) * NP;    // the first row of its window in the stage
  const int rw = r0 - wb;           // its first row within the window
  const int slot = r0 / NP;

  // the bias rows of this warp's queries in log2 units (the softmax takes
  // 2^x), in the accumulator layout; keys >= n get -inf, padding query rows
  // any finite row (their dO is 0)
  float bs[NT][4], db[NT][4];
  const float* bias_h = bias + (size_t)h * n * n;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rw + g + 8 * (e >> 1), col = nt * 8 + 2 * t4 + (e & 1);
      bs[nt][e] = col >= n ? -INFINITY : row < n ? bias_h[row * n + col] * WR_LOG2E : 0.0f;
      db[nt][e] = 0.0f;
    }
  const float scale2 = scale * WR_LOG2E;

  // this thread's copies: token offsets (-1: padding token), fixed per kernel
  constexpr int VPR = HD / 8, ITEMS = WR_ROWS * VPR / (WR_WARPS * 32);
  int loff[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int t = ((threadIdx.x + k * WR_WARPS * 32) / VPR) % NP;
    loff[k] = t < n ? m.offset(t) : -1;
  }
  // window slot sl of stage `chunk`: its first map row (0 past the last
  // window), mask index and whether it exists
  auto window_at = [&](int chunk, int sl, int& widx, bool& ok) -> size_t {
    const int win = chunk * WPI + sl;
    ok = win < total;
    widx = 0;
    return ok ? m.base(win, widx) : 0;
  };

  auto issue = [&](int chunk, int s) {
    int widx0;
    bool ok0;
    const size_t base0 = window_at(chunk, 0, widx0, ok0);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int v = threadIdx.x + k * WR_WARPS * 32;
      const int r = v / VPR, cv = (v % VPR) * 8;
      int widx;
      bool ok = ok0;
      size_t base = base0;
      if (WPI > 1) base = window_at(chunk, r / NP, widx, ok);
      ok = ok && loff[k] >= 0;
      const size_t p = ok ? base + loff[k] : 0;
      const bf16* src = qkv + p * C3 + h * HD + cv;
      bf16* dst = Qs(s) + r * L::LDH + cv;
      cp_async16(dst, src, ok);
      cp_async16(dst + L::TILE, src + C, ok);
      cp_async16(dst + 2 * L::TILE, src + 2 * C, ok);
      cp_async16(dst + 3 * L::TILE, gy + p * C + h * HD + cv, ok);
    }
    if (has_mask) {
      float* mdst = Ms(s);
      // (r, c): row r of the stage, key c; r / NP the window slot
      auto copy = [&](int r, int c, bool wide) {
        int widx = widx0;
        bool ok = ok0;
        if (WPI > 1) window_at(chunk, r / NP, widx, ok);
        const int t = r % NP;
        ok = ok && t < n && c < n;
        const float* src = ok ? mask + ((size_t)widx * n + t) * n + c : mask;
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

  // this lane's 16-byte pieces of the warp's 16 output rows: token offsets
  // (-1: padding token)
  int ooff[HD / 16];
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) {
    const int t = rw + (lane + 32 * k) / VPR;
    ooff[k] = t < n ? m.offset(t) : -1;
  }
  // mul * a (the warp's 16 x HD f32 accumulator) as bf16 into columns col of
  // its tokens' dqkv rows: staged by stmatrix, stored 16 bytes a lane
  auto store_rows = [&](const float (&a)[DT][4], float mul, int col, size_t wbase,
                        bool wok) {
    bf16* st = Os + r0 * L::LDH;
#pragma unroll
    for (int dt = 0; dt < HD / 16; ++dt)
      stsm_x4(a_tile_addr(st, L::LDH, 0, dt * 16, lane),
              pack_bf16(mul * a[2 * dt][0], mul * a[2 * dt][1]),
              pack_bf16(mul * a[2 * dt][2], mul * a[2 * dt][3]),
              pack_bf16(mul * a[2 * dt + 1][0], mul * a[2 * dt + 1][1]),
              pack_bf16(mul * a[2 * dt + 1][2], mul * a[2 * dt + 1][3]));
    __syncwarp();
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) {
      const int e = lane + 32 * k, cv = (e % VPR) * 8;
      if (wok && ooff[k] >= 0)
        *reinterpret_cast<uint4*>(dqkv + (wbase + ooff[k]) * C3 + col + h * HD + cv) =
            *reinterpret_cast<const uint4*>(st + (e / VPR) * L::LDH + cv);
    }
    __syncwarp();  // every lane has read the staged rows
  };

  issue(grp, 0);
  int s = 0;
  for (int chunk = grp; chunk < chunks; chunk += groups, s ^= 1) {
    cp_async_wait<0>();  // this stage has landed,
    __syncthreads();     // and every warp is done with the previous one, P and dS
    if (chunk + groups < chunks) issue(chunk + groups, s ^ 1);
    const bf16* Q = Qs(s);
    const bf16* K = Ks(s);
    const bf16* V = Vs(s);
    const bf16* G = Gs(s);

    // ---- phase A: this warp's 16 query rows
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      unsigned qa[4], ga[4];
      ldsm_x4(qa, a_tile_addr(Q, L::LDH, r0, ks * 16, lane));
      ldsm_x4(ga, a_tile_addr(G, L::LDH, r0, ks * 16, lane));
#pragma unroll
      for (int kt = 0; kt < NP / 16; ++kt) {
        unsigned b[4];
        ldsm_x4(b, b_tile_addr(K, L::LDH, wb + kt * 16, ks * 16, lane));
        mma_bf16(sc[2 * kt], qa, b[0], b[1]);
        mma_bf16(sc[2 * kt + 1], qa, b[2], b[3]);
        ldsm_x4(b, b_tile_addr(V, L::LDH, wb + kt * 16, ks * 16, lane));
        mma_bf16(dp[2 * kt], ga, b[0], b[1]);
        mma_bf16(dp[2 * kt + 1], ga, b[2], b[3]);
      }
    }
    // S = scale * QK^T + bias (+ mask) in log2 units; rows g (hr 0) and
    // g + 8 (hr 1) of the tile
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float x0 = fmaf(sc[nt][2 * hr], scale2, bs[nt][2 * hr]);
        float x1 = fmaf(sc[nt][2 * hr + 1], scale2, bs[nt][2 * hr + 1]);
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
    float dl[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) sm[hr] = 1.0f / quad_sum(sm[hr]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] *= sm[e >> 1];  // P, f32
        dl[e >> 1] += dp[nt][e] * sc[nt][e];
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) dl[hr] = quad_sum(dl[hr]);
    // dS into the dbias accumulator; P and dS as bf16 into their tiles, dS
    // kept packed: (rows g | g + 8, key tile nt) is the A operand of dQ
    unsigned dsp[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float d0 = sc[nt][2 * hr] * (dp[nt][2 * hr] - dl[hr]);
        const float d1 = sc[nt][2 * hr + 1] * (dp[nt][2 * hr + 1] - dl[hr]);
        db[nt][2 * hr] += d0;
        db[nt][2 * hr + 1] += d1;
        dsp[nt][hr] = pack_bf16(d0, d1);
      }
#pragma unroll
    for (int kt = 0; kt < NP / 16; ++kt) {  // the 16 x 16 tiles (rows r0, keys 16 kt)
      stsm_x4(a_tile_addr(Ps, L::LDP, r0, kt * 16, lane),
              pack_bf16(sc[2 * kt][0], sc[2 * kt][1]), pack_bf16(sc[2 * kt][2], sc[2 * kt][3]),
              pack_bf16(sc[2 * kt + 1][0], sc[2 * kt + 1][1]),
              pack_bf16(sc[2 * kt + 1][2], sc[2 * kt + 1][3]));
      stsm_x4(a_tile_addr(Ds, L::LDP, r0, kt * 16, lane), dsp[2 * kt][0], dsp[2 * kt][1],
              dsp[2 * kt + 1][0], dsp[2 * kt + 1][1]);
    }
    // dQ = dS K: dS as A operands, K as a k-major B operand
    float acc[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < NP / 16; ++kt) {
      const unsigned a[4] = {dsp[2 * kt][0], dsp[2 * kt][1], dsp[2 * kt + 1][0],
                             dsp[2 * kt + 1][1]};
#pragma unroll
      for (int dt = 0; dt < HD / 16; ++dt) {
        unsigned b[4];
        ldsm_x4_t(b, b_tile_addr_t(K, L::LDH, wb + kt * 16, dt * 16, lane));
        mma_bf16(acc[2 * dt], a, b[0], b[1]);
        mma_bf16(acc[2 * dt + 1], a, b[2], b[3]);
      }
    }
    // the warp's window: dq now, dk and dv after phase B
    int widx;
    bool wok;
    const size_t wbase = window_at(chunk, slot, widx, wok);
    store_rows(acc, scale, 0, wbase, wok);
    __syncthreads();  // every warp's P and dS rows are in their tiles

    // ---- phase B: this warp's 16 key rows; dV = P^T dO, dK = dS^T Q
    float dk[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = dk[i][e] = 0.0f;
#pragma unroll
    for (int qt = 0; qt < NP / 16; ++qt) {
      unsigned pa[4], da[4];
      ldsm_x4_t(pa, b_tile_addr(Ps, L::LDP, wb + qt * 16, rw, lane));
      ldsm_x4_t(da, b_tile_addr(Ds, L::LDP, wb + qt * 16, rw, lane));
#pragma unroll
      for (int dt = 0; dt < HD / 16; ++dt) {
        unsigned b[4];
        ldsm_x4_t(b, b_tile_addr_t(G, L::LDH, wb + qt * 16, dt * 16, lane));
        mma_bf16(acc[2 * dt], pa, b[0], b[1]);
        mma_bf16(acc[2 * dt + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, b_tile_addr_t(Q, L::LDH, wb + qt * 16, dt * 16, lane));
        mma_bf16(dk[2 * dt], da, b[0], b[1]);
        mma_bf16(dk[2 * dt + 1], da, b[2], b[3]);
      }
    }
    store_rows(dk, scale, C, wbase, wok);
    store_rows(acc, 1.0f, 2 * C, wbase, wok);
  }

  // the CTA's dbias partial, written once
  float* mypart = part + ((size_t)grp * nh + h) * n * n;
  if (WPI == 1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rw + g + 8 * (e >> 1), col = nt * 8 + 2 * t4 + (e & 1);
        if (row < n && col < n) mypart[row * n + col] = db[nt][e];
      }
  } else {
    // four window slots hold the same rows: summed in slot order
    cp_async_wait<0>();
    __syncthreads();  // the ring is free
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(slot * NP + rw + g + 8 * (e >> 1)) * NP + nt * 8 + 2 * t4 + (e & 1)] = db[nt][e];
    __syncthreads();
    for (int v = threadIdx.x; v < NP * NP; v += blockDim.x) {
      const int row = v / NP, col = v % NP;
      if (row < n && col < n) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < WPI; ++w) sum += red[w * NP * NP + v];
        mypart[row * n + col] = sum;
      }
    }
  }
}

// part: (groups, nh, n, n) f32 scratch with groups <= ceil(total / (64 /
// NP)); dbias: (nh, n, n) f32
template <int HD, int NP, class Map>
inline int launch_window_attention_bwd_regs(const Map& m, const void* qkv,
                                            const void* gy, const void* bias,
                                            const void* mask, void* dqkv, void* part,
                                            void* dbias, int total, int C, int nh, int n,
                                            float scale, int groups, cudaStream_t stream) {
  static int smem_set = 0;
  const size_t smem = WrLayout<HD, NP>::smem_bytes(mask != nullptr);
  const int chunks = (total + WR_ROWS / NP - 1) / (WR_ROWS / NP);
  if (smem > SMEM_MAX || groups < 1 || groups > chunks) return (int)cudaErrorInvalidValue;
  ensure_smem(window_attn_bwd_regs_kernel<HD, NP, Map>, smem, smem_set);
  window_attn_bwd_regs_kernel<HD, NP, Map><<<nh * groups, WR_WARPS * 32, smem, stream>>>(
      m, (const bf16*)qkv, (const bf16*)gy, (const float*)bias, (const float*)mask,
      (bf16*)dqkv, (float*)part, C, nh, n, scale, total, groups);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t per = (size_t)nh * n * n;
  dbias_reduce_kernel<<<(unsigned)((per + 255) / 256), 256, 0, stream>>>(
      (const float*)part, (float*)dbias, groups, per);
  return (int)cudaGetLastError();
}

// the instantiation for head dim hd (16, 32, 48 or 64)
template <int NP, class Map>
inline int dispatch_window_attention_bwd_regs(int hd, const Map& m, const void* qkv,
                                              const void* gy, const void* bias,
                                              const void* mask, void* dqkv, void* part,
                                              void* dbias, int total, int C, int nh, int n,
                                              float scale, int groups, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_window_attention_bwd_regs<16, NP, Map>(m, qkv, gy, bias, mask, dqkv, part, dbias, total, C, nh, n, scale, groups, stream);
    case 32: return launch_window_attention_bwd_regs<32, NP, Map>(m, qkv, gy, bias, mask, dqkv, part, dbias, total, C, nh, n, scale, groups, stream);
    case 48: return launch_window_attention_bwd_regs<48, NP, Map>(m, qkv, gy, bias, mask, dqkv, part, dbias, total, C, nh, n, scale, groups, stream);
    case 64: return launch_window_attention_bwd_regs<64, NP, Map>(m, qkv, gy, bias, mask, dqkv, part, dbias, total, C, nh, n, scale, groups, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The register body over `total` windows of n <= 64 tokens: the
// instantiation for the window's padding (16 or 64 tokens) and the head
// dim; mask may be null
template <class Map>
inline int window_attention_bwd_regs(const Map& m, const void* qkv, const void* gy,
                                     const void* bias, const void* mask, void* dqkv, void* part,
                                     void* dbias, int total, int C, int nh, int n, float scale,
                                     int groups, void* stream) {
  if (n > 64 || C % nh != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n <= 16)
    return dispatch_window_attention_bwd_regs<16>(C / nh, m, qkv, gy, bias, mask, dqkv, part,
                                                  dbias, total, C, nh, n, scale, groups, st);
  return dispatch_window_attention_bwd_regs<64>(C / nh, m, qkv, gy, bias, mask, dqkv, part,
                                                dbias, total, C, nh, n, scale, groups, st);
}

}  // namespace sodt
