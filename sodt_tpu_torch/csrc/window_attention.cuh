// The windowed attention core and its backward, shared by two layouts:
//
//   K1 / K5 / K9  windows cut out of an unpartitioned (B, H, W, .) map
//                 (MapWindows: a window is ws strided row pieces; K5 also
//                 reads at cyclically shifted positions)
//   K11           pre-partitioned windows (Wn, N, .) (TokenWindows: a window
//                 is N contiguous rows; the mask index is w mod nw)
//
// The kernels are templates on that addressing: `wins.window(w)` gives the
// rows of window w's tokens, `src(t)` where token t of qkv is read (and
// its dqkv written) and `dst(t)` where its out is written (and its dO
// read), both as row indices (the caller multiplies by the row width).
// Everything between the loads and the stores - scores, f32 softmax, the
// tensor-core products - is the same code for both layouts.
//
// Forward (the strip body: windows of more than 64 tokens; at N <= 64 the
// register body of window_attention_fwd.cuh runs), one CTA (4 warps) per
// (head, window), any window of up to 256 tokens (padded to a multiple of
// 16): q is scaled in bf16 as in JAX; each
// warp takes 16 query rows (common.cuh warp_attention_rows): scores +
// rel-pos bias (+ mask) and the softmax stay f32 in its shared scratch; P
// is rounded to bf16 for PV.
//
// Backward (the strip body: windows of more than 64 tokens; at N <= 64 the
// register body of window_attention_bwd.cuh runs, for K9 and K11 alike),
// per (window, head), in f32:
//   S = scale * Q K^T + bias (+ mask),  P = softmax(S)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(dP * P))
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dbias = sum over windows of dS
// (q is NOT pre-scaled in bf16 here: the Pallas backward kernels scale the
// f32 scores, unlike their forwards). dq/dk/dv are rounded to bf16 once, at
// the store.
//
// Bound by its shared-memory round trips like the forward (5 N x N x hd
// products per window and head, N <= 256). Design: one CTA (4 warps) per
// (head, group of windows); Q, K, V, dO of the window sit in shared memory
// as bf16 (exact: they are bf16 inputs). Phase A gives each warp 16 query
// rows: scores and the f32 softmax in the warp's strip, dP tile by tile
// (once for the row sums, once for dS, so the strip is the only N-wide f32
// buffer), dS into the dbias partial, then dS rounded to bf16 in place for
// dQ = dS K. The row max, 1/sum and rowsum(dP*P) stay in shared memory.
// Phase B gives each warp 16 KEY rows and recomputes the transposed strips
// S^T = K Q^T from those row statistics, so dV = P^T dO and dK = dS^T Q are
// warp-local products too: no reduction across warps, no atomics. The price
// is a second (and for dK a third) pass over the scores, which are cheap
// next to the memory they would otherwise need (two f32 N x N tiles are
// 512 KB at N = 256).
//
// dbias: a CTA walks its group's windows in order and accumulates dS into
// its own (N, N) f32 partial in device memory with plain read-modify-write
// (each address has one owner thread), and dbias_reduce_kernel sums the
// partials in group order: deterministic, no f32 atomics. Scratch is
// groups * nh * N * N floats (groups <= 128: 25 MB at nh 12, N 64).
// The group / strip / pack / chunk structure of the TPU kernels and their
// sequential-grid dbias accumulation are not carried over.
#pragma once

#include "common.cuh"

namespace sodt {

// Windows of ws x ws tokens of a (B, H, W, .) map, read at
// ((r + shift) mod H, (c + shift) mod W) and written at (r, c): the cyclic
// shift is index arithmetic, no roll is materialized.
struct MapWindows {
  int H, W, ws, shift;
  struct Window {
    int H, W, ws, shift, b, r0, c0;
    __device__ __forceinline__ size_t at(int t, int s) const {
      const int r = r0 + t / ws, c = c0 + t % ws;
      return (size_t)(b * H + (r + s) % H) * W + (c + s) % W;
    }
    __device__ __forceinline__ size_t src(int t) const { return at(t, shift); }
    __device__ __forceinline__ size_t dst(int t) const { return at(t, 0); }
  };
  __device__ __forceinline__ int per_image() const { return (H / ws) * (W / ws); }
  __device__ __forceinline__ Window window(int win) const {
    const int gx = W / ws, widx = win % per_image();
    return Window{H, W, ws, shift, win / per_image(), (widx / gx) * ws, (widx % gx) * ws};
  }
  __device__ __forceinline__ int mask_index(int win) const { return win % per_image(); }
};

// Pre-partitioned windows (Wn, n, .): token t of window w is row w * n + t;
// the mask of window w is mask[w mod nw] (nw windows per image).
struct TokenWindows {
  int n, nw;
  struct Window {
    size_t row0;
    __device__ __forceinline__ size_t src(int t) const { return row0 + t; }
    __device__ __forceinline__ size_t dst(int t) const { return row0 + t; }
  };
  __device__ __forceinline__ Window window(int win) const {
    return Window{(size_t)win * n};
  }
  __device__ __forceinline__ int mask_index(int win) const { return win % nw; }
};

// The register bodies (window_attention_fwd.cuh, window_attention_bwd.cuh):
// 4 warps, a stage of 64 token rows, the softmax in log2 units
constexpr int WR_WARPS = 4, WR_ROWS = 16 * WR_WARPS;  // token rows of a stage
constexpr float WR_LOG2E = 1.4426950408889634f;

// Windows of ws x ws tokens of a (B, H, W, .) map, read and written at
// shift 0 (K1 and K9 take the rolled map): window win = b * nw + wr * gx + wc
// starts at map row (b * H + wr * ws) * W + wc * ws, and its token t sits
// (t / ws) * W + t % ws further. The divisions by runtime values are taken
// once per window (base) and once per kernel for a thread's token offsets,
// not per 16-byte copy.
struct WrMap {
  int H, W, ws, gx, nw;
  __device__ __forceinline__ size_t base(int win, int& widx) const {
    const int b = win / nw;
    widx = win - b * nw;  // also the index of the window's mask
    const int wr = widx / gx, wc = widx - wr * gx;
    return ((size_t)b * H + wr * ws) * W + wc * ws;
  }
  __device__ __forceinline__ int offset(int t) const {
    const int tr = t / ws;
    return tr * W + t - tr * ws;
  }
};

// K11's pre-partitioned windows (Wn, n, .) for the register backward (the
// same interface as WrMap): window win starts at row win * n, its token t
// sits t rows further, its mask is mask[win mod nw]; one division per
// window.
struct WrTokens {
  int n, nw;
  __device__ __forceinline__ size_t base(int win, int& widx) const {
    widx = win % nw;
    return (size_t)win * n;
  }
  __device__ __forceinline__ int offset(int t) const { return t; }
};

// ------------------------------------------------------------------ forward

__host__ __device__ inline size_t window_attn_smem_bytes(int n, int hd) {
  const int np = (n + 15) & ~15;
  return (size_t)3 * np * (hd + 8) * 2 + (size_t)4 * warp_attn_scratch_floats(np) * 4 +
         (size_t)4 * 256 * 4;
}

// grid (nh, windows); qkv rows are 3C wide ([q | k | v]), out rows C wide;
// mask may be null
template <class Windows>
__global__ void __launch_bounds__(128)
window_attn_kernel(Windows wins, const bf16* __restrict__ qkv, const float* __restrict__ bias,
                   const float* __restrict__ mask, bf16* __restrict__ out, int C, int nh,
                   int n, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int np = (n + 15) & ~15, hd = C / nh, ld = hd + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + np * ld;
  bf16* Vs = Ks + np * ld;
  float* S = reinterpret_cast<float*>(Vs + np * ld);
  float* stage = S + 4 * warp_attn_scratch_floats(np);

  const int h = blockIdx.x, win = blockIdx.y;
  const auto w = wins.window(win);
  const int C3 = 3 * C;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  const int vpr = hd / 8;
  for (int v = threadIdx.x; v < np * vpr; v += blockDim.x) {
    const int t = v / vpr, cv = (v % vpr) * 8;
    uint4 q = make_uint4(0u, 0u, 0u, 0u), k = q, val = q;
    if (t < n) {
      const bf16* src = qkv + w.src(t) * C3 + h * hd + cv;
      q = *reinterpret_cast<const uint4*>(src);
      bf16* qe = reinterpret_cast<bf16*>(&q);
      for (int e = 0; e < 8; ++e) qe[e] = __float2bfloat16(__bfloat162float(qe[e]) * scale);
      k = *reinterpret_cast<const uint4*>(src + C);
      val = *reinterpret_cast<const uint4*>(src + 2 * C);
    }
    *reinterpret_cast<uint4*>(Qs + t * ld + cv) = q;
    *reinterpret_cast<uint4*>(Ks + t * ld + cv) = k;
    *reinterpret_cast<uint4*>(Vs + t * ld + cv) = val;
  }
  __syncthreads();

  const float* mk = mask ? mask + (size_t)wins.mask_index(win) * n * n : nullptr;
  for (int qb = warp; qb < np / 16; qb += nwarps)
    warp_attention_rows(Qs, Ks, Vs, ld, hd, n, np, qb * 16, bias + (size_t)h * n * n, mk,
                        S + warp * warp_attn_scratch_floats(np), stage + warp * 256,
                        [&](int t, int d, float v) {
                          if (t < n) out[w.dst(t) * C + h * hd + d] = __float2bfloat16(v);
                        });
}

// the strip body's launch; launch_window_attention (window_attention_fwd.cuh)
// takes it for windows of more than 64 tokens
template <class Windows>
inline int launch_window_attention_strips(Windows wins, const void* qkv, const void* bias,
                                          const void* mask, void* out, int total, int C,
                                          int nh, int n, float scale, void* stream) {
  static int smem_set = 0;
  const size_t smem = window_attn_smem_bytes(n, C / nh);
  if (smem > SMEM_MAX || total < 1 || total > 65535) return (int)cudaErrorInvalidValue;
  ensure_smem(window_attn_kernel<Windows>, smem, smem_set);
  dim3 grid(nh, total);
  window_attn_kernel<Windows><<<grid, 128, smem, (cudaStream_t)stream>>>(
      wins, (const bf16*)qkv, (const float*)bias, (const float*)mask, (bf16*)out, C, nh, n,
      scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- backward

constexpr int WB_WARPS = 4;

__host__ __device__ inline size_t window_attn_bwd_smem_bytes(int n, int hd) {
  const int np = (n + 15) & ~15;
  return (size_t)4 * np * (hd + 8) * 2 + (size_t)WB_WARPS * warp_attn_scratch_floats(np) * 4 +
         (size_t)WB_WARPS * 256 * 4 + (size_t)3 * np * 4;
}

// S (16 x np, f32, row stride lds) = A[16 rows] . B[all np rows]^T over hd
__device__ __forceinline__ void warp_strip_dot_t(const bf16* A, const bf16* B, int ld, int hd,
                                                 int np, float* S, int lds) {
  for (int tn = 0; tn < np / 16; ++tn) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < hd; k0 += 16) {
      FragA a;
      FragBT b;
      wmma::load_matrix_sync(a, A + k0, ld);
      wmma::load_matrix_sync(b, B + tn * 16 * ld + k0, ld);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(S + tn * 16, acc, lds, wmma::mem_row_major);
  }
  __syncwarp();
}

// st (16 x 16, f32, row stride 16) = A[16 rows] . B[16 rows]^T over hd
__device__ __forceinline__ void warp_tile_dot_t(const bf16* A, const bf16* B, int ld, int hd,
                                                float* st) {
  FragC acc;
  wmma::fill_fragment(acc, 0.0f);
  for (int k0 = 0; k0 < hd; k0 += 16) {
    FragA a;
    FragBT b;
    wmma::load_matrix_sync(a, A + k0, ld);
    wmma::load_matrix_sync(b, B + k0, ld);
    wmma::mma_sync(acc, a, b, acc);
  }
  wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
  __syncwarp();
}

// Round the warp's f32 strip to bf16 in place: bf16 row r (row stride
// 2 * lds) overlays the first half of f32 row r.
__device__ __forceinline__ void strip_to_bf16(float* S, int lds, int np) {
  const int lane = threadIdx.x & 31;
  bf16* P = reinterpret_cast<bf16*>(S);
  for (int r = 0; r < 16; ++r) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = lane + 32 * i;
      v[i] = j < np ? S[r * lds + j] : 0.0f;
    }
    __syncwarp();  // every lane has read row r before the overlay is written
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = lane + 32 * i;
      if (j < np) P[r * 2 * lds + j] = __float2bfloat16(v[i]);
    }
  }
  __syncwarp();
}

// out(r, d, value), r < 16, d < hd: the bf16 strip (16 x np) . M (np x hd)
template <class Out>
__device__ __forceinline__ void warp_strip_dot(const float* S, int lds, const bf16* M, int ld,
                                               int hd, int np, float* st, Out out) {
  const int lane = threadIdx.x & 31;
  const bf16* P = reinterpret_cast<const bf16*>(S);
  for (int tn = 0; tn < hd / 16; ++tn) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < np; k0 += 16) {
      FragA a;
      FragB b;
      wmma::load_matrix_sync(a, P + k0, 2 * lds);
      wmma::load_matrix_sync(b, M + k0 * ld + tn * 16, ld);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) out(e >> 4, tn * 16 + (e & 15), st[e]);
    __syncwarp();
  }
}

// grid (nh, groups); qkv / dqkv rows are 3C wide, gy rows C wide; the CTA of
// group g takes windows g, g + groups, ... < total; part is the
// (groups, nh, n, n) f32 dbias scratch; mask may be null
template <class Windows>
__global__ void __launch_bounds__(WB_WARPS * 32)
window_attn_bwd_kernel(Windows wins, const bf16* __restrict__ qkv,
                       const bf16* __restrict__ gy, const float* __restrict__ bias,
                       const float* __restrict__ mask, bf16* __restrict__ dqkv,
                       float* __restrict__ part, int C, int nh, int n, float scale, int total,
                       int groups) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int np = (n + 15) & ~15, hd = C / nh, ld = hd + 8, lds = np + 4;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + np * ld;
  bf16* Vs = Ks + np * ld;
  bf16* Gs = Vs + np * ld;
  float* strips = reinterpret_cast<float*>(Gs + np * ld);
  float* stage = strips + WB_WARPS * warp_attn_scratch_floats(np);
  float* rmax = stage + WB_WARPS * 256;
  float* rinv = rmax + np;
  float* rdel = rinv + np;

  const int h = blockIdx.x, grp = blockIdx.y;
  const int C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* S = strips + warp * warp_attn_scratch_floats(np);
  float* st = stage + warp * 256;
  const float* bias_h = bias + (size_t)h * n * n;
  float* mypart = part + ((size_t)grp * nh + h) * n * n;
  const int vpr = hd / 8;

  bool first = true;
  for (int win = grp; win < total; win += groups, first = false) {
    const auto w = wins.window(win);
    const float* mk = mask ? mask + (size_t)wins.mask_index(win) * n * n : nullptr;

    __syncthreads();  // the previous window's phase B is done with shared memory
    for (int v = threadIdx.x; v < np * vpr; v += blockDim.x) {
      const int t = v / vpr, cv = (v % vpr) * 8;
      uint4 q = make_uint4(0u, 0u, 0u, 0u), k = q, val = q, g = q;
      if (t < n) {
        const size_t p = w.src(t);
        const bf16* src = qkv + p * C3 + h * hd + cv;
        q = *reinterpret_cast<const uint4*>(src);
        k = *reinterpret_cast<const uint4*>(src + C);
        val = *reinterpret_cast<const uint4*>(src + 2 * C);
        g = *reinterpret_cast<const uint4*>(gy + w.dst(t) * C + h * hd + cv);
      }
      *reinterpret_cast<uint4*>(Qs + t * ld + cv) = q;
      *reinterpret_cast<uint4*>(Ks + t * ld + cv) = k;
      *reinterpret_cast<uint4*>(Vs + t * ld + cv) = val;
      *reinterpret_cast<uint4*>(Gs + t * ld + cv) = g;
    }
    __syncthreads();

    // ---- phase A: 16 query rows per warp -> row statistics, dbias, dQ
    for (int qb = warp; qb < np / 16; qb += WB_WARPS) {
      const int r0 = qb * 16;
      warp_strip_dot_t(Qs + r0 * ld, Ks, ld, hd, np, S, lds);
      for (int r = 0; r < 16; ++r) {
        const int row = r0 + r;
        float v[8];
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int j = lane + 32 * i;
          v[i] = -INFINITY;
          if (j < n) {
            float s = 0.0f;  // padding query rows: any finite row, dO is 0 there
            if (row < n) {
              s = S[r * lds + j] * scale + bias_h[row * n + j];
              if (mk) s += mk[row * n + j];
            }
            v[i] = s;
          }
          mx = fmaxf(mx, v[i]);
        }
        mx = warp_max(mx);
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          v[i] = (lane + 32 * i < n) ? expf(v[i] - mx) : 0.0f;
          sum += v[i];
        }
        const float inv = 1.0f / warp_sum(sum);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int j = lane + 32 * i;
          if (j < np) S[r * lds + j] = v[i] * inv;  // P, f32; 0 for keys j >= n
        }
        if (lane == 0) {
          rmax[row] = mx;
          rinv[row] = inv;
        }
      }
      __syncwarp();
      // lane owns column (lane & 15) of rows (lane >> 4) + 2k, k < 8, of a tile
      float d[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) d[k] = 0.0f;
      for (int tn = 0; tn < np / 16; ++tn) {
        warp_tile_dot_t(Gs + r0 * ld, Vs + tn * 16 * ld, ld, hd, st);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int e = lane + 32 * k;
          d[k] += st[e] * S[(e >> 4) * lds + tn * 16 + (e & 15)];
        }
        __syncwarp();
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        for (int o = 8; o > 0; o >>= 1) d[k] += __shfl_xor_sync(0xffffffffu, d[k], o);
      for (int tn = 0; tn < np / 16; ++tn) {
        warp_tile_dot_t(Gs + r0 * ld, Vs + tn * 16 * ld, ld, hd, st);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int e = lane + 32 * k;
          const int r = e >> 4, j = tn * 16 + (e & 15);
          const float ds = S[r * lds + j] * (st[e] - d[k]);
          S[r * lds + j] = ds;
          if (r0 + r < n && j < n) {
            float* dst = mypart + (size_t)(r0 + r) * n + j;
            *dst = first ? ds : *dst + ds;
          }
        }
        __syncwarp();
      }
      if ((lane & 15) == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) rdel[r0 + (lane >> 4) + 2 * k] = d[k];
      }
      strip_to_bf16(S, lds, np);
      warp_strip_dot(S, lds, Ks, ld, hd, np, st, [&](int r, int dcol, float v) {
        if (r0 + r < n)
          dqkv[w.src(r0 + r) * C3 + h * hd + dcol] = __float2bfloat16(scale * v);
      });
    }
    __syncthreads();  // the row statistics of every query are in shared memory

    // ---- phase B: 16 key rows per warp -> dV, dK from the transposed strips
    for (int kb = warp; kb < np / 16; kb += WB_WARPS) {
      const int j0 = kb * 16;
      for (int pass = 0; pass < 2; ++pass) {
        warp_strip_dot_t(Ks + j0 * ld, Qs, ld, hd, np, S, lds);
        for (int r = 0; r < 16; ++r) {
          const int j = j0 + r;
#pragma unroll
          for (int i8 = 0; i8 < 8; ++i8) {
            const int i = lane + 32 * i8;
            if (i < np) {
              float p = 0.0f;
              if (i < n && j < n) {
                float s = S[r * lds + i] * scale + bias_h[i * n + j];
                if (mk) s += mk[i * n + j];
                p = expf(s - rmax[i]) * rinv[i];
              }
              S[r * lds + i] = p;  // P^T, f32
            }
          }
        }
        __syncwarp();
        if (pass == 0) {
          strip_to_bf16(S, lds, np);
          warp_strip_dot(S, lds, Gs, ld, hd, np, st, [&](int r, int dcol, float v) {
            if (j0 + r < n)
              dqkv[w.src(j0 + r) * C3 + 2 * C + h * hd + dcol] = __float2bfloat16(v);
          });
        } else {
          for (int tn = 0; tn < np / 16; ++tn) {
            warp_tile_dot_t(Vs + j0 * ld, Gs + tn * 16 * ld, ld, hd, st);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int e = lane + 32 * k;
              const int r = e >> 4, i = tn * 16 + (e & 15);
              S[r * lds + i] *= st[e] - rdel[i];  // dS^T
            }
            __syncwarp();
          }
          strip_to_bf16(S, lds, np);
          warp_strip_dot(S, lds, Qs, ld, hd, np, st, [&](int r, int dcol, float v) {
            if (j0 + r < n)
              dqkv[w.src(j0 + r) * C3 + C + h * hd + dcol] = __float2bfloat16(scale * v);
          });
        }
      }
    }
  }
}

// static: every source that includes this header launches its own copy
static __global__ void dbias_reduce_kernel(const float* __restrict__ part,
                                           float* __restrict__ out, int groups, size_t per) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= per) return;
  float s = 0.0f;
  for (int g = 0; g < groups; ++g) s += part[(size_t)g * per + idx];
  out[idx] = s;
}

// part: (groups, nh, n, n) f32 scratch, groups <= total; dbias: (nh, n, n) f32.
template <class Windows>
inline int launch_window_attention_bwd(Windows wins, const void* qkv, const void* gy,
                                       const void* bias, const void* mask, void* dqkv,
                                       void* part, void* dbias, int total, int C, int nh,
                                       int n, float scale, int groups, void* stream) {
  static int smem_set = 0;
  const size_t smem = window_attn_bwd_smem_bytes(n, C / nh);
  if (smem > SMEM_MAX || groups < 1 || groups > total || groups > 65535)
    return (int)cudaErrorInvalidValue;
  ensure_smem(window_attn_bwd_kernel<Windows>, smem, smem_set);
  dim3 grid(nh, groups);
  window_attn_bwd_kernel<Windows><<<grid, WB_WARPS * 32, smem, (cudaStream_t)stream>>>(
      wins, (const bf16*)qkv, (const bf16*)gy, (const float*)bias, (const float*)mask,
      (bf16*)dqkv, (float*)part, C, nh, n, scale, total, groups);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t per = (size_t)nh * n * n;
  dbias_reduce_kernel<<<(unsigned)((per + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)part, (float*)dbias, groups, per);
  return (int)cudaGetLastError();
}

}  // namespace sodt
