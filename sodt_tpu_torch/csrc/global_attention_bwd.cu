// K10: backward of the single-window ("global") attention K8.
// Replaces sodt_tpu/pallas/window_attention.py _global_bwd_dqkv_kernel +
// _global_bwd_dbias_kernel (_pallas_global_attention_bwd, _global_chunk_grads).
// Per (window, head), in f32, with S = scale * Q K^T + bias (+ mask),
// P = softmax(S) = exp(S - lse):
//   dP = dO V^T,  delta = rowsum(dP * P) = rowsum(dO * O),
//   dS = P * (dP - delta),
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO,
//   dbias = sum over batch (and windows) of dS.
// P and dS are rounded to bf16 before their tensor-core products; dbias is
// summed in f32.
//
// What bounds it on the H100: bytes. At N = 1024, 12 heads, batch 4 the f32
// bias read and the f32 dbias written are 50 MB each (30 us at 3.35 TB/s);
// its five N x N x 64 products per (window, head) are 32 GFLOP (33 us at
// the bf16 peak, about twice that for mma.sync from registers).
//
// Design. Three properties: dbias deterministic (no float atomics: every
// dbias address has one owner thread, which adds the windows in order),
// dbias written once, and each score tile computed at most twice in the
// backward on the training path (K8's statistics). Steps, one launch each, on the caller's stream:
//  1. Row statistics (lse, delta), (B * nW, nh, N) f32 each:
//     * taken from K8 when the caller hands K8's log-sum-exp and f32
//       output. The wrapper does so under autograd only where K8's S
//       equals this one: K8 scales q in bf16 before QK^T, which is exact
//       only when the scale is a power of two (head dim 16 or 64; the
//       flagship's 64). delta = rowsum(dO * O) then comes from that f32 O
//       (global_attn_delta_kernel, 12.6 + 6.3 MB read at batch 4). Not
//       from K8's bf16 output: O's and P's bf16 roundings move delta by
//       ~1e-3 of dP, and dbias then misses DBIAS_TOL (global_attention.cuh
//       keeps P's rounding residue for that reason);
//     * else computed by K8's body in its statistics mode (q unscaled,
//       S * scale in f32, O in f32 for delta): one more pass over the
//       score tiles, so three score computations per tile on this path
//       (K8 has computed them once more in the forward). Holding a
//       window's 32 x N score rows in shared memory to take the statistics
//       inside step 2 would not fit beside the dbias slab (2 x 128 KB at
//       N = 1024).
//  2. global_attn_bwd_dq_kernel: one CTA of 8 warps per (32 query rows,
//     head), 384 CTAs at N = 1024 with 12 heads. It holds its 32 x N f32
//     dbias slab in shared memory (132 KB at N = 1024) across all B * nW
//     windows, which it walks in order; per window, 64-key blocks of K, V
//     and the bias (+ mask) tile come through a two-stage cp.async ring
//     (one barrier per block),
//     warp (r, k) computes S and dP of its 16 rows x 16 keys in registers
//     (mma.sync, ldmatrix), forms dS there, adds it into the slab and
//     accumulates dQ += dS K in registers; the four key-quarter warps' dQ
//     are summed in a fixed order at the end of the window. The slab is
//     written to dbias once, at the end. (Where the slab does not fit,
//     N > ~1400 or head dim 128 at N = 1024, the same owner threads add
//     into dbias in device memory instead: still deterministic.)
//  3. global_attn_bwd_dkv_kernel: one CTA of 4 warps per (64 key rows,
//     window, head), rastered like K8 with the window fastest so the bias
//     tiles of one (head, key block) are read side by side. It loops over
//     the query blocks through the same kind of ring, computes S^T and
//     dP^T of its keys in registers, and accumulates dV += P^T dO and
//     dK += dS^T Q in registers for the whole loop, rounded to bf16 once.
// The row-chunk structure of the TPU kernel (_bwd_row_chunk) is a VMEM
// device and is not carried over.
#include "global_attention.cuh"

namespace sodt {

constexpr int GQ_R = 32, GQ_WARPS = 8, GQ_KB = 64;  // dQ kernel: query rows, warps, key block

template <int HD>
struct GqLayout {
  static constexpr int LDH = HD + 8;
  static constexpr int LDB = GQ_KB + 8;
  static constexpr int KV = GQ_KB * LDH;
  static constexpr int BT = GQ_R * LDB;
  static constexpr int LDR = HD + 4;  // f32 row stride of the dQ partials
  __host__ __device__ static size_t stage_bytes(bool mask) {
    return (size_t)2 * KV * 2 + (size_t)(mask ? 2 : 1) * BT * 4;
  }
  __host__ __device__ static size_t slab_bytes(int N) { return (size_t)GQ_R * (N + 8) * 4; }
  // ring + Q / dO tiles (+ slab); the dQ partials reuse the ring
  __host__ __device__ static size_t smem_bytes(bool mask, int N, bool slab) {
    return GA_STAGES * stage_bytes(mask) + (size_t)2 * GQ_R * LDH * 2 +
           (slab ? slab_bytes(N) : 0);
  }
};

template <int HD>
__global__ void __launch_bounds__(GQ_WARPS * 32)
global_attn_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gy,
                          const float* __restrict__ bias, const float* __restrict__ mask,
                          const float* __restrict__ lse_g, const float* __restrict__ del_g,
                          bf16* __restrict__ dqkv, float* __restrict__ dbias, GaWindows m,
                          int C, int nh, int total, int slab_in_smem, float scale) {
  using L = GqLayout<HD>;
  constexpr int NS = GA_STAGES;
  static_assert(4 * GQ_R * (HD + 4) * 4 <= 2 * 2 * GQ_KB * (HD + 8) * 2,
                "the dQ partials fit in the ring");
  extern __shared__ __align__(128) unsigned char smem[];
  const bool has_mask = mask != nullptr;
  const int N = m.ws * m.ws;
  const size_t stage = L::stage_bytes(has_mask);
  auto Ks = [&](int s) { return reinterpret_cast<bf16*>(smem + s * stage); };
  auto Vs = [&](int s) { return Ks(s) + L::KV; };
  auto Bs = [&](int s) { return reinterpret_cast<float*>(Vs(s) + L::KV); };
  auto Ms = [&](int s) { return Bs(s) + L::BT; };
  bf16* Qs = reinterpret_cast<bf16*>(smem + NS * stage);
  bf16* Gs = Qs + GQ_R * L::LDH;
  float* red = reinterpret_cast<float*>(smem);  // dQ partials, after a window's loop
  const int nqb = N / GQ_R;
  const int h = blockIdx.x / nqb, q0 = (blockIdx.x % nqb) * GQ_R;
  const int C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rt = warp & 1, kq = warp >> 1;  // 16-row tile, 16-key quarter of a block
  const int row0 = rt * 16 + g;             // this lane's first row in the CTA tile
  float* slab;
  int lds;
  if (slab_in_smem) {
    slab = reinterpret_cast<float*>(Gs + GQ_R * L::LDH);
    lds = N + 8;
  } else {
    slab = dbias + ((size_t)h * N + q0) * N;
    lds = N;
  }
  const bf16* base = qkv + h * HD;
  const float* bias_q = bias + ((size_t)h * N + q0) * N;
  const int nkb = N / GQ_KB;

  for (int win = 0; win < total; ++win) {
    const float* mask_q = has_mask ? mask + ((size_t)(win % m.nw) * N + q0) * N : nullptr;
    auto issue = [&](int kb, int s) {
      const int k0 = kb * GQ_KB;
      cp_rows<HD>(Ks(s), L::LDH, base, C3, C, m, win, k0, GQ_KB);
      cp_rows<HD>(Vs(s), L::LDH, base, C3, 2 * C, m, win, k0, GQ_KB);
      cp_f32_tile(Bs(s), L::LDB, bias_q + k0, N, GQ_R, GQ_KB / 4);
      if (has_mask) cp_f32_tile(Ms(s), L::LDB, mask_q + k0, N, GQ_R, GQ_KB / 4);
    };
    cp_rows<HD>(Qs, L::LDH, base, C3, 0, m, win, q0, GQ_R);
    cp_rows<HD>(Gs, L::LDH, gy + h * HD, C, 0, m, win, q0, GQ_R);
    issue(0, 0);
    cp_async_commit();
#pragma unroll
    for (int i = 1; i < NS - 1; ++i) {
      if (i < nkb) issue(i, i);
      cp_async_commit();
    }
    cp_async_wait<NS - 2>();
    __syncthreads();
    unsigned qa[HD / 16][4], ga[HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      ldsm_x4(qa[ks], a_tile_addr(Qs, L::LDH, rt * 16, ks * 16, lane));
      ldsm_x4(ga[ks], a_tile_addr(Gs, L::LDH, rt * 16, ks * 16, lane));
    }
    const size_t srow = ((size_t)win * nh + h) * N + q0 + row0;
    const float l2[2] = {lse_g[srow] * GA_LOG2E, lse_g[srow + 8] * GA_LOG2E};
    const float dl[2] = {del_g[srow], del_g[srow + 8]};
    float dq[HD / 8][4];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.0f;

    for (int kb = 0; kb < nkb; ++kb) {
      cp_async_wait<NS - 2>();  // block kb has landed,
      __syncthreads();          // and every warp is done with block kb - 1
      if (kb + NS - 1 < nkb) issue(kb + NS - 1, (kb + NS - 1) % NS);
      cp_async_commit();
      const int s = kb % NS;

      float sc[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        unsigned b[4];
        ldsm_x4(b, b_tile_addr(Ks(s), L::LDH, kq * 16, ks * 16, lane));
        mma_bf16(sc[0], qa[ks], b[0], b[1]);
        mma_bf16(sc[1], qa[ks], b[2], b[3]);
        ldsm_x4(b, b_tile_addr(Vs(s), L::LDH, kq * 16, ks * 16, lane));
        mma_bf16(dp[0], ga[ks], b[0], b[1]);
        mma_bf16(dp[1], ga[ks], b[2], b[3]);
      }
      unsigned dsa[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = row0 + 8 * hr, c = kq * 16 + nt * 8 + 2 * t4;
          float2 bv = *reinterpret_cast<const float2*>(Bs(s) + r * L::LDB + c);
          if (has_mask) {
            const float2 mv = *reinterpret_cast<const float2*>(Ms(s) + r * L::LDB + c);
            bv.x += mv.x;
            bv.y += mv.y;
          }
          const float x0 = sc[nt][2 * hr] * scale + bv.x;
          const float x1 = sc[nt][2 * hr + 1] * scale + bv.y;
          const float p0 = exp2f(x0 * GA_LOG2E - l2[hr]);
          const float p1 = exp2f(x1 * GA_LOG2E - l2[hr]);
          const float d0 = p0 * (dp[nt][2 * hr] - dl[hr]);
          const float d1 = p1 * (dp[nt][2 * hr + 1] - dl[hr]);
          // this thread is the one owner of these two slab entries
          float2* dst = reinterpret_cast<float2*>(slab + (size_t)r * lds + kb * GQ_KB + c);
          if (win > 0) {
            const float2 prev = *dst;
            *dst = make_float2(prev.x + d0, prev.y + d1);
          } else {
            *dst = make_float2(d0, d1);
          }
          dsa[nt * 2 + hr] = pack_bf16(d0, d1);  // A operand: (row g | g+8, key tile nt)
        }
      }
      // dQ += dS K over this warp's 16 keys: K as a k-major B operand
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        unsigned b[4];
        ldsm_x4_t(b, b_tile_addr_t(Ks(s), L::LDH, kq * 16, np * 16, lane));
        mma_bf16(dq[2 * np], dsa, b[0], b[1]);
        mma_bf16(dq[2 * np + 1], dsa, b[2], b[3]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the dQ partials
    // the four key-quarter warps' dQ, summed in a fixed order
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(red + (kq * GQ_R + row0 + 8 * hr) * L::LDR + nt * 8 +
                                   2 * t4) = make_float2(dq[nt][2 * hr], dq[nt][2 * hr + 1]);
    __syncthreads();
    bf16* dqb = dqkv + h * HD;
    for (int e = threadIdx.x; e < GQ_R * HD / 2; e += blockDim.x) {
      const int r = e / (HD / 2), c = (e % (HD / 2)) * 2;
      float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 v = *reinterpret_cast<const float2*>(red + (k * GQ_R + r) * L::LDR + c);
        acc.x += v.x;
        acc.y += v.y;
      }
      *reinterpret_cast<unsigned*>(dqb + m.tok(win, q0 + r) * C3 + c) =
          pack_bf16(scale * acc.x, scale * acc.y);
    }
    __syncthreads();  // the ring and the Q / dO tiles are refilled next window
  }
  if (slab_in_smem) {
    float* dst = dbias + ((size_t)h * N + q0) * N;
    const int n4 = N / 4;
    for (int v = threadIdx.x; v < GQ_R * n4; v += blockDim.x) {
      const int r = v / n4, c = (v % n4) * 4;
      *reinterpret_cast<float4*>(dst + (size_t)r * N + c) =
          *reinterpret_cast<const float4*>(slab + r * lds + c);
    }
  }
}

// dK / dV: one CTA of GK_WARPS warps per (16 * GK_WARPS key rows, window, head)
constexpr int GK_WARPS = 4, GK_KEYS = 16 * GK_WARPS, GK_Q = 64;
template <int HD>
struct GkLayout {
  static constexpr int LDH = HD + 8;
  static constexpr int LDT = GK_KEYS + 4;  // f32 bias rows, read transposed without conflicts
  static constexpr int OWN = GK_KEYS * LDH;  // this CTA's K (or V) rows
  static constexpr int TILE = GK_Q * LDH;    // a block of Q (or dO) rows
  static constexpr int BT = GK_Q * LDT;
  __host__ __device__ static size_t stage_bytes(bool mask) {
    return (size_t)2 * TILE * 2 + (size_t)(mask ? 2 : 1) * BT * 4 + 2 * GK_Q * 4;
  }
  __host__ __device__ static size_t smem_bytes(bool mask) {
    return (size_t)2 * OWN * 2 + 2 * stage_bytes(mask);
  }
};

template <int HD>
__global__ void __launch_bounds__(GK_WARPS * 32)
global_attn_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gy,
                           const float* __restrict__ bias, const float* __restrict__ mask,
                           const float* __restrict__ lse_g, const float* __restrict__ del_g,
                           bf16* __restrict__ dqkv, GaWindows m, int C, int nh, int total,
                           float scale) {
  using L = GkLayout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  const bool has_mask = mask != nullptr;
  const int N = m.ws * m.ws;
  bf16* Kown = reinterpret_cast<bf16*>(smem);
  bf16* Vown = Kown + L::OWN;
  unsigned char* ring = smem + (size_t)2 * L::OWN * 2;
  const size_t stage = L::stage_bytes(has_mask);
  auto Qs = [&](int s) { return reinterpret_cast<bf16*>(ring + s * stage); };
  auto Gs = [&](int s) { return Qs(s) + L::TILE; };
  auto Bs = [&](int s) { return reinterpret_cast<float*>(Gs(s) + L::TILE); };
  auto Ms = [&](int s) { return Bs(s) + L::BT; };
  auto Ls = [&](int s) { return Bs(s) + (has_mask ? 2 : 1) * L::BT; };  // lse, then delta

  const int nkb = N / GK_KEYS;
  const int win = blockIdx.x % total;
  const int kb = (blockIdx.x / total) % nkb;
  const int h = blockIdx.x / (total * nkb);
  const int k0 = kb * GK_KEYS;
  const int C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* base = qkv + h * HD;
  const float* bias_k = bias + (size_t)h * N * N + k0;
  const float* mask_k = has_mask ? mask + (size_t)(win % m.nw) * N * N + k0 : nullptr;
  const size_t sbase = ((size_t)win * nh + h) * N;

  auto issue = [&](int qb, int s) {
    const int i0 = qb * GK_Q;
    cp_rows<HD>(Qs(s), L::LDH, base, C3, 0, m, win, i0, GK_Q);
    cp_rows<HD>(Gs(s), L::LDH, gy + h * HD, C, 0, m, win, i0, GK_Q);
    cp_f32_tile(Bs(s), L::LDT, bias_k + (size_t)i0 * N, N, GK_Q, GK_KEYS / 4);
    if (has_mask) cp_f32_tile(Ms(s), L::LDT, mask_k + (size_t)i0 * N, N, GK_Q, GK_KEYS / 4);
    cp_f32_tile(Ls(s), GK_Q, lse_g + sbase + i0, 0, 1, GK_Q / 4);
    cp_f32_tile(Ls(s) + GK_Q, GK_Q, del_g + sbase + i0, 0, 1, GK_Q / 4);
  };

  cp_rows<HD>(Kown, L::LDH, base, C3, C, m, win, k0, GK_KEYS);
  cp_rows<HD>(Vown, L::LDH, base, C3, 2 * C, m, win, k0, GK_KEYS);
  issue(0, 0);
  cp_async_commit();

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.0f;
  const int nqb = N / GK_Q;
  for (int qb = 0; qb < nqb; ++qb) {
    cp_async_wait<0>();  // block qb has landed,
    __syncthreads();     // and every warp is done with block qb - 1
    if (qb + 1 < nqb) issue(qb + 1, (qb + 1) & 1);
    cp_async_commit();
    const int s = qb & 1;

    // S^T and dP^T: rows this warp's 16 keys, columns the block's 64 queries
    float st[GK_Q / 8][4], dpt[GK_Q / 8][4];
#pragma unroll
    for (int i = 0; i < GK_Q / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      unsigned ka[4], va[4];
      ldsm_x4(ka, a_tile_addr(Kown, L::LDH, warp * 16, ks * 16, lane));
      ldsm_x4(va, a_tile_addr(Vown, L::LDH, warp * 16, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < GK_Q / 16; ++np) {
        unsigned b[4];
        ldsm_x4(b, b_tile_addr(Qs(s), L::LDH, np * 16, ks * 16, lane));
        mma_bf16(st[2 * np], ka, b[0], b[1]);
        mma_bf16(st[2 * np + 1], ka, b[2], b[3]);
        ldsm_x4(b, b_tile_addr(Gs(s), L::LDH, np * 16, ks * 16, lane));
        mma_bf16(dpt[2 * np], va, b[0], b[1]);
        mma_bf16(dpt[2 * np + 1], va, b[2], b[3]);
      }
    }
    const float* bt = Bs(s);
    const float* mt = Ms(s);
    const float* ls = Ls(s);
#pragma unroll
    for (int nt = 0; nt < GK_Q / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = nt * 8 + 2 * t4 + (e & 1);      // query in the block
        const int j = warp * 16 + g + 8 * (e >> 1);   // key in the block
        float b = bt[i * L::LDT + j];
        if (has_mask) b += mt[i * L::LDT + j];
        const float x = st[nt][e] * scale + b;
        const float p = exp2f(x * GA_LOG2E - ls[i] * GA_LOG2E);
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - ls[GK_Q + i]);
      }
    }
    // dV += P^T dO, dK += dS^T Q: P^T and dS^T re-packed as A operands
#pragma unroll
    for (int kk = 0; kk < GK_Q / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const unsigned da[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        unsigned b[4];
        ldsm_x4_t(b, b_tile_addr_t(Gs(s), L::LDH, kk * 16, np * 16, lane));
        mma_bf16(dv[2 * np], pa, b[0], b[1]);
        mma_bf16(dv[2 * np + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, b_tile_addr_t(Qs(s), L::LDH, kk * 16, np * 16, lane));
        mma_bf16(dk[2 * np], da, b[0], b[1]);
        mma_bf16(dk[2 * np + 1], da, b[2], b[3]);
      }
    }
  }
  bf16* ob = dqkv + h * HD;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    bf16* row = ob + m.tok(win, k0 + warp * 16 + g + 8 * hr) * C3;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int c = nt * 8 + 2 * t4;
      *reinterpret_cast<unsigned*>(row + C + c) =
          pack_bf16(scale * dk[nt][2 * hr], scale * dk[nt][2 * hr + 1]);
      *reinterpret_cast<unsigned*>(row + 2 * C + c) =
          pack_bf16(dv[nt][2 * hr], dv[nt][2 * hr + 1]);
    }
  }
}

// delta = rowsum(dO * O) per (window, head, row) from K8's f32 output
__global__ void global_attn_delta_kernel(const float* __restrict__ out,
                                         const bf16* __restrict__ gy, float* __restrict__ delta,
                                         GaWindows m, int C, int nh, int total) {
  const int N = m.ws * m.ws, hd = C / nh;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)total * N * nh) return;
  const int h = idx % nh;
  const int t = (idx / nh) % N;
  const int win = idx / ((size_t)nh * N);
  const size_t p = m.tok(win, t) * C + h * hd;
  float acc = 0.0f;
  for (int c = 0; c < hd; c += 8) {
    const float4 o0 = *reinterpret_cast<const float4*>(out + p + c);
    const float4 o1 = *reinterpret_cast<const float4*>(out + p + c + 4);
    const uint4 gv = *reinterpret_cast<const uint4*>(gy + p + c);
    const bf16* ge = reinterpret_cast<const bf16*>(&gv);
    const float oe[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) acc += oe[e] * __bfloat162float(ge[e]);
  }
  delta[((size_t)win * nh + h) * N + t] = acc;
}

template <int HD>
int launch_global_bwd(const void* qkv, const void* gy, const void* bias, const void* mask,
                      const float* lse, const float* del, void* dqkv, void* dbias,
                      const GaWindows& m, int C, int nh, int total, float scale,
                      cudaStream_t stream) {
  static int set_dq = 0, set_dkv = 0;
  const int N = m.ws * m.ws;
  const bool has_mask = mask != nullptr;
  const int slab = GqLayout<HD>::smem_bytes(has_mask, N, true) <= SMEM_MAX;
  const size_t s1 = GqLayout<HD>::smem_bytes(has_mask, N, slab);
  const size_t s2 = GkLayout<HD>::smem_bytes(has_mask);
  if (s1 > SMEM_MAX || s2 > SMEM_MAX) return (int)cudaErrorInvalidValue;
  ensure_smem(global_attn_bwd_dq_kernel<HD>, s1, set_dq);
  ensure_smem(global_attn_bwd_dkv_kernel<HD>, s2, set_dkv);
  global_attn_bwd_dq_kernel<HD><<<(N / GQ_R) * nh, GQ_WARPS * 32, s1, stream>>>(
      (const bf16*)qkv, (const bf16*)gy, (const float*)bias, (const float*)mask, lse, del,
      (bf16*)dqkv, (float*)dbias, m, C, nh, total, slab, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;
  global_attn_bwd_dkv_kernel<HD><<<nh * (N / GK_KEYS) * total, GK_WARPS * 32, s2, stream>>>(
      (const bf16*)qkv, (const bf16*)gy, (const float*)bias, (const float*)mask, lse, del,
      (bf16*)dqkv, m, C, nh, total, scale);
  return (int)cudaGetLastError();
}

}  // namespace sodt

// o_full, lse: K8's f32 output and log-sum-exp (both null: the statistics
// are computed here); stats: (2, B * nW, nh, N) f32 scratch (log-sum-exp,
// delta); dbias (nh, N, N) f32
extern "C" int sodt_global_attention_bwd(const void* qkv, const void* gy, const void* bias,
                                         const void* mask, const void* o_full, const void* lse,
                                         void* dqkv, void* dbias, void* stats, int B, int H,
                                         int W, int C, int nh, int ws, int has_mask,
                                         float scale, void* stream) {
  using namespace sodt;
  const int hd = C / nh, N = ws * ws;
  if (N % 64 != 0 || C % nh != 0 || hd % 16 != 0 || hd > 128)
    return (int)cudaErrorInvalidValue;
  const int total = B * (H / ws) * (W / ws);
  const GaWindows m = GaWindows::make(H, W, ws);
  const cudaStream_t st = (cudaStream_t)stream;
  if (!has_mask) mask = nullptr;
  float* lse_s = (float*)stats;
  float* del_s = lse_s + (size_t)total * nh * N;
  int err;
  if (lse != nullptr && o_full != nullptr) {
    const size_t rows = (size_t)total * N * nh;
    global_attn_delta_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
        (const float*)o_full, (const bf16*)gy, del_s, m, C, nh, total);
    err = (int)cudaGetLastError();
    lse_s = (float*)lse;
  } else {
    err = launch_global_fwd<GA_STATS>(qkv, bias, mask, nullptr, lse_s, nullptr, gy, del_s, B,
                                      H, W, C, nh, ws, scale, st);
  }
  if (err) return err;
  switch (hd) {
    case 16: return launch_global_bwd<16>(qkv, gy, bias, mask, lse_s, del_s, dqkv, dbias, m, C, nh, total, scale, st);
    case 32: return launch_global_bwd<32>(qkv, gy, bias, mask, lse_s, del_s, dqkv, dbias, m, C, nh, total, scale, st);
    case 48: return launch_global_bwd<48>(qkv, gy, bias, mask, lse_s, del_s, dqkv, dbias, m, C, nh, total, scale, st);
    case 64: return launch_global_bwd<64>(qkv, gy, bias, mask, lse_s, del_s, dqkv, dbias, m, C, nh, total, scale, st);
    case 80: return launch_global_bwd<80>(qkv, gy, bias, mask, lse_s, del_s, dqkv, dbias, m, C, nh, total, scale, st);
    case 96: return launch_global_bwd<96>(qkv, gy, bias, mask, lse_s, del_s, dqkv, dbias, m, C, nh, total, scale, st);
    case 112: return launch_global_bwd<112>(qkv, gy, bias, mask, lse_s, del_s, dqkv, dbias, m, C, nh, total, scale, st);
    default: return launch_global_bwd<128>(qkv, gy, bias, mask, lse_s, del_s, dqkv, dbias, m, C, nh, total, scale, st);
  }
}
