// K10: backward of the single-window ("global") attention K8.
// Replaces sodt_tpu/pallas/window_attention.py _global_bwd_dqkv_kernel +
// _global_bwd_dbias_kernel (_pallas_global_attention_bwd, _global_chunk_grads).
// Per (window, head), in f32, with S = scale * Q K^T + bias (+ mask) and
// P = softmax(S) recomputed (K8 keeps no log-sum-exp):
//   dP = dO V^T,  delta = rowsum(dP * P),  dS = P * (dP - delta)
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO,
//   dbias = sum over batch (and windows) of dS.
//
// Bound by bytes at small batch: the f32 bias (read) and dbias (written) are
// 50 MB each at N = 1024, nh = 12. Flash style, two kernels, 64 x 64 score
// tiles on the tensor cores, no (N, N) tensor in device memory but dbias:
//
//  * global_attn_bwd_dq_kernel, one CTA per (64 query rows, head). It walks
//    every window of the batch in order. Pass 1 over the key blocks takes
//    the row max, row sum and delta with one online rescaling (delta is
//    sum_j exp(S_ij - m_i) dP_ij / l_i, so it rescales like the sum): the
//    row statistics are recomputed here, not saved by the forward. Pass 2
//    forms dS per tile, accumulates dQ in shared memory (f32) and adds dS
//    into the CTA's own rows of dbias by plain read-modify-write: one owner
//    thread per address, windows in order, so dbias is deterministic and
//    written without atomics. The log-sum-exp and delta of every row go to
//    a small (B * nW, nh, N) f32 scratch for the second kernel.
//  * global_attn_bwd_dkv_kernel, one CTA per (64 key rows, window, head),
//    loops over the query blocks: P and dS tiles from the saved row
//    statistics, dV += P^T dO and dK += dS^T Q accumulated in f32 in shared
//    memory across all query blocks, rounded to bf16 once at the store
//    (the Pallas kernel keeps an f32 output for the same reason).
//
// The row-chunk structure of the TPU kernel (_bwd_row_chunk) is a VMEM
// device and is not carried over.
#include "common.cuh"

namespace sodt {

constexpr int GB_Q = 64, GB_KB = 64, GB_WARPS = 8;
constexpr int GB_LDS = GB_KB + 4, GB_LDP = GB_KB + 16;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;

__host__ __device__ inline size_t global_bwd_dq_smem_bytes(int hd) {
  return (size_t)4 * GB_Q * (hd + 16) * 2 + (size_t)2 * GB_Q * GB_LDS * 4 +
         (size_t)GB_Q * GB_LDP * 2 + (size_t)GB_Q * (hd + 4) * 4 + 4 * GB_Q * 4;
}

__host__ __device__ inline size_t global_bwd_dkv_smem_bytes(int hd) {
  return (size_t)4 * GB_Q * (hd + 16) * 2 + (size_t)2 * GB_Q * GB_LDS * 4 +
         (size_t)2 * GB_Q * GB_LDP * 2 + (size_t)2 * GB_Q * (hd + 4) * 4 + 2 * GB_Q * 4;
}

// 64 rows of one of q / k / v (col0 = 0, C, 2C) or of gy into shared memory
template <class Tok>
__device__ __forceinline__ void load_rows(bf16* dst, int ldq, const bf16* src, int stride,
                                          int col0, int t0, int hd, Tok tok) {
  const int vpr = hd / 8;
  for (int v = threadIdx.x; v < GB_Q * vpr; v += blockDim.x) {
    const int t = v / vpr, cv = (v % vpr) * 8;
    *reinterpret_cast<uint4*>(dst + t * ldq + cv) =
        *reinterpret_cast<const uint4*>(src + tok(t0 + t) * stride + col0 + cv);
  }
}

// S = A . B^T and D = G . V^T, both (64 x 64, f32, row stride GB_LDS), over hd
__device__ __forceinline__ void score_tiles(const bf16* A, const bf16* B, const bf16* G,
                                            const bf16* V, int ldq, int hd, float* S,
                                            float* D) {
  const int warp = threadIdx.x >> 5;
  const int tiles = (GB_Q / 16) * (GB_KB / 16);
  for (int tile = warp; tile < 2 * tiles; tile += GB_WARPS) {
    const int which = tile / tiles, tt = tile % tiles;
    const int tm = tt / (GB_KB / 16), tn = tt % (GB_KB / 16);
    const bf16* a_src = which ? G : A;
    const bf16* b_src = which ? V : B;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < hd; kk += 16) {
      FragA a;
      FragBT b;
      wmma::load_matrix_sync(a, a_src + tm * 16 * ldq + kk, ldq);
      wmma::load_matrix_sync(b, b_src + tn * 16 * ldq + kk, ldq);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync((which ? D : S) + tm * 16 * GB_LDS + tn * 16, acc, GB_LDS,
                            wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(GB_WARPS * 32)
global_attn_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gy,
                          const float* __restrict__ bias, const float* __restrict__ mask,
                          bf16* __restrict__ dqkv, float* __restrict__ dbias,
                          float* __restrict__ lse_g, float* __restrict__ del_g, int H, int W,
                          int C, int nh, int ws, int has_mask, float scale, int total) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hd = C / nh, ldq = hd + 16, ldo = hd + 4;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + GB_Q * ldq;
  bf16* Ks = Gs + GB_Q * ldq;
  bf16* Vs = Ks + GB_Q * ldq;
  float* S = reinterpret_cast<float*>(Vs + GB_Q * ldq);
  float* D = S + GB_Q * GB_LDS;
  bf16* Ps = reinterpret_cast<bf16*>(D + GB_Q * GB_LDS);
  float* Os = reinterpret_cast<float*>(Ps + GB_Q * GB_LDP);
  float* mrow = Os + GB_Q * ldo;
  float* lrow = mrow + GB_Q;
  float* arow = lrow + GB_Q;
  float* lse = arow + GB_Q;

  const int N = ws * ws;
  const int gx = W / ws, nw = (H / ws) * gx;
  const int q0 = blockIdx.x * GB_Q, h = blockIdx.y;
  const int C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dt = hd / 16;
  const float* brow = bias + ((size_t)h * N + q0) * N;
  float* dbrow = dbias + ((size_t)h * N + q0) * N;

  for (int win = 0; win < total; ++win) {
    const int b = win / nw, widx = win % nw;
    const int wr = widx / gx, wc = widx % gx;
    auto tok = [&](int t) {
      return (size_t)(b * H + wr * ws + t / ws) * W + wc * ws + t % ws;
    };
    const float* mrow_g = has_mask ? mask + ((size_t)widx * N + q0) * N : nullptr;
    const bf16* base = qkv + h * hd;

    __syncthreads();  // the previous window is done with shared memory
    load_rows(Qs, ldq, base, C3, 0, q0, hd, tok);
    load_rows(Gs, ldq, gy + h * hd, C, 0, q0, hd, tok);
    for (int e = threadIdx.x; e < GB_Q * hd; e += blockDim.x) Os[(e / hd) * ldo + e % hd] = 0.0f;
    for (int r = threadIdx.x; r < GB_Q; r += blockDim.x) {
      mrow[r] = -INFINITY;
      lrow[r] = 0.0f;
      arow[r] = 0.0f;
    }

    for (int pass = 0; pass < 2; ++pass) {
      for (int k0 = 0; k0 < N; k0 += GB_KB) {
        __syncthreads();  // the previous block is done with Ks / Vs / S / D / Ps
        load_rows(Ks, ldq, base, C3, C, k0, hd, tok);
        load_rows(Vs, ldq, base, C3, 2 * C, k0, hd, tok);
        __syncthreads();
        score_tiles(Qs, Ks, Gs, Vs, ldq, hd, S, D);
        __syncthreads();

        for (int row = warp; row < GB_Q; row += GB_WARPS) {
          const float* bptr = brow + (size_t)row * N + k0;
          float s0 = S[row * GB_LDS + lane] * scale + bptr[lane];
          float s1 = S[row * GB_LDS + lane + 32] * scale + bptr[lane + 32];
          if (mrow_g) {
            const float* mptr = mrow_g + (size_t)row * N + k0;
            s0 += mptr[lane];
            s1 += mptr[lane + 32];
          }
          const float d0 = D[row * GB_LDS + lane], d1 = D[row * GB_LDS + lane + 32];
          if (pass == 0) {
            const float m_old = mrow[row];
            const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
            const float alpha = expf(m_old - m_new);
            const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
            const float psum = warp_sum(p0 + p1);
            const float dsum = warp_sum(p0 * d0 + p1 * d1);
            __syncwarp();
            if (lane == 0) {
              mrow[row] = m_new;
              lrow[row] = lrow[row] * alpha + psum;
              arow[row] = arow[row] * alpha + dsum;
            }
          } else {
            const float l = lse[row], del = arow[row];
            const float ds0 = expf(s0 - l) * (d0 - del);
            const float ds1 = expf(s1 - l) * (d1 - del);
            float* dptr = dbrow + (size_t)row * N + k0;
            dptr[lane] = win == 0 ? ds0 : dptr[lane] + ds0;
            dptr[lane + 32] = win == 0 ? ds1 : dptr[lane + 32] + ds1;
            Ps[row * GB_LDP + lane] = __float2bfloat16(ds0);
            Ps[row * GB_LDP + lane + 32] = __float2bfloat16(ds1);
          }
        }
        if (pass == 1) {
          __syncthreads();
          for (int tile = warp; tile < (GB_Q / 16) * dt; tile += GB_WARPS) {
            const int tm = tile / dt, tn = tile % dt;
            FragC acc;
            wmma::load_matrix_sync(acc, Os + tm * 16 * ldo + tn * 16, ldo, wmma::mem_row_major);
            for (int kk = 0; kk < GB_KB; kk += 16) {
              FragA a;
              FragB kb;
              wmma::load_matrix_sync(a, Ps + tm * 16 * GB_LDP + kk, GB_LDP);
              wmma::load_matrix_sync(kb, Ks + kk * ldq + tn * 16, ldq);
              wmma::mma_sync(acc, a, kb, acc);
            }
            wmma::store_matrix_sync(Os + tm * 16 * ldo + tn * 16, acc, ldo,
                                    wmma::mem_row_major);
          }
        }
      }
      if (pass == 0) {
        __syncthreads();
        for (int r = threadIdx.x; r < GB_Q; r += blockDim.x) {
          const float l = mrow[r] + logf(lrow[r]);
          const float del = arow[r] / lrow[r];
          lse[r] = l;
          arow[r] = del;
          lse_g[((size_t)win * nh + h) * N + q0 + r] = l;
          del_g[((size_t)win * nh + h) * N + q0 + r] = del;
        }
      }
    }
    __syncthreads();
    bf16* obase = dqkv + h * hd;
    for (int e = threadIdx.x; e < GB_Q * hd; e += blockDim.x) {
      const int t = e / hd, d = e % hd;
      obase[tok(q0 + t) * C3 + d] = __float2bfloat16(scale * Os[t * ldo + d]);
    }
  }
}

__global__ void __launch_bounds__(GB_WARPS * 32)
global_attn_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gy,
                           const float* __restrict__ bias, const float* __restrict__ mask,
                           bf16* __restrict__ dqkv, const float* __restrict__ lse_g,
                           const float* __restrict__ del_g, int H, int W, int C, int nh,
                           int ws, int has_mask, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hd = C / nh, ldq = hd + 16, ldo = hd + 4;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + GB_Q * ldq;
  bf16* Qs = Vs + GB_Q * ldq;
  bf16* Gs = Qs + GB_Q * ldq;
  float* S = reinterpret_cast<float*>(Gs + GB_Q * ldq);
  float* D = S + GB_Q * GB_LDS;
  bf16* Pb = reinterpret_cast<bf16*>(D + GB_Q * GB_LDS);
  bf16* dSb = Pb + GB_Q * GB_LDP;
  float* dVs = reinterpret_cast<float*>(dSb + GB_Q * GB_LDP);
  float* dKs = dVs + GB_Q * ldo;
  float* lse = dKs + GB_Q * ldo;
  float* del = lse + GB_Q;

  const int N = ws * ws;
  const int gx = W / ws, nw = (H / ws) * gx;
  const int j0 = blockIdx.x * GB_KB;
  const int h = blockIdx.y % nh, win = blockIdx.y / nh;
  const int b = win / nw, widx = win % nw;
  const int wr = widx / gx, wc = widx % gx;
  const int C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dt = hd / 16;
  auto tok = [&](int t) {
    return (size_t)(b * H + wr * ws + t / ws) * W + wc * ws + t % ws;
  };
  const bf16* base = qkv + h * hd;
  const float* bias_h = bias + (size_t)h * N * N;
  const float* mask_w = has_mask ? mask + (size_t)widx * N * N : nullptr;
  const float* lse_w = lse_g + ((size_t)win * nh + h) * N;
  const float* del_w = del_g + ((size_t)win * nh + h) * N;

  load_rows(Ks, ldq, base, C3, C, j0, hd, tok);
  load_rows(Vs, ldq, base, C3, 2 * C, j0, hd, tok);
  for (int e = threadIdx.x; e < GB_Q * hd; e += blockDim.x) {
    dVs[(e / hd) * ldo + e % hd] = 0.0f;
    dKs[(e / hd) * ldo + e % hd] = 0.0f;
  }

  for (int i0 = 0; i0 < N; i0 += GB_Q) {
    __syncthreads();  // the previous query block is done with Qs / Gs / Pb / dSb
    load_rows(Qs, ldq, base, C3, 0, i0, hd, tok);
    load_rows(Gs, ldq, gy + h * hd, C, 0, i0, hd, tok);
    for (int r = threadIdx.x; r < GB_Q; r += blockDim.x) {
      lse[r] = lse_w[i0 + r];
      del[r] = del_w[i0 + r];
    }
    __syncthreads();
    score_tiles(Qs, Ks, Gs, Vs, ldq, hd, S, D);  // rows: queries, columns: this CTA's keys
    __syncthreads();
    for (int row = warp; row < GB_Q; row += GB_WARPS) {
      const float* bptr = bias_h + (size_t)(i0 + row) * N + j0;
      float s0 = S[row * GB_LDS + lane] * scale + bptr[lane];
      float s1 = S[row * GB_LDS + lane + 32] * scale + bptr[lane + 32];
      if (mask_w) {
        const float* mptr = mask_w + (size_t)(i0 + row) * N + j0;
        s0 += mptr[lane];
        s1 += mptr[lane + 32];
      }
      const float p0 = expf(s0 - lse[row]), p1 = expf(s1 - lse[row]);
      Pb[row * GB_LDP + lane] = __float2bfloat16(p0);
      Pb[row * GB_LDP + lane + 32] = __float2bfloat16(p1);
      dSb[row * GB_LDP + lane] = __float2bfloat16(p0 * (D[row * GB_LDS + lane] - del[row]));
      dSb[row * GB_LDP + lane + 32] =
          __float2bfloat16(p1 * (D[row * GB_LDS + lane + 32] - del[row]));
    }
    __syncthreads();
    // dV[k, :] += sum_q P[q, k] dO[q, :];  dK[k, :] += sum_q dS[q, k] Q[q, :]
    const int tiles = (GB_KB / 16) * dt;
    for (int tile = warp; tile < 2 * tiles; tile += GB_WARPS) {
      const int which = tile / tiles, tt = tile % tiles;
      const int tm = tt / dt, tn = tt % dt;
      float* accp = (which ? dKs : dVs) + tm * 16 * ldo + tn * 16;
      const bf16* at = (which ? dSb : Pb) + tm * 16;
      const bf16* bm = (which ? Qs : Gs) + tn * 16;
      FragC acc;
      wmma::load_matrix_sync(acc, accp, ldo, wmma::mem_row_major);
      for (int qq = 0; qq < GB_Q; qq += 16) {
        FragAT a;
        FragB bb;
        wmma::load_matrix_sync(a, at + qq * GB_LDP, GB_LDP);
        wmma::load_matrix_sync(bb, bm + qq * ldq, ldq);
        wmma::mma_sync(acc, a, bb, acc);
      }
      wmma::store_matrix_sync(accp, acc, ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();
  bf16* obase = dqkv + h * hd;
  for (int e = threadIdx.x; e < GB_KB * hd; e += blockDim.x) {
    const int t = e / hd, d = e % hd;
    const size_t p = tok(j0 + t) * C3 + d;
    obase[p + C] = __float2bfloat16(scale * dKs[t * ldo + d]);
    obase[p + 2 * C] = __float2bfloat16(dVs[t * ldo + d]);
  }
}

}  // namespace sodt

// stats: (2, B * nW, nh, N) f32 scratch (log-sum-exp, delta); dbias (nh, N, N) f32
extern "C" int sodt_global_attention_bwd(const void* qkv, const void* gy, const void* bias,
                                         const void* mask, void* dqkv, void* dbias,
                                         void* stats, int B, int H, int W, int C, int nh,
                                         int ws, int has_mask, float scale, void* stream) {
  static int smem_dq = 0, smem_dkv = 0;
  const int hd = C / nh, N = ws * ws;
  const int total = B * (H / ws) * (W / ws);
  const size_t s1 = sodt::global_bwd_dq_smem_bytes(hd), s2 = sodt::global_bwd_dkv_smem_bytes(hd);
  if (s1 > sodt::SMEM_MAX || s2 > sodt::SMEM_MAX || N % 64 != 0 || total * nh > 65535)
    return (int)cudaErrorInvalidValue;
  sodt::ensure_smem(sodt::global_attn_bwd_dq_kernel, s1, smem_dq);
  sodt::ensure_smem(sodt::global_attn_bwd_dkv_kernel, s2, smem_dkv);
  float* lse = (float*)stats;
  float* del = lse + (size_t)total * nh * N;
  sodt::global_attn_bwd_dq_kernel<<<dim3(N / sodt::GB_Q, nh), sodt::GB_WARPS * 32, s1,
                                    (cudaStream_t)stream>>>(
      (const sodt::bf16*)qkv, (const sodt::bf16*)gy, (const float*)bias, (const float*)mask,
      (sodt::bf16*)dqkv, (float*)dbias, lse, del, H, W, C, nh, ws, has_mask, scale, total);
  int err = (int)cudaGetLastError();
  if (err) return err;
  sodt::global_attn_bwd_dkv_kernel<<<dim3(N / sodt::GB_KB, total * nh), sodt::GB_WARPS * 32,
                                     s2, (cudaStream_t)stream>>>(
      (const sodt::bf16*)qkv, (const sodt::bf16*)gy, (const float*)bias, (const float*)mask,
      (sodt::bf16*)dqkv, lse, del, H, W, C, nh, ws, has_mask, scale);
  return (int)cudaGetLastError();
}
