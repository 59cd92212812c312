// Shared pieces of the port's Hopper kernels (sm_90a): bf16 tensor-core
// tiles through WMMA (16x16x16, f32 accumulation), the tanh GELU of the
// Pallas kernels, cp.async copies, and the building blocks of the
// megakernels and of the windowed attention core. Every kernel launches on
// the caller's stream and allocates nothing; the Python wrapper allocates
// outputs with torch.empty.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace sodt {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// jax.nn.gelu(x, approximate=True), in f32
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return x * (0.5f * (1.0f + tanhf(k0 * (x + 0.044715f * (x * x * x)))));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Raise a kernel's dynamic shared-memory limit once per process (per
// launcher), not on every launch: `cur` is the launcher's static record.
template <typename Kern>
inline void ensure_smem(Kern kernel, size_t bytes, int& cur) {
  if ((int)bytes > cur) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cur = (int)bytes;
  }
}

// The opt-in shared-memory ceiling of one CTA on sm_90 (227 KB).
constexpr size_t SMEM_MAX = 232448;

// ---------------------------------------------------------------------------
// Building blocks of the per-tile megakernels (K2, K3, K4) and of the
// windowed attention core (K1, K5). All assume 8 warps (256 threads) unless
// stated.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem_src),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// CTA GEMM over a row block resident in shared memory:
//   Y[m, n] = sum_k A[m, k] * W[n, k],  m < 16*MT, n < N, k < K,
// W is a (N, ldw) row-major bf16 matrix in global memory (a torch Linear
// weight, read K-contiguous). Weight tiles of 64 (n) x 64 (k) are staged
// in shared memory by cp.async, double-buffered, and every staged tile
// serves all 16*MT rows. `aptr(tm, k)` returns the address of A's 16-row
// block tm at column k (row stride lda), so a caller can assemble A from
// shifted windows (the conv taps of K4). When an output 16x16 tile is
// finished, the owning warp stores it (f32, row-major, ld 16) in its
// staging tile `st` and calls epi(row0, col0, st, lane). Needs K % 16 == 0,
// N % 16 == 0, ldw % 8 == 0, MT even; wbuf holds GEMM_WBUF elements.
constexpr int GEMM_NB = 64, GEMM_KC = 64, GEMM_WLD = GEMM_KC + 8;
constexpr int GEMM_WBUF = 2 * GEMM_NB * GEMM_WLD;
constexpr size_t GEMM_SMEM = (size_t)GEMM_WBUF * 2 + 8 * 256 * 4;  // + staging tiles

template <int MT, class APtr, class Epi>
__device__ void cta_gemm(APtr aptr, int lda, const bf16* __restrict__ W, int ldw, int N,
                         int K, bf16* wbuf, float* st, Epi epi) {
  constexpr int TPW = MT / 2;  // 16x16 output tiles per warp and 64-column block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tn = warp & 3;
  const int nblocks = (N + GEMM_NB - 1) / GEMM_NB;
  const int kchunks = (K + GEMM_KC - 1) / GEMM_KC;
  const int steps = nblocks * kchunks;
  auto load = [&](int s) {
    const int nb = s / kchunks, kc = s % kchunks;
    bf16* dst = wbuf + (s & 1) * GEMM_NB * GEMM_WLD;
    for (int v = threadIdx.x; v < GEMM_NB * (GEMM_KC / 8); v += blockDim.x) {
      const int r = v / (GEMM_KC / 8), cv = (v % (GEMM_KC / 8)) * 8;
      const int n = nb * GEMM_NB + r, k = kc * GEMM_KC + cv;
      const bool ok = n < N && k < K;
      cp_async16(dst + r * GEMM_WLD + cv, ok ? W + (size_t)n * ldw + k : W, ok);
    }
    cp_async_commit();
  };
  FragC acc[TPW];
  load(0);
  for (int s = 0; s < steps; ++s) {
    const int nb = s / kchunks, kc = s % kchunks;
    if (kc == 0)
      for (int t = 0; t < TPW; ++t) wmma::fill_fragment(acc[t], 0.0f);
    if (s + 1 < steps) {
      load(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* wb = wbuf + (s & 1) * GEMM_NB * GEMM_WLD;
    const bool live = nb * GEMM_NB + tn * 16 < N;
    const int kmax = min(GEMM_KC, K - kc * GEMM_KC);
    if (live) {
      for (int kk = 0; kk < kmax; kk += 16) {
        FragBT bfr;
        wmma::load_matrix_sync(bfr, wb + tn * 16 * GEMM_WLD + kk, GEMM_WLD);
        for (int t = 0; t < TPW; ++t) {
          FragA a;
          wmma::load_matrix_sync(a, aptr((warp >> 2) + 2 * t, kc * GEMM_KC + kk), lda);
          wmma::mma_sync(acc[t], a, bfr, acc[t]);
        }
      }
      if (kc == kchunks - 1) {
        for (int t = 0; t < TPW; ++t) {
          wmma::store_matrix_sync(st, acc[t], 16, wmma::mem_row_major);
          __syncwarp();
          epi(((warp >> 2) + 2 * t) * 16, nb * GEMM_NB + tn * 16, st, lane);
          __syncwarp();
        }
      }
    }
    __syncthreads();  // the buffer is refilled by the next step's load
  }
}

// LayerNorm of `rows` rows (one warp per row): f32 statistics as
// var = E[x^2] - mu^2, eps 1e-5, then * g + b (f32) and one bf16 rounding
// (`_ln_rows_vpu` of the Pallas kernels). `get(row, c)` reads x as f32.
template <class Get>
__device__ void ln_rows(Get get, int rows, int C, const float* __restrict__ g,
                        const float* __restrict__ b, bf16* Y, int ldy) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int row = warp; row < rows; row += nwarps) {
    float s = 0.0f, s2 = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float v = get(row, c);
      s += v;
      s2 += v * v;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / C;
    const float rstd = rsqrtf(s2 / C - mu * mu + 1e-5f);
    for (int c = lane; c < C; c += 32)
      Y[(size_t)row * ldy + c] = __float2bfloat16((get(row, c) - mu) * rstd * g[c] + b[c]);
  }
}

// One warp's share of windowed attention: head rows r0 .. r0+15 of one
// window. Q (already scaled), K, V: bf16 in shared memory, one token per
// row (row stride ld), rows n .. np-1 padding (np = n rounded up to 16,
// np <= 256). Scores + bias_h (n, n) f32 (+ mask_w (n, n) f32, may be
// null) and the softmax are f32 in the warp's scratch S (16 x (np + 4)
// f32); P is rounded to bf16 in place over S; keys j >= n get zero weight.
// out(row, col, value) receives the f32 result (16 x hd) through the
// warp's 16x16 staging tile st.
__host__ __device__ inline size_t warp_attn_scratch_floats(int np) { return 16 * (np + 4); }

template <class Out>
__device__ void warp_attention_rows(const bf16* Q, const bf16* K, const bf16* V, int ld,
                                    int hd, int n, int np, int r0,
                                    const float* __restrict__ bias_h,
                                    const float* __restrict__ mask_w, float* S, float* st,
                                    Out out) {
  const int lane = threadIdx.x & 31;
  const int lds = np + 4;
  for (int tn = 0; tn < np / 16; ++tn) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < hd; k0 += 16) {
      FragA a;
      FragBT kb;
      wmma::load_matrix_sync(a, Q + r0 * ld + k0, ld);
      wmma::load_matrix_sync(kb, K + tn * 16 * ld + k0, ld);
      wmma::mma_sync(acc, a, kb, acc);
    }
    wmma::store_matrix_sync(S + tn * 16, acc, lds, wmma::mem_row_major);
  }
  __syncwarp();
  bf16* P = reinterpret_cast<bf16*>(S);
  const int ldp = 2 * lds;
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    float v[8];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = lane + 32 * i;
      v[i] = -INFINITY;
      if (j < n) {
        float s = 0.0f;  // padding query rows: any finite row, never written
        if (row < n) {
          s = S[r * lds + j] + bias_h[row * n + j];
          if (mask_w) s += mask_w[row * n + j];
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
    sum = warp_sum(sum);
    __syncwarp();  // every lane has read row r before P overwrites it
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = lane + 32 * i;
      if (j < np) P[r * ldp + j] = __float2bfloat16(v[i] / sum);
    }
  }
  __syncwarp();
  for (int tn = 0; tn < hd / 16; ++tn) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < np; k0 += 16) {
      FragA a;
      FragB vb;
      wmma::load_matrix_sync(a, P + k0, ldp);
      wmma::load_matrix_sync(vb, V + k0 * ld + tn * 16, ld);
      wmma::mma_sync(acc, a, vb, acc);
    }
    wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) out(r0 + (e >> 4), tn * 16 + (e & 15), st[e]);
    __syncwarp();
  }
}

}  // namespace sodt
