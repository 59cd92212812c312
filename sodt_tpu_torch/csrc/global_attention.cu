// K8: single-window ("global") attention with a full additive bias.
// Replaces sodt_tpu/pallas/window_attention.py fused_global_attention
// (_global_kernel). Flash style: one CTA per (64 query rows, window, head).
// The map may hold several ws x ws windows (N = ws*ws tokens each, with an
// optional (nW, N, N) mask): the same kernel then serves the large-window
// case (ws*ws > 256) that JAX leaves to its XLA composition. q/k/v are read
// straight from the fused (B, H, W, 3C) projection; 64-key
// blocks of K and V stream through shared memory; each score tile gets
// its (nh, N, N) f32 bias tile added, then an online softmax (running max
// and sum per row, f32) rescales the f32 output accumulator, which stays
// in shared memory. The (N, N) scores never reach device memory.
#include "common.cuh"

namespace sodt {

constexpr int GA_Q = 64, GA_KB = 64;

__host__ __device__ inline size_t global_attn_smem_bytes(int hd) {
  return (size_t)3 * GA_Q * (hd + 16) * 2 + (size_t)GA_Q * (GA_KB + 4) * 4 +
         (size_t)GA_Q * (GA_KB + 16) * 2 + (size_t)GA_Q * (hd + 4) * 4 + 2 * GA_Q * 4;
}

__global__ void __launch_bounds__(128)
global_attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                   const float* __restrict__ mask, bf16* __restrict__ out, int H, int W,
                   int C, int nh, int ws, int has_mask, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hd = C / nh;
  const int ldq = hd + 16, lds = GA_KB + 4, ldp = GA_KB + 16, ldo = hd + 4;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + GA_Q * ldq;
  bf16* Vs = Ks + GA_Q * ldq;
  float* S = reinterpret_cast<float*>(Vs + GA_Q * ldq);
  bf16* Ps = reinterpret_cast<bf16*>(S + GA_Q * lds);
  float* Os = reinterpret_cast<float*>(Ps + GA_Q * ldp);
  float* mrow = Os + GA_Q * ldo;
  float* lrow = mrow + GA_Q;

  const int N = ws * ws;
  const int gx = W / ws, nw = (H / ws) * gx;
  const int q0 = blockIdx.x * GA_Q;
  const int h = blockIdx.y % nh, win = blockIdx.y / nh;
  const int b = win / nw, widx = win % nw;
  const int wr = widx / gx, wc = widx % gx;
  const int C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  // map index of window token t
  auto tok = [&](int t) {
    return (size_t)(b * H + wr * ws + t / ws) * W + wc * ws + t % ws;
  };
  const bf16* base = qkv + h * hd;
  const int vpr = hd / 8;

  for (int v = threadIdx.x; v < GA_Q * vpr; v += blockDim.x) {
    const int t = v / vpr, cv = (v % vpr) * 8;
    uint4 q = *reinterpret_cast<const uint4*>(base + tok(q0 + t) * C3 + cv);
    bf16* qe = reinterpret_cast<bf16*>(&q);
    for (int e = 0; e < 8; ++e)
      qe[e] = __float2bfloat16(__bfloat162float(qe[e]) * scale);
    *reinterpret_cast<uint4*>(Qs + t * ldq + cv) = q;
  }
  for (int e = threadIdx.x; e < GA_Q * hd; e += blockDim.x)
    Os[(e / hd) * ldo + e % hd] = 0.0f;
  for (int r = threadIdx.x; r < GA_Q; r += blockDim.x) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.0f;
  }

  const float* brow = bias + ((size_t)h * N + q0) * N;
  const float* mrow_g = has_mask ? mask + ((size_t)widx * N + q0) * N : nullptr;
  const int dt = hd / 16;
  for (int k0 = 0; k0 < N; k0 += GA_KB) {
    __syncthreads();  // previous PV done with Ks/Vs/Ps
    for (int v = threadIdx.x; v < GA_KB * vpr; v += blockDim.x) {
      const int t = v / vpr, cv = (v % vpr) * 8;
      const bf16* src = base + tok(k0 + t) * C3 + cv;
      *reinterpret_cast<uint4*>(Ks + t * ldq + cv) = *reinterpret_cast<const uint4*>(src + C);
      *reinterpret_cast<uint4*>(Vs + t * ldq + cv) =
          *reinterpret_cast<const uint4*>(src + 2 * C);
    }
    __syncthreads();

    for (int tile = warp; tile < (GA_Q / 16) * (GA_KB / 16); tile += nwarps) {
      const int tm = tile / (GA_KB / 16), tn = tile % (GA_KB / 16);
      FragC acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < hd; kk += 16) {
        FragA a;
        FragBT kb;
        wmma::load_matrix_sync(a, Qs + tm * 16 * ldq + kk, ldq);
        wmma::load_matrix_sync(kb, Ks + tn * 16 * ldq + kk, ldq);
        wmma::mma_sync(acc, a, kb, acc);
      }
      wmma::store_matrix_sync(S + tm * 16 * lds + tn * 16, acc, lds, wmma::mem_row_major);
    }
    __syncthreads();

    for (int row = warp; row < GA_Q; row += nwarps) {
      const float* bptr = brow + (size_t)row * N + k0;
      float s0 = S[row * lds + lane] + bptr[lane];
      float s1 = S[row * lds + lane + 32] + bptr[lane + 32];
      if (mrow_g) {
        const float* mptr = mrow_g + (size_t)row * N + k0;
        s0 += mptr[lane];
        s1 += mptr[lane + 32];
      }
      const float m_old = mrow[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_old - m_new);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float psum = warp_sum(p0 + p1);
      Ps[row * ldp + lane] = __float2bfloat16(p0);
      Ps[row * ldp + lane + 32] = __float2bfloat16(p1);
      for (int d = lane; d < hd; d += 32) Os[row * ldo + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        mrow[row] = m_new;
        lrow[row] = lrow[row] * alpha + psum;
      }
    }
    __syncthreads();

    for (int tile = warp; tile < (GA_Q / 16) * dt; tile += nwarps) {
      const int tm = tile / dt, tn = tile % dt;
      FragC acc;
      wmma::load_matrix_sync(acc, Os + tm * 16 * ldo + tn * 16, ldo, wmma::mem_row_major);
      for (int kk = 0; kk < GA_KB; kk += 16) {
        FragA a;
        FragB vb;
        wmma::load_matrix_sync(a, Ps + tm * 16 * ldp + kk, ldp);
        wmma::load_matrix_sync(vb, Vs + kk * ldq + tn * 16, ldq);
        wmma::mma_sync(acc, a, vb, acc);
      }
      wmma::store_matrix_sync(Os + tm * 16 * ldo + tn * 16, acc, ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  bf16* obase = out + h * hd;
  for (int e = threadIdx.x; e < GA_Q * hd; e += blockDim.x) {
    const int t = e / hd, d = e % hd;
    obase[tok(q0 + t) * C + d] = __float2bfloat16(Os[t * ldo + d] / lrow[t]);
  }
}

}  // namespace sodt

extern "C" int sodt_global_attention(const void* qkv, const void* bias, const void* mask,
                                     void* out, int B, int H, int W, int C, int nh, int ws,
                                     int has_mask, float scale, void* stream) {
  static int smem_set = 0;
  const size_t smem = sodt::global_attn_smem_bytes(C / nh);
  sodt::ensure_smem(sodt::global_attn_kernel, smem, smem_set);
  dim3 grid(ws * ws / sodt::GA_Q, B * (H / ws) * (W / ws) * nh);
  sodt::global_attn_kernel<<<grid, 128, smem, (cudaStream_t)stream>>>(
      (const sodt::bf16*)qkv, (const float*)bias, (const float*)mask, (sodt::bf16*)out, H, W,
      C, nh, ws, has_mask, scale);
  return (int)cudaGetLastError();
}
