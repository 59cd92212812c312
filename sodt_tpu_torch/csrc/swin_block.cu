// Swin-block megakernels for c <= 256 at head dims above 64 (no
// configuration of the repo: at 64 and below K2 is the chain of
// swin_block_chain.cu, K3 the chain of shifted_block_chain.cu):
//
//  * K2 swin_window_kernel<true>: the whole block with the linear MLP.
//    Replaces sodt_tpu/pallas/swin_block.py fused_swin_block
//    (_mega_kernel): LN1 -> qkv -> W-MSA -> proj -> +x -> LN2 -> fc1 ->
//    tanh-GELU -> fc2 -> +res. Everything after the attention is per token,
//    so the cyclic shift folds into the gather/scatter: a shifted linear
//    block runs here too (JAX takes its XLA path for that case).
//  * K3 swin_window_kernel<false>: LN1 + qkv + (shifted, masked) W-MSA +
//    proj, output in SHIFTED coordinates. Replaces
//    sodt_tpu/pallas/window_attention.py fused_block_attention_ln
//    (_block_attn_kernel with the LN).
//
// One CTA (8 warps) per window of n <= 64 tokens, padded to 64 rows.
// The window's rows never leave shared memory between the block input and
// output: LN1 reads x straight from global memory, qkv/attention/proj/LN2/
// hidden live in shared memory, and every GEMM streams its weight through
// cta_gemm's double-buffered 64x64 tiles (common.cuh). The hidden layer
// runs in chunks of HC columns when the whole hidden row block does not
// fit; fc2's partial sums then accumulate in the f32 residual buffer.
#include "common.cuh"

namespace sodt {

constexpr int SW_ROWS = 64;  // padded window rows per CTA (K2/K3)

__host__ __device__ inline size_t swin_window_smem(int C, int HC, bool full) {
  const size_t ls = (size_t)SW_ROWS * (C + 8) * 2;
  const size_t qs = (size_t)SW_ROWS * (3 * C + 8) * 2 + (size_t)8 * warp_attn_scratch_floats(64) * 4;
  const size_t mlp = (size_t)SW_ROWS * (C + 4) * 4 + (size_t)SW_ROWS * (HC + 8) * 2;
  return ls + (full && mlp > qs ? mlp : qs) + GEMM_SMEM;
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

template <bool FULL>
__global__ void __launch_bounds__(256, 1)
swin_window_kernel(const bf16* __restrict__ x, const float* __restrict__ ln1g,
                   const float* __restrict__ ln1b, const bf16* __restrict__ wqkv,
                   const bf16* __restrict__ bqkv, const bf16* __restrict__ wp,
                   const bf16* __restrict__ bp, const float* __restrict__ ln2g,
                   const float* __restrict__ ln2b, const bf16* __restrict__ w1,
                   const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                   const bf16* __restrict__ b2, const float* __restrict__ bias,
                   const float* __restrict__ mask, bf16* __restrict__ out, int H, int W, int C,
                   int HID, int HC, int nh, int ws, int shift, int has_mask, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldl = C + 8, ldq = 3 * C + 8, ldx = C + 4, ldh = HC + 8;
  bf16* Ls = reinterpret_cast<bf16*>(smem);
  unsigned char* region = smem + (size_t)SW_ROWS * ldl * 2;
  bf16* Qs = reinterpret_cast<bf16*>(region);
  float* S = reinterpret_cast<float*>(Qs + SW_ROWS * ldq);
  float* Xs = reinterpret_cast<float*>(region);           // after the attention
  bf16* Hs = reinterpret_cast<bf16*>(Xs + SW_ROWS * ldx);
  const size_t qs_bytes = (size_t)SW_ROWS * ldq * 2 + (size_t)8 * warp_attn_scratch_floats(64) * 4;
  const size_t mlp_bytes = (size_t)SW_ROWS * ldx * 4 + (size_t)SW_ROWS * ldh * 2;
  bf16* wbuf = reinterpret_cast<bf16*>(region + (FULL && mlp_bytes > qs_bytes ? mlp_bytes
                                                                               : qs_bytes));
  float* stage = reinterpret_cast<float*>(wbuf + GEMM_WBUF);
  const int warp = threadIdx.x >> 5;
  float* st = stage + warp * 256;

  const int n = ws * ws, np = (n + 15) & ~15, hd = C / nh;
  const int gx = W / ws, gy = H / ws;
  const int b = blockIdx.x / (gx * gy), widx = blockIdx.x % (gx * gy);
  const int wr = widx / gx, wc = widx % gx;
  // window token t sits at (r, c) in shifted coordinates and reads the map
  // at ((r + shift) mod H, (c + shift) mod W)
  auto src = [&](int t) -> size_t {
    const int r = wr * ws + t / ws, c = wc * ws + t % ws;
    return (size_t)(b * H + (r + shift) % H) * W + (c + shift) % W;
  };
  auto dst_shifted = [&](int t) -> size_t {
    return (size_t)(b * H + wr * ws + t / ws) * W + wc * ws + t % ws;
  };
  auto ls_rows = [&](int tm, int k) -> const bf16* { return Ls + tm * 16 * ldl + k; };

  // LN1, straight from global memory (padding rows read zeros)
  ln_rows([&](int t, int c) { return t < n ? bf(x[src(t) * C + c]) : 0.0f; }, SW_ROWS, C,
          ln1g, ln1b, Ls, ldl);
  __syncthreads();

  // qkv = LN1 . Wqkv^T + b in one bf16 rounding; q then scaled in bf16
  cta_gemm<4>(ls_rows, ldl, wqkv, C, 3 * C, C, wbuf, st,
              [&](int r0, int c0, const float* s, int lane) {
                for (int e = lane; e < 256; e += 32) {
                  const int r = r0 + (e >> 4), c = c0 + (e & 15);
                  float v = bf(__float2bfloat16(s[e] + bf(bqkv[c])));
                  if (c < C) v *= scale;
                  Qs[r * ldq + c] = __float2bfloat16(v);
                }
              });

  // W-MSA: one warp per (head, 16 query rows); the result overwrites LN1
  const float* mk = has_mask ? mask + (size_t)widx * n * n : nullptr;
  for (int item = warp; item < nh * (np / 16); item += 8) {
    const int h = item / (np / 16), qb = item % (np / 16);
    warp_attention_rows(Qs + h * hd, Qs + C + h * hd, Qs + 2 * C + h * hd, ldq, hd, n, np,
                        qb * 16, bias + (size_t)h * n * n, mk,
                        S + warp * warp_attn_scratch_floats(64), st,
                        [&](int t, int d, float v) {
                          Ls[t * ldl + h * hd + d] = __float2bfloat16(v);
                        });
  }
  __syncthreads();

  if (!FULL) {
    // K3: proj + b, written in shifted coordinates
    cta_gemm<4>(ls_rows, ldl, wp, C, C, C, wbuf, st,
                [&](int r0, int c0, const float* s, int lane) {
                  for (int e = lane; e < 256; e += 32) {
                    const int r = r0 + (e >> 4), c = c0 + (e & 15);
                    if (r < n) out[dst_shifted(r) * C + c] = __float2bfloat16(s[e] + bf(bp[c]));
                  }
                });
    return;
  }

  // K2: res1 = x + (proj + b), f32
  cta_gemm<4>(ls_rows, ldl, wp, C, C, C, wbuf, st,
              [&](int r0, int c0, const float* s, int lane) {
                for (int e = lane; e < 256; e += 32) {
                  const int r = r0 + (e >> 4), c = c0 + (e & 15);
                  const float xv = r < n ? bf(x[src(r) * C + c]) : 0.0f;
                  Xs[r * ldx + c] = xv + (s[e] + bf(bp[c]));
                }
              });
  ln_rows([&](int t, int c) { return Xs[t * ldx + c]; }, SW_ROWS, C, ln2g, ln2b, Ls, ldl);
  __syncthreads();

  const int nchunks = HID / HC;
  for (int ch = 0; ch < nchunks; ++ch) {
    cta_gemm<4>(ls_rows, ldl, w1 + (size_t)ch * HC * C, C, HC, C, wbuf, st,
                [&](int r0, int c0, const float* s, int lane) {
                  for (int e = lane; e < 256; e += 32) {
                    const int r = r0 + (e >> 4), c = c0 + (e & 15);
                    Hs[r * ldh + c] =
                        __float2bfloat16(gelu_tanh(s[e] + bf(b1[ch * HC + c])));
                  }
                });
    const bool last = ch == nchunks - 1;
    cta_gemm<4>([&](int tm, int k) -> const bf16* { return Hs + tm * 16 * ldh + k; }, ldh,
                w2 + (size_t)ch * HC, HID, C, HC, wbuf, st,
                [&](int r0, int c0, const float* s, int lane) {
                  for (int e = lane; e < 256; e += 32) {
                    const int r = r0 + (e >> 4), c = c0 + (e & 15);
                    const float v = Xs[r * ldx + c] + (s[e] + (ch == 0 ? bf(b2[c]) : 0.0f));
                    if (!last)
                      Xs[r * ldx + c] = v;
                    else if (r < n)
                      out[src(r) * C + c] = __float2bfloat16(v);
                  }
                });
  }
}

}  // namespace sodt

using sodt::bf16;

extern "C" int sodt_swin_block(const void* x, const void* ln1g, const void* ln1b,
                               const void* wqkv, const void* bqkv, const void* wp,
                               const void* bp, const void* ln2g, const void* ln2b,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               const void* bias, const void* mask, void* out, int B, int H,
                               int W, int C, int HID, int nh, int ws, int shift, int has_mask,
                               float scale, void* stream) {
  static int smem_set = 0;
  int HC = HID;
  while (sodt::swin_window_smem(C, HC, true) > sodt::SMEM_MAX && HC % 32 == 0) HC /= 2;
  const size_t smem = sodt::swin_window_smem(C, HC, true);
  if (smem > sodt::SMEM_MAX) return (int)cudaErrorInvalidValue;
  sodt::ensure_smem(sodt::swin_window_kernel<true>, smem, smem_set);
  const int grid = B * (H / ws) * (W / ws);
  sodt::swin_window_kernel<true><<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)ln1g, (const float*)ln1b, (const bf16*)wqkv,
      (const bf16*)bqkv, (const bf16*)wp, (const bf16*)bp, (const float*)ln2g,
      (const float*)ln2b, (const bf16*)w1, (const bf16*)b1, (const bf16*)w2, (const bf16*)b2,
      (const float*)bias, (const float*)mask, (bf16*)out, H, W, C, HID, HC, nh, ws, shift,
      has_mask, scale);
  return (int)cudaGetLastError();
}

extern "C" int sodt_block_attention_ln(const void* x, const void* ln1g, const void* ln1b,
                                       const void* wqkv, const void* bqkv, const void* wp,
                                       const void* bp, const void* bias, const void* mask,
                                       void* out, int B, int H, int W, int C, int nh, int ws,
                                       int shift, int has_mask, float scale, void* stream) {
  static int smem_set = 0;
  const size_t smem = sodt::swin_window_smem(C, 0, false);
  if (smem > sodt::SMEM_MAX) return (int)cudaErrorInvalidValue;
  sodt::ensure_smem(sodt::swin_window_kernel<false>, smem, smem_set);
  const int grid = B * (H / ws) * (W / ws);
  sodt::swin_window_kernel<false><<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)ln1g, (const float*)ln1b, (const bf16*)wqkv,
      (const bf16*)bqkv, (const bf16*)wp, (const bf16*)bp, nullptr, nullptr, nullptr,
      nullptr, nullptr, nullptr, (const float*)bias, (const float*)mask, (bf16*)out, H, W, C,
      0, 1, nh, ws, shift, has_mask, scale);
  return (int)cudaGetLastError();
}
