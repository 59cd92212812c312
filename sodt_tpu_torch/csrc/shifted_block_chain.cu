// K3 and K4, the shifted stage-1 Swin block (blocks 1/3/5 of the flagship:
// shift ws / 2, the conv MLP), each as a chain of Hopper launches from one C
// entry, in the mould of K2's chain (swin_block_chain.cu). For a
// (B, H, W, C) map, M = B * H * W tokens, with the Pallas kernels' rounding
// points:
//
// K3, sodt_block_attention_ln_chain; replaces sodt_tpu/pallas/
// window_attention.py fused_block_attention_ln (_block_attn_kernel with the
// LN) at head dims of at most 64 (above, swin_window_kernel<false> of
// swin_block.cu):
//   ln   = bf16(LN(x))                    K13's body (sodt_layernorm)
//   qkv  = bf16(ln Wqkv^T + bqkv)         gemm_core, GC_BIAS
//   attn = bf16(softmax(bf16(q * bf16(scale)) k^T + bias (+ mask)) V)
//          on the windows of the map rolled by (-shift, -shift), written in
//          shifted coordinates       window_attention_fwd.cuh's core,
//                                          FwdShiftedMap (FwdMap at shift 0)
//   out  = bf16(attn Wp^T + bp)           gemm_core, GC_BIAS
// The output stays in SHIFTED coordinates, as JAX's: the projection is per
// token, so it writes where the core wrote.
//
// K4, sodt_conv_tail_chain; replaces sodt_tpu/pallas/swin_block.py
// fused_conv_mlp_tail (_conv_tail_kernel + _conv_gelu_fc2), every width:
//   res1 = x + a[(i - s) mod H, (j - s) mod W]  in f32, written in f32;
//   t    = bf16(LN(res1))                 one pass over x and a
//                                          (layernorm.cu, unshift_add_ln)
//   f1   = bf16(t W1^T + b1)              gemm_core, GC_BIAS
//   z    = bf16(gelu_tanh(conv2x2(f1) + bc))
//                                          gemm_core, GC_CONV2X2 + GC_GELU
//   out  = bf16(res1 + (z W2^T + b2))     gemm_core, GC_RESIDUAL_F32
// The conv gathers f1's 2x2 window as it copies A in; a tap below the last
// row or right of the last column reads zeros: JAX's zeroed last-strip halo
// and right pad on fc1's OUTPUT. res1 is never rounded.
//
// What bounds them on the H100: bytes. At the flagship's stage 1 (M =
// 65,536 at batch 4, C 192) K3's function needs 22.5 GFLOP (23 us at the
// bf16 peak) and K4's 29 GFLOP (29 us), while the chains move ~0.30 and
// ~0.33 GB through device memory (qkv, the attention output, the f32 res1,
// f1 and z written and read): ~90 and ~100 us at 3.35 TB/s. On an NVIDIA
// H100 80GB HBM3 at 700 W they take 201 and 181 us a call (PERF.md, §6),
// 2.2x and 1.9x those bytes. The megakernels they replace kept every
// intermediate on chip but ran one 8-warp CTA an SM per window or 4 x 16
// tile on legacy WMMA, every weight re-read from L2 for each of them: 1.7
// and 0.8 ms a call.
//
// Design: every launch is per token but the attention core (and K4's conv,
// a gather of f1's 2x2 window), so each runs in map order over (M, .)
// buffers at the GEMM core's rate; the shift lives in the core's read (K3)
// and in K4's front read of a. Scratch, from the wrapper: K3 ln (M, C) bf16
// (ln, then the attention output) and qkv (M, 3C) bf16; K4 res1 (M, C) f32,
// t (M, C) bf16 (t, then z) and f1 (M, C) bf16. All launches go on one
// stream in order; no atomics, so repeats are bit-equal.
#include "gemm_core.cuh"
#include "window_attention_fwd.cuh"

// layernorm.cu: K13's LayerNorm body on bf16 rows, and K4's front
extern "C" int sodt_layernorm(const void* x, const void* g, const void* beta, void* y, int R,
                              int C, float eps, void* stream);
extern "C" int sodt_unshift_add_layernorm(const void* x, const void* a, const void* g,
                                          const void* beta, void* res1, void* y, int R, int H,
                                          int W, int C, int shift, float eps, void* stream);

// N = ws * ws <= 64, head dim C / nh 16, 32, 48 or 64, 0 <= shift < ws, C a
// multiple of 8; scale rounded to bf16; groups: the attention core's groups
// a head (fwd_groups); mask (nW, N, N) or null
extern "C" int sodt_block_attention_ln_chain(const void* x, const void* lng, const void* lnb,
                                             const void* wqkv, const void* bqkv,
                                             const void* wp, const void* bp, const void* bias,
                                             const void* mask, void* out, void* ln, void* qkv,
                                             int B, int H, int W, int C, int nh, int ws,
                                             int shift, int has_mask, float scale, int groups,
                                             void* stream) {
  using namespace sodt;
  const int n = ws * ws, gx = W / ws, nw = (H / ws) * gx;
  const long long m = (long long)B * H * W;
  if (m <= 0 || m > 0x7fffffff || n > 64 || C % nh != 0 || C % 8 != 0 || shift < 0 ||
      shift >= ws)
    return (int)cudaErrorInvalidValue;
  const int M = (int)m;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = sodt_layernorm(x, lng, lnb, ln, M, C, 1e-5f, stream);
  if (err) return err;

  GemmArgs a{};
  a.A = (const bf16*)ln;
  a.W = (const bf16*)wqkv;
  a.bias = (const bf16*)bqkv;
  a.out = (bf16*)qkv;
  a.M = M;
  a.N = 3 * C;
  a.K = C;
  if ((err = launch_gemm_core<GC_ROWS, GC_BIAS>(a, st))) return err;

  const void* mk = has_mask ? mask : nullptr;
  err = shift == 0
            ? dispatch_window_attn_fwd(FwdMap{WrMap{H, W, ws, gx, nw}}, qkv, bias, mk, ln,
                                       B * nw, C, nh, n, scale, groups, st)
            : dispatch_window_attn_fwd(FwdShiftedMap{H, W, ws, gx, nw, shift}, qkv, bias, mk,
                                       ln, B * nw, C, nh, n, scale, groups, st);
  if (err) return err;

  a.W = (const bf16*)wp;
  a.bias = (const bf16*)bp;
  a.out = (bf16*)out;
  a.N = C;
  return launch_gemm_core<GC_ROWS, GC_BIAS>(a, st);
}

// C a multiple of 8, 0 <= shift < H, W; the conv weight wc (C, 2, 2, C),
// which is W (C, 4C) of the conv's GEMM as it stands
extern "C" int sodt_conv_tail_chain(const void* x, const void* a, const void* lng,
                                    const void* lnb, const void* w1, const void* b1,
                                    const void* wc, const void* bc, const void* w2,
                                    const void* b2, void* out, void* res1, void* t, void* f1,
                                    int B, int H, int W, int C, int shift, void* stream) {
  using namespace sodt;
  const long long m = (long long)B * H * W;
  if (m <= 0 || m > 0x7fffffff || C % 8 != 0) return (int)cudaErrorInvalidValue;
  const int M = (int)m;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = sodt_unshift_add_layernorm(x, a, lng, lnb, res1, t, M, H, W, C, shift, 1e-5f,
                                       stream);
  if (err) return err;

  GemmArgs g{};
  g.A = (const bf16*)t;
  g.W = (const bf16*)w1;
  g.bias = (const bf16*)b1;
  g.out = (bf16*)f1;
  g.M = M;
  g.N = C;
  g.K = C;
  if ((err = launch_gemm_core<GC_ROWS, GC_BIAS>(g, st))) return err;

  g.A = (const bf16*)f1;
  g.W = (const bf16*)wc;
  g.bias = (const bf16*)bc;
  g.out = (bf16*)t;
  g.K = 4 * C;
  g.H = H;
  g.Wd = W;
  if ((err = launch_gemm_core<GC_CONV2X2, GC_GELU>(g, st))) return err;

  g = GemmArgs{};
  g.A = (const bf16*)t;
  g.W = (const bf16*)w2;
  g.bias = (const bf16*)b2;
  g.R32 = (const float*)res1;
  g.out = (bf16*)out;
  g.M = M;
  g.N = C;
  g.K = C;
  return launch_gemm_core<GC_ROWS, GC_RESIDUAL_F32>(g, st);
}
