// K2, the whole Swin block with the linear MLP, as a chain of Hopper
// launches. Replaces sodt_tpu/pallas/swin_block.py fused_swin_block (body
// _mega_kernel) at head dims of at most 64 (every configuration of the
// repo; above, swin_window_kernel<true> of swin_block.cu). For a
// (B, H, W, C) map, M = B * H * W tokens, with the kernel's rounding
// points:
//
//   ln1  = bf16(LN(x))                    K13's body (sodt_layernorm)
//   qkv  = bf16(ln1 Wqkv^T + bqkv)        gemm_core, GC_BIAS
//   attn = bf16(softmax(bf16(q * bf16(scale)) k^T + bias (+ mask)) V)
//                                          window_attention_fwd.cuh's core
//   res1 = x + (attn Wp^T + bp)  in f32   gemm_core, GC_RESIDUAL_OUT_F32
//   ln2  = bf16(LN(res1)), f32 stats      sodt_layernorm_f32rows
//   h1   = bf16(gelu_tanh(ln2 W1^T + b1)) gemm_core, GC_GELU
//   out  = bf16(res1 + (h1 W2^T + b2))    gemm_core, GC_RESIDUAL_F32
//
// res1 is never rounded: it goes through device memory in f32.
//
// What bounds it on the H100: bytes. At the flagship's stage 1 (M = 65,536
// at batch 4, C 192, hidden 768) the four GEMMs are 58 GFLOP (59 us at the
// bf16 peak) while the chain moves ~0.7 GB through device memory (qkv and
// the hidden written and read in bf16, res1 written and read twice in f32):
// ~0.21 ms at 3.35 TB/s. The megakernel it replaces kept every
// intermediate on chip but ran one 8-warp CTA an SM per window on legacy
// WMMA with every weight re-read from L2 for each of the 4,096 windows.
//
// Design: every step is per token except the attention core, and the
// cyclic shift lives in the core alone. Everything runs in map order; at
// shift s the core (FwdRolledMap) reads token (r, c) of a window of the
// rolled map at ((r + s) mod H, (c + s) mod W) and writes its output back
// there, so no roll is ever materialized. The GEMMs are gemm_core.cuh's
// wgmma core (128 x BN tiles, a cp.async ring), the core is K1's register
// body (scores and P in registers, fwd_groups groups a head). Scratch, from
// the wrapper: ln (M, C) bf16 (ln1, then the attention output, then ln2),
// wide (M, max(3C, hidden)) bf16 (qkv, then the hidden) and res1 (M, C)
// f32. All launches go on one stream in order; no atomics, so repeats are
// bit-equal.
#include "gemm_core.cuh"
#include "window_attention_fwd.cuh"

// layernorm.cu: K13's LayerNorm body on bf16 rows, and on f32 rows
extern "C" int sodt_layernorm(const void* x, const void* g, const void* beta, void* y, int R,
                              int C, float eps, void* stream);
extern "C" int sodt_layernorm_f32rows(const void* x, const void* g, const void* beta, void* y,
                                      int R, int C, float eps, void* stream);

// N = ws * ws <= 64, head dim C / nh 16, 32, 48 or 64, 0 <= shift < ws, C and
// HID multiples of 8; scale rounded to bf16; groups: the attention core's
// groups a head (fwd_groups); mask (nW, N, N) or null
extern "C" int sodt_swin_block_chain(const void* x, const void* ln1g, const void* ln1b,
                                     const void* wqkv, const void* bqkv, const void* wp,
                                     const void* bp, const void* ln2g, const void* ln2b,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, const void* bias, const void* mask,
                                     void* out, void* ln, void* wide, void* res1, int B, int H,
                                     int W, int C, int HID, int nh, int ws, int shift,
                                     int has_mask, float scale, int groups, void* stream) {
  using namespace sodt;
  const int n = ws * ws, gx = W / ws, nw = (H / ws) * gx;
  const long long m = (long long)B * H * W;
  if (m <= 0 || m > 0x7fffffff || n > 64 || C % nh != 0 || C % 8 != 0 || HID % 8 != 0 ||
      shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  const int M = (int)m;
  const cudaStream_t st = (cudaStream_t)stream;
  const float eps = 1e-5f;
  int err = sodt_layernorm(x, ln1g, ln1b, ln, M, C, eps, stream);
  if (err) return err;

  GemmArgs a{};
  a.A = (const bf16*)ln;
  a.W = (const bf16*)wqkv;
  a.bias = (const bf16*)bqkv;
  a.out = (bf16*)wide;
  a.M = M;
  a.N = 3 * C;
  a.K = C;
  if ((err = launch_gemm_core<GC_ROWS, GC_BIAS>(a, st))) return err;

  const void* mk = has_mask ? mask : nullptr;
  err = shift == 0
            ? dispatch_window_attn_fwd(FwdMap{WrMap{H, W, ws, gx, nw}}, wide, bias, mk, ln,
                                       B * nw, C, nh, n, scale, groups, st)
            : dispatch_window_attn_fwd(FwdRolledMap{{H, W, ws, gx, nw, shift}}, wide, bias, mk,
                                       ln, B * nw, C, nh, n, scale, groups, st);
  if (err) return err;

  a = GemmArgs{};
  a.A = (const bf16*)ln;
  a.W = (const bf16*)wp;
  a.bias = (const bf16*)bp;
  a.R = (const bf16*)x;
  a.out32 = (float*)res1;
  a.M = M;
  a.N = C;
  a.K = C;
  if ((err = launch_gemm_core<GC_ROWS, GC_RESIDUAL_OUT_F32>(a, st))) return err;

  if ((err = sodt_layernorm_f32rows(res1, ln2g, ln2b, ln, M, C, eps, stream))) return err;

  a = GemmArgs{};
  a.A = (const bf16*)ln;
  a.W = (const bf16*)w1;
  a.bias = (const bf16*)b1;
  a.out = (bf16*)wide;
  a.M = M;
  a.N = HID;
  a.K = C;
  if ((err = launch_gemm_core<GC_ROWS, GC_GELU>(a, st))) return err;

  a = GemmArgs{};
  a.A = (const bf16*)wide;
  a.W = (const bf16*)w2;
  a.bias = (const bf16*)b2;
  a.R32 = (const float*)res1;
  a.out = (bf16*)out;
  a.M = M;
  a.N = C;
  a.K = HID;
  return launch_gemm_core<GC_ROWS, GC_RESIDUAL_F32>(a, st);
}
