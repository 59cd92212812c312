// K5 and the windowed attention core's map entry.
//
// K5, sodt_block_attention_chain; replaces sodt_tpu/pallas/
// window_attention.py fused_block_attention (_block_attn_kernel without
// the LN): K3's chain (shifted_block_chain.cu) less its LN, three launches
// from one C entry over the (M, .) rows of a (B, H, W, C) map, M = B*H*W,
// with the Pallas kernel's rounding points:
//   qkv  = bf16(x Wqkv^T + bqkv)          gemm_core, GC_BIAS (N = 3C)
//   attn = bf16(softmax(bf16(q * bf16(scale)) k^T + bias (+ mask)) V)
//          on the windows of the map rolled by (-shift, -shift), written in
//          shifted coordinates          launch_window_attention: the
//                                          register body (FwdShiftedMap,
//                                          FwdMap at shift 0) at N <= 64,
//                                          the strip body above
//   out  = bf16(attn Wp^T + bp)           gemm_core, GC_BIAS
// The products are per token, so qkv runs on the unrolled map and the
// projection writes where the core wrote: the output stays in SHIFTED
// coordinates, as JAX's. The bias is added in f32 before the one bf16
// rounding of each GEMM, as K3's chain does.
//
// What bounds it on the H100: operations. At the flagship's stage 2 (M =
// 16,384 at batch 4, C 384, N 64) the function is 19.3 GFLOP + 1.6 GFLOP
// of attention (21 us at the bf16 peak) against 25 MB of input and output
// (7.5 us); the chain's own traffic (x, qkv written and read, attn written
// and read, out: 10 (M, C) bf16 maps, 126 MB) takes 37.6 us. Both GEMMs
// run on the wgmma core of gemm_core.cuh (BN 128 at N = 1,152, 96 at 384),
// the one K3's, K6's and K7's launches use. On an NVIDIA H100 80GB HBM3 at
// 700 W the chain takes 97-100 us a call (PERF.md, §6): qkv 48.5 us (~300
// TFLOP/s; its 1,152 CTAs fill 4.4 waves of two an SM), the core 32 / 36
// (unmasked / masked), the projection 15.7. Scratch qkv (M, 3C) and attn
// (M, C) bf16 comes from the wrapper. All launches on one stream, no
// atomics: repeats are bit-equal.
//
// sodt_window_attention is the attention core alone on a map (K1's
// `fused_window_attention_nhwc`, body `_strip_kernel`), at shift 0 or at a
// shift: token t of window (wr, wc) in shifted coordinates (r, c) reads its
// q / k / v at ((r + shift) mod H, (c + shift) mod W) and the head's output
// is written at (r, c).
#include "gemm_core.cuh"
#include "window_attention_fwd.cuh"

// N = ws * ws <= 256, head dim C / nh 16, 32, 48 or 64, 0 <= shift < ws, C
// a multiple of 8; scale rounded to bf16; groups: the register core's
// groups a head (fwd_groups; not read at N > 64); mask (nW, N, N) or null
extern "C" int sodt_block_attention_chain(const void* x, const void* wqkv, const void* bqkv,
                                          const void* wp, const void* bp, const void* bias,
                                          const void* mask, void* out, void* qkv, void* attn,
                                          int B, int H, int W, int C, int nh, int ws,
                                          int shift, int has_mask, float scale, int groups,
                                          void* stream) {
  using namespace sodt;
  const long long m = (long long)B * H * W;
  if (m <= 0 || m > 0x7fffffff || ws <= 0 || H % ws != 0 || W % ws != 0 || C % nh != 0 ||
      C % 8 != 0 || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  GemmArgs a{};
  a.A = (const bf16*)x;
  a.W = (const bf16*)wqkv;
  a.bias = (const bf16*)bqkv;
  a.out = (bf16*)qkv;
  a.M = (int)m;
  a.N = 3 * C;
  a.K = C;
  int err = launch_gemm_core<GC_ROWS, GC_BIAS>(a, st);
  if (err) return err;

  err = launch_window_attention(MapWindows{H, W, ws, shift}, qkv, bias,
                                has_mask ? mask : nullptr, attn, B * (H / ws) * (W / ws), C,
                                nh, ws * ws, scale, groups, stream);
  if (err) return err;

  a.A = (const bf16*)attn;
  a.W = (const bf16*)wp;
  a.bias = (const bf16*)bp;
  a.out = (bf16*)out;
  a.N = C;
  return launch_gemm_core<GC_ROWS, GC_BIAS>(a, st);
}

// groups: windows' groups per head of the register body (N <= 64), at most
// the number of its stages (B * nW windows, four to a stage at N <= 16)
extern "C" int sodt_window_attention(const void* qkv, const void* bias, const void* mask,
                                     void* out, int B, int H, int W, int C, int nh, int ws,
                                     int shift, int has_mask, float scale, int groups,
                                     void* stream) {
  return sodt::launch_window_attention(sodt::MapWindows{H, W, ws, shift}, qkv, bias,
                                       has_mask ? mask : nullptr, out,
                                       B * (H / ws) * (W / ws), C, nh, ws * ws, scale, groups,
                                       stream);
}
