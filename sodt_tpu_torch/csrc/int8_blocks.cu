// K12: the int8 serving bodies of K3, K5 and K6 on the WMMA s8 GEMM of
// quant.cuh. Replaces the int8 branches of sodt_tpu/pallas:
// window_attention.py _block_attn_kernel with sqkv / sp (K3's and K5's
// twins) and swin_block.py _mlp_tail_kernel (K6's). K2's and K4's / K7's
// twins are int8_chains.cu, on the s8 wgmma core. Every projection here is
// quant.cuh's q8_gemm_kernel, which quantizes its f32 or bf16 A while it
// stages it; the attention core stays the bf16 forward of K1 / K5
// (launch_window_attention of window_attention_fwd.cuh; att_groups: its
// groups of windows per head).
//
// Each body runs as launches split at its quantization points (quant.cuh
// says why), in the reference's rounding order. Launches per call:
//   K3  memset, LN1 (rounded to bf16)+absmax, qkv, core, absmax, proj: 5
//   K5  memset, absmax of the shifted strip, qkv, core, absmax, proj: 5
//   K6  memset, absmax, fc1 (GELU, absmax), fc2: 3
// Activations between launches live in f32 scratch that the wrapper
// allocates; the shifted blocks work in shifted coordinates throughout (a
// strip is then ws rows of the rolled map) and write their output there,
// as the Pallas kernels do. Bound by operations at the flagship's shapes
// (the projections); the f32 round trips make it far slower than that.
#include "quant.cuh"
#include "window_attention_fwd.cuh"

using sodt::bf16;
using sodt::Strips;

// K3 (has_ln) and K5: x (B, H, W, C) bf16 read at its shifted positions;
// the output is in shifted coordinates.
extern "C" int sodt_block_attention_q8(const void* x, const void* lng, const void* lnb,
                                       const void* wqkv, const void* sqkv, const void* bqkv,
                                       const void* wp, const void* sp, const void* bp,
                                       const void* bias, const void* mask, void* out,
                                       void* f32ws, void* bf16ws, void* amax, int has_ln, int B,
                                       int H, int W, int C, int nh, int ws, int shift,
                                       int has_mask, float scale, int att_groups, void* stream) {
  using namespace sodt;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = B * H * W, S = B * (H / ws);
  const Strips strips{M, ws * W, W};
  const ShiftedMap xs{(const bf16*)x, H, W, C, shift};
  bf16* qkv = (bf16*)bf16ws;
  bf16* att = qkv + (size_t)M * 3 * C;
  float* am = (float*)amax;
  const EpiBf16 to_qkv{(const float*)bqkv, qkv, 3 * C};
  Q8_TRY((int)cudaMemsetAsync(am, 0, (size_t)2 * S * sizeof(float), st));
  if (has_ln) {
    float* L = (float*)f32ws;
    Q8_TRY(q8_ln(Val<ShiftedMap>{xs}, M, C, lng, lnb, 1, L, am, strips, st));
    Q8_TRY(q8_gemm<float>(RowsOf<float>{L, C}, wqkv, sqkv, am, strips, M, 3 * C, C, to_qkv,
                          nullptr, strips, st));
  } else {
    Q8_TRY(q8_amax(Val<ShiftedMap>{xs}, M, C, am, strips, st));
    Q8_TRY(q8_gemm<bf16>(xs, wqkv, sqkv, am, strips, M, 3 * C, C, to_qkv, nullptr, strips, st));
  }
  // qkv is already in shifted coordinates: the core runs unshifted, masked
  Q8_TRY(launch_window_attention(MapWindows{H, W, ws, 0}, qkv, bias, has_mask ? mask : nullptr,
                                 att, B * (H / ws) * (W / ws), C, nh, ws * ws, scale, att_groups,
                                 stream));
  Q8_TRY(q8_amax(Val<RowsOf<bf16>>{{att, C}}, M, C, am + S, strips, st));
  Q8_TRY(q8_gemm<bf16>(RowsOf<bf16>{att, C}, wp, sp, am + S, strips, M, C, C,
                       EpiBf16{(const float*)bp, (bf16*)out, C}, nullptr, strips, st));
  return 0;
}

// K6: r + fc2(GELU(fc1(y))) with strips of ws rows.
extern "C" int sodt_mlp_tail_q8(const void* r, const void* y, const void* w1, const void* s1,
                                const void* b1, const void* w2, const void* s2, const void* b2,
                                void* out, void* f32ws, void* amax, int B, int H, int W, int C,
                                int HID, int ws, void* stream) {
  using namespace sodt;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = B * H * W, S = B * (H / ws);
  const Strips strips{M, ws * W, W};
  float* hid = (float*)f32ws;
  float* am = (float*)amax;
  Q8_TRY((int)cudaMemsetAsync(am, 0, (size_t)2 * S * sizeof(float), st));
  Q8_TRY(q8_amax(Val<RowsOf<bf16>>{{(const bf16*)y, C}}, M, C, am, strips, st));
  Q8_TRY(q8_gemm<bf16>(RowsOf<bf16>{(const bf16*)y, C}, w1, s1, am, strips, M, HID, C,
                       EpiGelu{(const float*)b1, hid, HID}, am + S, strips, st));
  Q8_TRY(q8_gemm<float>(RowsOf<float>{hid, HID}, w2, s2, am + S, strips, M, C, HID,
                        EpiOut{(const bf16*)r, (const float*)b2, (bf16*)out, C}, nullptr,
                        strips, st));
  return 0;
}
