// K12: the int8 serving bodies of the Swin-block kernels. Replaces the
// int8 branches of sodt_tpu/pallas: swin_block.py _mega_q8_kernel (K2's
// twin), window_attention.py _block_attn_kernel with sqkv / sp (K3's and
// K5's), swin_block.py _conv_tail_kernel with s1 / sc / s2 (K4's),
// _mlp_tail_kernel (K6's) and _conv_tail_noln_kernel (K7's). Every
// projection is an s8 x s8 -> s32 tensor-core GEMM (quant.cuh); the
// attention core stays the bf16 forward of K1 / K5 (launch_window_attention
// of window_attention_fwd.cuh; att_groups: its groups of windows per head).
//
// Each body runs as launches split at its quantization points (quant.cuh
// says why), in the reference's rounding order. Launches per call:
//   K2  memset, LN1+absmax, qkv GEMM, attention core, absmax, proj GEMM
//       (res1 = x + proj + b in f32), LN2+absmax, fc1 GEMM (GELU, absmax),
//       fc2 GEMM (+ res1): 8 kernels
//   K3  memset, LN1 (rounded to bf16)+absmax, qkv, core, absmax, proj: 5
//   K5  memset, absmax of the shifted strip, qkv, core, absmax, proj: 5
//   K4  memset, LN2 of res1 and the halo rows+absmax, fc1 (halo zeroed on
//       the last strip, absmax), conv (K = 4C, GELU, absmax), fc2: 4
//   K7  as K4 with an absmax of y and its halo rows in place of the LN: 4
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

extern "C" int sodt_swin_block_q8(const void* x, const void* ln1g, const void* ln1b,
                                  const void* wqkv, const void* sqkv, const void* bqkv,
                                  const void* wp, const void* sp, const void* bp,
                                  const void* ln2g, const void* ln2b, const void* w1,
                                  const void* s1, const void* b1, const void* w2,
                                  const void* s2, const void* b2, const void* bias, void* out,
                                  void* f32ws, void* bf16ws, void* amax, int B, int H, int W,
                                  int C, int HID, int nh, int ws, float scale, int att_groups,
                                  void* stream) {
  using namespace sodt;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = B * H * W, S = B * (H / ws);
  const Strips strips{M, ws * W, W};
  float* L = (float*)f32ws;
  float* res = L + (size_t)M * C;
  float* hid = res + (size_t)M * C;
  bf16* qkv = (bf16*)bf16ws;
  bf16* att = qkv + (size_t)M * 3 * C;
  float* am = (float*)amax;
  Q8_TRY((int)cudaMemsetAsync(am, 0, (size_t)4 * S * sizeof(float), st));
  Q8_TRY(q8_ln(Val<ShiftedMap>{{(const bf16*)x, H, W, C, 0}}, M, C, ln1g, ln1b, 0, L, am,
               strips, st));
  Q8_TRY(q8_gemm<float>(RowsOf<float>{L, C}, wqkv, sqkv, am, strips, M, 3 * C, C,
                        EpiBf16{(const float*)bqkv, qkv, 3 * C}, nullptr, strips, st));
  Q8_TRY(launch_window_attention(MapWindows{H, W, ws, 0}, qkv, bias, nullptr, att,
                                 B * (H / ws) * (W / ws), C, nh, ws * ws, scale, att_groups,
                                 stream));
  Q8_TRY(q8_amax(Val<RowsOf<bf16>>{{att, C}}, M, C, am + S, strips, st));
  Q8_TRY(q8_gemm<bf16>(RowsOf<bf16>{att, C}, wp, sp, am + S, strips, M, C, C,
                       EpiRes1{(const bf16*)x, (const float*)bp, res, C}, nullptr, strips, st));
  Q8_TRY(q8_ln(Val<RowsOf<float>>{{res, C}}, M, C, ln2g, ln2b, 0, L, am + 2 * S, strips, st));
  Q8_TRY(q8_gemm<float>(RowsOf<float>{L, C}, w1, s1, am + 2 * S, strips, M, HID, C,
                        EpiGelu{(const float*)b1, hid, HID}, am + 3 * S, strips, st));
  Q8_TRY(q8_gemm<float>(RowsOf<float>{hid, HID}, w2, s2, am + 3 * S, strips, M, C, HID,
                        EpiOut{res, nullptr, nullptr, H, W, 0, (const float*)b2, (bf16*)out,
                               C, 1},
                        nullptr, strips, st));
  return 0;
}

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

// K4 (has_ln: in1 = x, in2 = a in shifted coordinates) and K7 (in1 = r,
// in2 = y): fc1 over the map rows and one halo row per strip of ws rows,
// the 2x2 conv, fc2 and the residual. wc (C, 2, 2, C) int8 is the conv's
// (N = C, K = 4C) matrix.
extern "C" int sodt_conv_tail_q8(const void* in1, const void* in2, const void* lng,
                                 const void* lnb, const void* w1, const void* s1, const void* b1,
                                 const void* wc, const void* sc, const void* bc, const void* w2,
                                 const void* s2, const void* b2, void* out, void* f32ws,
                                 void* amax, int has_ln, int B, int H, int W, int C, int ws,
                                 int shift, void* stream) {
  using namespace sodt;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = B * H * W, nr = H / ws, S = B * nr, rows = M + S * W;
  const Strips strips{M, ws * W, W};
  float* L = (float*)f32ws;
  float* f1 = L + (size_t)rows * C;
  float* y = f1 + (size_t)rows * C;
  float* am = (float*)amax;
  const EpiF32 to_f1{(const float*)b1, f1, C, M, W, nr};
  Q8_TRY((int)cudaMemsetAsync(am, 0, (size_t)3 * S * sizeof(float), st));
  if (has_ln) {
    Q8_TRY(q8_ln(ConvTailIn{(const bf16*)in1, (const bf16*)in2, M, H, W, C, ws, shift}, rows, C,
                 lng, lnb, 0, L, am, strips, st));
    Q8_TRY(q8_gemm<float>(RowsOf<float>{L, C}, w1, s1, am, strips, rows, C, C, to_f1, am + S,
                          strips, st));
  } else {
    const MapWithHalo yh{(const bf16*)in2, M, H, W, C, ws};
    Q8_TRY(q8_amax(Val<MapWithHalo>{yh}, rows, C, am, strips, st));
    Q8_TRY(q8_gemm<bf16>(yh, w1, s1, am, strips, rows, C, C, to_f1, am + S, strips, st));
  }
  Q8_TRY(q8_gemm<float>(ConvTaps{f1, M, H, W, C, ws}, wc, sc, am + S, strips, M, C, 4 * C,
                        EpiGelu{(const float*)bc, y, C}, am + 2 * S, strips, st));
  Q8_TRY(q8_gemm<float>(RowsOf<float>{y, C}, w2, s2, am + 2 * S, strips, M, C, C,
                        EpiOut{nullptr, (const bf16*)in1, has_ln ? (const bf16*)in2 : nullptr,
                               H, W, shift, (const float*)b2, (bf16*)out, C, 0},
                        nullptr, strips, st));
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
                        EpiOut{nullptr, (const bf16*)r, nullptr, H, W, 0, (const float*)b2,
                               (bf16*)out, C, 0},
                        nullptr, strips, st));
  return 0;
}
