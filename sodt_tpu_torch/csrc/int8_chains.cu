// K12, the int8 serving bodies, as chains of Hopper launches on the s8
// wgmma core (gemm_s8_core.cuh, which says what bounds them and how the
// core is built), with every activation crossing launches as int8 codes:
//
//   sodt_swin_block_q8       K2's twin: the int8 branch of sodt_tpu/pallas/
//                            swin_block.py _mega_q8_kernel (l.158, through
//                            _pallas_swin_block_q8 l.244), the unshifted block
//   sodt_block_attention_q8  K3's twin (has_ln) and K5's: the sqkv_ref /
//                            sp_ref branches of window_attention.py
//                            _block_attn_kernel (l.522-525, 558-560)
//   sodt_conv_tail_q8        K4's twin (has_ln: the int8 branch of
//                            _conv_tail_kernel, l.356-357, 380-395, 410-411)
//                            and K7's (_conv_tail_noln_kernel, l.630-631)
//   sodt_mlp_tail_q8         K6's twin: the s1_ref / s2_ref branch of
//                            _mlp_tail_kernel (l.549-557)
//
// A strip's activation scale must be final before any CTA quantizes (a
// strip is 1,024 tokens at the flagship's stage 1), so each body runs as
// launches split at its quantization points (quant.cuh). A point's
// producer runs twice: first it folds max |value| into the strip slots and
// stores nothing, then it computes the same values again (the same device
// function, explicit roundings, an exact int32 sum) and writes their int8
// codes under the finished scale; the next GEMM loads the codes with
// cp.async. The conv (K = 4C) and K6's fc1 (N = 4C at C 384) are the
// exceptions: a second run of either costs more than storing its output in
// f32 once and quantizing that in a row pass. Launches per call, in the
// reference's rounding order:
//
//   K2 twin  memset; LN1 fold, LN1 codes; qkv (bf16(v + bqkv)); the
//            attention core (bf16, window_attention_fwd.cuh); att fold, att
//            codes; proj (res1 = (x + v) + bp, f32); LN2 fold, LN2 codes
//            (from res1); fc1 fold, fc1 codes (tanh-GELU(v + b1)); fc2
//            (bf16((res1 + v) + b2)): 11 kernels
//   K3 / K5  memset; fold and codes of x's (-shift, -shift)-rolled map
//            (K3: its LN, rounded to bf16 as the reference rounds it; K5: x
//            as it is); qkv (bf16(v + bqkv)); the attention core, masked
//            where shift > 0; att fold, att codes; proj (bf16(v + bp)): 7
//            kernels, in shifted coordinates throughout (a strip is ws rows
//            of the rolled map) and the output too, as the Pallas kernel's
//   K4 / K7  memset; LN fold, LN codes (K4: LN2 of res1 = x + a read at its
//            un-shifted position, and of the halo rows; K7: y and its halo
//            rows as they are); fc1 fold, fc1 codes (v + b1, the halo rows
//            of an image's last strip 0); the 2x2 conv over f1's codes (K =
//            4C, tanh-GELU(v + bc)) once, its f32 output and the fold, then
//            a row pass of codes; fc2 (bf16(res + (v + b2)), res = x + a
//            un-shifted, or r): 7 kernels
//   K6 twin  memset; y fold, y codes; fc1 (tanh-GELU(v + b1), N = 4C)
//            once, its f32 output and the fold, then a row pass of codes;
//            fc2 (bf16(r + (v + b2))): 5 kernels, strips of kernels/quant.py
//            tail_ws(H) rows
//
// res1 (K2) is f32, as the reference keeps it. The halo rows (one map row a
// strip: the first row of the next strip, clamped) follow the M map rows;
// K4's keeps the reference's quirk (quant.cuh ConvTailIn, ROADMAP Queue 3).
// Scratch, from the wrapper: the codes, K2's res1 (f32), qkv / att (bf16),
// K4's / K7's conv output and K6's hidden (f32). Biases are read in bf16,
// the working dtype the reference adds them in. No atomics on an output:
// repeats are bit-equal.
#include "gemm_s8_core.cuh"
#include "window_attention_fwd.cuh"

using sodt::bf16;
using sodt::Strips;

namespace {

sodt::S8Args s8_args(const void* A, const void* W, const void* sw, const float* amax_in,
                     Strips strips, int M, int N, int K) {
  sodt::S8Args a{};
  a.A = (const signed char*)A;
  a.W = (const signed char*)W;
  a.sw = (const float*)sw;
  a.amax_in = amax_in;
  a.sin = a.sout = strips;
  a.M = M, a.N = N, a.K = K;
  return a;
}

}  // namespace

// x (B, H, W, C) bf16; C % 32 == 0, C <= 512, HID % 32 == 0; scratch res1
// (M, C) f32, codes (M, C) and hid (M, HID) int8, bf16ws (M, 4C) bf16 (qkv,
// att), amax 4 B H / ws f32
extern "C" int sodt_swin_block_q8(const void* x, const void* ln1g, const void* ln1b,
                                  const void* wqkv, const void* sqkv, const void* bqkv,
                                  const void* wp, const void* sp, const void* bp,
                                  const void* ln2g, const void* ln2b, const void* w1,
                                  const void* s1, const void* b1, const void* w2,
                                  const void* s2, const void* b2, const void* bias, void* out,
                                  void* res1, void* codes, void* hid, void* bf16ws, void* amax,
                                  int B, int H, int W, int C, int HID, int nh, int ws,
                                  float scale, int att_groups, void* stream) {
  using namespace sodt;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = B * H * W, S = B * (H / ws);
  const Strips strips{M, ws * W, W};
  float* res = (float*)res1;
  bf16* qkv = (bf16*)bf16ws;
  bf16* att = qkv + (size_t)M * 3 * C;
  float* am = (float*)amax;
  const Ptr4<RowsOf<bf16>> xs{{(const bf16*)x, C}}, as{{att, C}};
  const Ptr4<RowsOf<float>> rs{{res, C}};
  Q8_TRY((int)cudaMemsetAsync(am, 0, (size_t)4 * S * sizeof(float), st));
  Q8_TRY((q8_rowpass<true, GS_FOLD>(xs, M, C, ln1g, ln1b, am, strips, nullptr, nullptr, st)));
  Q8_TRY((q8_rowpass<true, GS_CODES>(xs, M, C, ln1g, ln1b, am, strips, codes, nullptr, st)));
  Q8_TRY((launch_gemm_s8<GS_ROWS, GS_FOLD>(s8_args(codes, wqkv, sqkv, am, strips, M, 3 * C, C),
                                           GsBf16{(const bf16*)bqkv, qkv}, st)));
  Q8_TRY(launch_window_attention(MapWindows{H, W, ws, 0}, qkv, bias, nullptr, att,
                                 B * (H / ws) * (W / ws), C, nh, ws * ws, scale, att_groups,
                                 stream));
  Q8_TRY((q8_rowpass<false, GS_FOLD>(as, M, C, nullptr, nullptr, am + S, strips, nullptr,
                                     nullptr, st)));
  Q8_TRY((q8_rowpass<false, GS_CODES>(as, M, C, nullptr, nullptr, am + S, strips, codes,
                                      nullptr, st)));
  Q8_TRY((launch_gemm_s8<GS_ROWS, GS_FOLD>(s8_args(codes, wp, sp, am + S, strips, M, C, C),
                                           GsRes1{(const bf16*)x, (const bf16*)bp, res}, st)));
  Q8_TRY((q8_rowpass<true, GS_FOLD>(rs, M, C, ln2g, ln2b, am + 2 * S, strips, nullptr, nullptr,
                                    st)));
  Q8_TRY((q8_rowpass<true, GS_CODES>(rs, M, C, ln2g, ln2b, am + 2 * S, strips, codes, nullptr,
                                     st)));
  S8Args f1 = s8_args(codes, w1, s1, am + 2 * S, strips, M, HID, C);
  f1.amax_out = am + 3 * S;
  f1.codes = (signed char*)hid;
  Q8_TRY((launch_gemm_s8<GS_ROWS, GS_FOLD>(f1, GsGelu{(const bf16*)b1}, st)));
  Q8_TRY((launch_gemm_s8<GS_ROWS, GS_CODES>(f1, GsGelu{(const bf16*)b1}, st)));
  Q8_TRY((launch_gemm_s8<GS_ROWS, GS_FOLD>(
      s8_args(hid, w2, s2, am + 3 * S, strips, M, C, HID),
      GsOut{res, nullptr, nullptr, H, W, 0, (const bf16*)b2, (bf16*)out, 1}, st)));
  return 0;
}

// K3 (has_ln) and K5: x (B, H, W, C) bf16 read at its (-shift,
// -shift)-rolled position; out (B, H, W, C) bf16 in shifted coordinates.
// C % 32 == 0, C <= 512; scratch codes (M, C) int8, bf16ws (M, 4C) bf16
// (qkv, att), amax 2 B H / ws f32
extern "C" int sodt_block_attention_q8(const void* x, const void* lng, const void* lnb,
                                       const void* wqkv, const void* sqkv, const void* bqkv,
                                       const void* wp, const void* sp, const void* bp,
                                       const void* bias, const void* mask, void* out,
                                       void* codes, void* bf16ws, void* amax, int has_ln, int B,
                                       int H, int W, int C, int nh, int ws, int shift,
                                       int has_mask, float scale, int att_groups, void* stream) {
  using namespace sodt;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = B * H * W, S = B * (H / ws);
  const Strips strips{M, ws * W, W};
  bf16* qkv = (bf16*)bf16ws;
  bf16* att = qkv + (size_t)M * 3 * C;
  float* am = (float*)amax;
  const Ptr4<ShiftedMap> xs{{(const bf16*)x, H, W, C, shift}};
  const Ptr4<RowsOf<bf16>> as{{att, C}};
  Q8_TRY((int)cudaMemsetAsync(am, 0, (size_t)2 * S * sizeof(float), st));
  if (has_ln) {
    Q8_TRY((q8_rowpass<true, GS_FOLD, true>(xs, M, C, lng, lnb, am, strips, nullptr, nullptr,
                                            st)));
    Q8_TRY((q8_rowpass<true, GS_CODES, true>(xs, M, C, lng, lnb, am, strips, codes, nullptr,
                                             st)));
  } else {
    Q8_TRY((q8_rowpass<false, GS_FOLD>(xs, M, C, nullptr, nullptr, am, strips, nullptr, nullptr,
                                       st)));
    Q8_TRY((q8_rowpass<false, GS_CODES>(xs, M, C, nullptr, nullptr, am, strips, codes, nullptr,
                                        st)));
  }
  Q8_TRY((launch_gemm_s8<GS_ROWS, GS_FOLD>(s8_args(codes, wqkv, sqkv, am, strips, M, 3 * C, C),
                                           GsBf16{(const bf16*)bqkv, qkv}, st)));
  // qkv is already in shifted coordinates: the core runs unshifted, masked
  Q8_TRY(launch_window_attention(MapWindows{H, W, ws, 0}, qkv, bias, has_mask ? mask : nullptr,
                                 att, B * (H / ws) * (W / ws), C, nh, ws * ws, scale, att_groups,
                                 stream));
  Q8_TRY((q8_rowpass<false, GS_FOLD>(as, M, C, nullptr, nullptr, am + S, strips, nullptr,
                                     nullptr, st)));
  Q8_TRY((q8_rowpass<false, GS_CODES>(as, M, C, nullptr, nullptr, am + S, strips, codes,
                                      nullptr, st)));
  Q8_TRY((launch_gemm_s8<GS_ROWS, GS_FOLD>(s8_args(codes, wp, sp, am + S, strips, M, C, C),
                                           GsBf16{(const bf16*)bp, (bf16*)out}, st)));
  return 0;
}

// K6: r + fc2(tanh-GELU(fc1(y))), r and y (B, H, W, C) bf16, strips of ws
// rows; C % 32 == 0, C <= 512, HID % 32 == 0; scratch codes (M, C) and hid
// (M, HID) int8, f32ws (M, HID) f32, amax 2 B H / ws f32. fc1 (N = 4C) runs
// once, storing its f32 output and folding, and a row pass writes the
// codes, reading the hidden as rows of at most 512: faster than running fc1
// twice at the flagship's stage 2 (PERF.md §6).
extern "C" int sodt_mlp_tail_q8(const void* r, const void* y, const void* w1, const void* s1,
                                const void* b1, const void* w2, const void* s2, const void* b2,
                                void* out, void* codes, void* hid, void* f32ws, void* amax,
                                int B, int H, int W, int C, int HID, int ws, void* stream) {
  using namespace sodt;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = B * H * W, S = B * (H / ws);
  const Strips strips{M, ws * W, W};
  float* am = (float*)amax;
  const Ptr4<RowsOf<bf16>> ys{{(const bf16*)y, C}};
  Q8_TRY((int)cudaMemsetAsync(am, 0, (size_t)2 * S * sizeof(float), st));
  Q8_TRY((q8_rowpass<false, GS_FOLD>(ys, M, C, nullptr, nullptr, am, strips, nullptr, nullptr,
                                     st)));
  Q8_TRY((q8_rowpass<false, GS_CODES>(ys, M, C, nullptr, nullptr, am, strips, codes, nullptr,
                                      st)));
  S8Args f1 = s8_args(codes, w1, s1, am, strips, M, HID, C);
  f1.amax_out = am + S;
  f1.f32 = (float*)f32ws;
  Q8_TRY((launch_gemm_s8<GS_ROWS, GS_F32>(f1, GsGelu{(const bf16*)b1}, st)));
  int cw = 512;  // the row pass's width: the widest divisor of HID it takes
  while (HID % cw) cw -= 4;
  const int per = HID / cw;
  Q8_TRY((q8_rowpass<false, GS_CODES>(Ptr4<RowsOf<float>>{{f1.f32, cw}}, M * per, cw, nullptr,
                                      nullptr, am + S, Strips{M * per, ws * W * per, 1}, hid,
                                      nullptr, st)));
  Q8_TRY((launch_gemm_s8<GS_ROWS, GS_FOLD>(
      s8_args(hid, w2, s2, am + S, strips, M, C, HID),
      GsOut{nullptr, (const bf16*)r, nullptr, H, W, 0, (const bf16*)b2, (bf16*)out, 0}, st)));
  return 0;
}

// K4 (has_ln: in1 = x, in2 = a in shifted coordinates) and K7 (in1 = r,
// in2 = y), (B, H, W, C) bf16, C % 32 == 0, C <= 512: fc1 over the map rows
// and one halo row a strip of ws rows, the 2x2 conv, fc2 and the residual.
// wc (C, 2, 2, C) int8 is the conv's (N = C, K = 4C) matrix. Scratch i8ws:
// 3 (M + B H / ws W) C int8 (t, f1, y codes); f32ws (M, C) f32 (the conv's
// output); amax 3 B H / ws f32.
extern "C" int sodt_conv_tail_q8(const void* in1, const void* in2, const void* lng,
                                 const void* lnb, const void* w1, const void* s1, const void* b1,
                                 const void* wc, const void* sc, const void* bc, const void* w2,
                                 const void* s2, const void* b2, void* out, void* i8ws,
                                 void* f32ws, void* amax, int has_ln, int B, int H, int W, int C, int ws,
                                 int shift, void* stream) {
  using namespace sodt;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = B * H * W, nr = H / ws, S = B * nr, rows = M + S * W;
  const Strips strips{M, ws * W, W};
  signed char* t = (signed char*)i8ws;
  signed char* f1 = t + (size_t)rows * C;
  signed char* y = f1 + (size_t)rows * C;
  float* am = (float*)amax;
  Q8_TRY((int)cudaMemsetAsync(am, 0, (size_t)3 * S * sizeof(float), st));
  if (has_ln) {
    const ConvTailIn src{(const bf16*)in1, (const bf16*)in2, M, H, W, C, ws, shift};
    Q8_TRY((q8_rowpass<true, GS_FOLD>(src, rows, C, lng, lnb, am, strips, nullptr, nullptr,
                                      st)));
    Q8_TRY((q8_rowpass<true, GS_CODES>(src, rows, C, lng, lnb, am, strips, t, nullptr, st)));
  } else {
    const Ptr4<MapWithHalo> src{{(const bf16*)in2, M, H, W, C, ws}};
    Q8_TRY((q8_rowpass<false, GS_FOLD>(src, rows, C, nullptr, nullptr, am, strips, nullptr,
                                       nullptr, st)));
    Q8_TRY((q8_rowpass<false, GS_CODES>(src, rows, C, nullptr, nullptr, am, strips, t, nullptr,
                                        st)));
  }
  S8Args a1 = s8_args(t, w1, s1, am, strips, rows, C, C);
  a1.amax_out = am + S;
  a1.codes = f1;
  const GsBiasHalo e1{(const bf16*)b1, M, W, nr};
  Q8_TRY((launch_gemm_s8<GS_ROWS, GS_FOLD>(a1, e1, st)));
  Q8_TRY((launch_gemm_s8<GS_ROWS, GS_CODES>(a1, e1, st)));
  S8Args ac = s8_args(f1, wc, sc, am + S, strips, M, C, 4 * C);
  ac.H = H, ac.Wd = W, ac.ws = ws;
  ac.amax_out = am + 2 * S;
  ac.f32 = (float*)f32ws;
  // the dearest producer (K = 4C) runs once: its f32 output and the fold,
  // then a row pass writes the codes (faster than a second conv: PERF.md)
  Q8_TRY((launch_gemm_s8<GS_CONV2X2, GS_F32>(ac, GsGelu{(const bf16*)bc}, st)));
  Q8_TRY((q8_rowpass<false, GS_CODES>(Ptr4<RowsOf<float>>{{ac.f32, C}}, M, C, nullptr, nullptr,
                                      am + 2 * S, strips, y, nullptr, st)));
  Q8_TRY((launch_gemm_s8<GS_ROWS, GS_FOLD>(
      s8_args(y, w2, s2, am + 2 * S, strips, M, C, C),
      GsOut{nullptr, (const bf16*)in1, has_ln ? (const bf16*)in2 : nullptr, H, W, shift,
            (const bf16*)b2, (bf16*)out, 0},
      st)));
  return 0;
}

// ------------------------------------------------------------------ tests
// The pieces above one launch at a time, for the tests on the card.
//
// sodt_gemm_s8: one launch of the core with the chains' producer
// tanh-GELU(v + b) (b bf16) in mode 0 (fold), 1 (codes under the finished scale) or
// 2 (f32 values and the fold), or (mode 3) qkv's bf16(v + b). conv 0: A is
// an (M, K) code matrix in strips of R rows; conv 1: A is f1's codes of a
// (M / (H Wd), H, Wd) map with one halo row a strip of ws rows after its M
// rows, K = 4C. amax_in / amax_out: one slot a strip.
extern "C" int sodt_gemm_s8(const void* A, const void* W, const void* sw, const void* bias,
                            const void* amax_in, void* amax_out, void* out, int M, int N, int K,
                            int R, int H, int Wd, int ws, int conv, int mode, void* stream) {
  using namespace sodt;
  const cudaStream_t st = (cudaStream_t)stream;
  const Strips strips = conv ? Strips{M, ws * Wd, Wd} : Strips{M, R, 1};
  S8Args a = s8_args(A, W, sw, (const float*)amax_in, strips, M, N, K);
  a.H = H, a.Wd = Wd, a.ws = ws;
  a.amax_out = (float*)amax_out;
  a.codes = (signed char*)out;
  a.f32 = (float*)out;
  const GsGelu gelu{(const bf16*)bias};
  switch (conv * 4 + mode) {
    case 0:
      return launch_gemm_s8<GS_ROWS, GS_FOLD>(a, gelu, st);
    case 1:
      return launch_gemm_s8<GS_ROWS, GS_CODES>(a, gelu, st);
    case 2:
      return launch_gemm_s8<GS_ROWS, GS_F32>(a, gelu, st);
    case 3:
      return launch_gemm_s8<GS_ROWS, GS_FOLD>(a, GsBf16{(const bf16*)bias, (bf16*)out}, st);
    case 4:
      return launch_gemm_s8<GS_CONV2X2, GS_FOLD>(a, gelu, st);
    case 5:
      return launch_gemm_s8<GS_CONV2X2, GS_CODES>(a, gelu, st);
    case 6:
      return launch_gemm_s8<GS_CONV2X2, GS_F32>(a, gelu, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// sodt_q8_rowpass: one row pass over (rows, C) x, bf16 (f32in 0) or f32
// (f32in 1), or (H > 0) over a bf16 (rows / (H W), H, W, C) map read at its
// (-shift, -shift)-rolled position, in strips of R rows: x (ln 0), LN(x) * g
// + b (ln 1) or that rounded to bf16 (ln 2), in mode 0 (fold), 1 (codes) or 2
// (f32 values and the fold)
template <class Src>
static int rowpass_of(const Src& src, const void* g, const void* b, float* am, void* out,
                      int rows, int C, int R, int ln, int mode, cudaStream_t st) {
  using namespace sodt;
  const Strips strips{rows, R, 1};
  float* f = (float*)out;
  switch (ln * 4 + mode) {
    case 0:
      return q8_rowpass<false, GS_FOLD>(src, rows, C, g, b, am, strips, out, f, st);
    case 1:
      return q8_rowpass<false, GS_CODES>(src, rows, C, g, b, am, strips, out, f, st);
    case 2:
      return q8_rowpass<false, GS_F32>(src, rows, C, g, b, am, strips, out, f, st);
    case 4:
      return q8_rowpass<true, GS_FOLD>(src, rows, C, g, b, am, strips, out, f, st);
    case 5:
      return q8_rowpass<true, GS_CODES>(src, rows, C, g, b, am, strips, out, f, st);
    case 6:
      return q8_rowpass<true, GS_F32>(src, rows, C, g, b, am, strips, out, f, st);
    case 8:
      return q8_rowpass<true, GS_FOLD, true>(src, rows, C, g, b, am, strips, out, f, st);
    case 9:
      return q8_rowpass<true, GS_CODES, true>(src, rows, C, g, b, am, strips, out, f, st);
    case 10:
      return q8_rowpass<true, GS_F32, true>(src, rows, C, g, b, am, strips, out, f, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int sodt_q8_rowpass(const void* x, const void* g, const void* b, void* amax,
                               void* out, int rows, int C, int R, int ln, int mode, int f32in,
                               int H, int W, int shift, void* stream) {
  using namespace sodt;
  const cudaStream_t st = (cudaStream_t)stream;
  float* am = (float*)amax;
  if (H > 0)
    return rowpass_of(Ptr4<ShiftedMap>{{(const bf16*)x, H, W, C, shift}}, g, b, am, out, rows,
                      C, R, ln, mode, st);
  if (f32in)
    return rowpass_of(Ptr4<RowsOf<float>>{{(const float*)x, C}}, g, b, am, out, rows, C, R, ln,
                      mode, st);
  return rowpass_of(Ptr4<RowsOf<bf16>>{{(const bf16*)x, C}}, g, b, am, out, rows, C, R, ln,
                    mode, st);
}
