// K7: r + fc2(tanh-GELU(conv2x2(pad_br(fc1(y))))) for the shifted Swin blocks.
// Replaces sodt_tpu/pallas/swin_block.py fused_conv_mlp_tail_noln
// (_conv_tail_noln_kernel + _conv_gelu_fc2). fc1 runs first as the GEMM
// kernel (sodt_gemm_bias) and writes f1 in bf16; this entry runs the 2x2
// conv as four shifted-tap GEMMs over f1 (taps (C, 2, 2, C) = the OIHW conv
// weight as (out, kh, kw, in)), then GELU, fc2 and the residual, in the fused
// kernel of common.cuh. Taps that fall off the bottom row or the right
// column read zeros: the zero pad goes on fc1's output.
#include "common.cuh"

extern "C" int sodt_conv_mlp_tail(const void* f1, const void* taps, const void* bc,
                                  const void* w2, const void* b2, const void* r, void* out,
                                  int B, int H, int W, int C, int hidden, int N,
                                  void* stream) {
  return sodt::launch_mlp2<4>(f1, taps, bc, w2, b2, r, out, B, H, W, C, hidden, N, stream);
}
