// K6: r + fc2(tanh-GELU(fc1(y))) for the linear-MLP Swin blocks.
// Replaces sodt_tpu/pallas/swin_block.py fused_mlp_tail (_mlp_tail_kernel).
// The fused kernel lives in common.cuh (mlp2_kernel with one tap):
// y rows (B*H*W, C), W1 = fc1 weight (hidden, C), W2 = fc2 weight (C, hidden).
#include "common.cuh"

extern "C" int sodt_mlp_tail(const void* y, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* r, void* out,
                             int B, int H, int W, int C, int hidden, int N, void* stream) {
  return sodt::launch_mlp2<1>(y, w1, b1, w2, b2, r, out, B, H, W, C, hidden, N, stream);
}
