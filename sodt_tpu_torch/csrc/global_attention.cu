// K8: single-window ("global") attention with a full additive bias.
// Replaces sodt_tpu/pallas/window_attention.py fused_global_attention
// (_global_kernel). The map may hold several ws x ws windows (N = ws*ws
// tokens each, with an optional (nW, N, N) f32 mask): the same kernel then
// serves the large-window case (ws*ws > 256) that JAX leaves to its XLA
// composition.
//
// What bounds it on the H100: bytes. At the flagship's stage 3 (N = 1024,
// 12 heads, head dim 64, batch 4) the f32 bias is 50 MB against 19 MB of
// qkv and output, and the 13 GFLOP of QK^T and PV take 13 us at the bf16
// peak against 22.5 us for the bytes.
//
// Design (the body is global_attn_fwd_kernel in global_attention.cuh):
//  * one CTA of 4 warps per (64 query rows, window, head); each warp's
//    16 x 64 score tile lands in registers (mma.sync m16n8k16, K read by
//    ldmatrix from shared memory), the online softmax runs on those
//    registers (row max and sum by quad shuffles), P is re-packed in place
//    as the A operand of PV, and the output accumulator stays in registers
//    for the whole key loop: no score or accumulator round trip through
//    shared memory, two __syncthreads per key block;
//  * K, V (straight from the fused (B, H, W, 3C) layout, no head-split
//    transpose) and the 64 x 64 f32 bias (+ mask) tile come through a
//    two-stage cp.async ring, so the next block's copies overlap this
//    block's products;
//  * the grid is rastered (head, query block, window) with the window and
//    batch fastest: the B * nW CTAs that read one bias tile run side by
//    side and the bias comes from HBM about once (the Pallas grid orders
//    (head, batch) with batch innermost for the same reuse).
// With `lse` and `o_full` non-null it also writes, for K10, each row's
// natural log-sum-exp ((B * nW, nh, N) f32) and the output in f32 with P's
// bf16 rounding residue added back (global_attention.cuh), which K10 takes
// where its S equals this one (scale a power of two); the bf16 output does
// not depend on them.
#include "global_attention.cuh"

extern "C" int sodt_global_attention(const void* qkv, const void* bias, const void* mask,
                                     void* out, void* lse, void* o_full, int B, int H, int W,
                                     int C, int nh, int ws, int has_mask, float scale,
                                     void* stream) {
  if ((ws * ws) % sodt::GA_Q != 0 || C % nh != 0 || (C / nh) % 16 != 0) return (int)cudaErrorInvalidValue;
  if (!has_mask) mask = nullptr;
  if (lse != nullptr && o_full != nullptr)
    return sodt::launch_global_fwd<sodt::GA_FORWARD_STATS>(
        qkv, bias, mask, out, (float*)lse, (float*)o_full, nullptr, nullptr, B, H, W, C, nh,
        ws, scale, (cudaStream_t)stream);
  return sodt::launch_global_fwd<sodt::GA_FORWARD>(qkv, bias, mask, out, nullptr, nullptr,
                                                   nullptr, nullptr, B, H, W, C, nh, ws, scale,
                                                   (cudaStream_t)stream);
}
