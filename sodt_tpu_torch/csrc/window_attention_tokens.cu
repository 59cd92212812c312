// K11: the windowed attention core and its backward on PRE-PARTITIONED
// windows, qkv (Wn, N, 3C) -> out (Wn, N, C). Replaces
// sodt_tpu/pallas/window_attention.py fused_window_attention (body _kernel)
// and _pallas_attention_bwd (body _bwd_kernel):
//
//   out[w] = softmax(q[w] * scale @ k[w]^T + bias[h] + mask[w mod nw]) @ v[w]
//
// per head h, and its backward dqkv, dbias[h] = sum over windows of dS.
// Both are the map kernels' bodies (K1, K9) with a token addressing, which
// reads a window's N tokens as N contiguous rows with 16-byte copies
// straight from the (Wn, N, 3C) layout the qkv projection leaves, so no
// copy into map layout stands on the path. At N <= 64 (every window of the
// repo's configurations): the forward is the register body of
// window_attention_fwd.cuh (FwdTokens), the backward K9's register body of
// window_attention_bwd.cuh (WrTokens) - one CTA per (head, group of
// windows) with the scores in registers, formulas and design there. Above,
// both take the strip bodies of window_attention.cuh (TokenWindows). The
// TPU kernel's window groups (_pick_group, sized to its VMEM) and its
// dbias accumulation across a sequential grid are not carried over:
// backward, a dbias partial per group of windows and a second pass in
// group order (no f32 atomics).
//
// Bound on the H100 by bytes (7 * C * 2 per token forward + backward against
// 4 * N * C and 10 * N * C operations, N <= 256).
#include "window_attention_bwd.cuh"
#include "window_attention_fwd.cuh"

extern "C" int sodt_window_attention_tokens(const void* qkv, const void* bias,
                                            const void* mask, void* out, int Wn, int N,
                                            int C, int nh, int nw, float scale, int groups,
                                            void* stream) {
  return sodt::launch_window_attention(sodt::TokenWindows{N, nw}, qkv, bias, mask, out, Wn, C,
                                       nh, N, scale, groups, stream);
}

// part: (groups, nh, N, N) f32 scratch, groups <= the number of stages (Wn
// windows; at N <= 16 four to a stage); dbias: (nh, N, N) f32.
extern "C" int sodt_window_attention_tokens_bwd(const void* qkv, const void* gy,
                                                const void* bias, const void* mask,
                                                void* dqkv, void* part, void* dbias, int Wn,
                                                int N, int C, int nh, int nw, float scale,
                                                int groups, void* stream) {
  if (N <= 64)
    return sodt::window_attention_bwd_regs(sodt::WrTokens{N, nw}, qkv, gy, bias, mask, dqkv,
                                           part, dbias, Wn, C, nh, N, scale, groups, stream);
  return sodt::launch_window_attention_bwd(sodt::TokenWindows{N, nw}, qkv, gy, bias, mask,
                                           dqkv, part, dbias, Wn, C, nh, N, scale, groups,
                                           stream);
}
