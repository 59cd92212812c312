// K11: the windowed attention core and its backward on PRE-PARTITIONED
// windows, qkv (Wn, N, 3C) -> out (Wn, N, C). Replaces
// sodt_tpu/pallas/window_attention.py fused_window_attention (body _kernel)
// and _pallas_attention_bwd (body _bwd_kernel):
//
//   out[w] = softmax(q[w] * scale @ k[w]^T + bias[h] + mask[w mod nw]) @ v[w]
//
// per head h, and its backward dqkv, dbias[h] = sum over windows of dS. The
// forward is launch_window_attention of window_attention_fwd.cuh with the
// token addressing (FwdTokens): at N <= 64 its register body (formulas and
// design there), one CTA per (head, group of windows) with the scores in
// registers; above, the strip body of window_attention.cuh. The backward is
// window_attn_bwd_kernel<TokenWindows> of window_attention.cuh. A window's
// N tokens are N contiguous rows, read with 16-byte copies straight from
// the (Wn, N, 3C) layout the qkv projection leaves, so no copy into map
// layout stands on the path. The TPU kernel's window groups (_pick_group,
// sized to its VMEM) and its dbias accumulation across a sequential grid
// are not carried over: backward, one CTA per (head, group of windows)
// with a dbias partial per group and a second pass in group order (no f32
// atomics).
//
// Bound on the H100 by bytes (7 * C * 2 per token forward + backward against
// 4 * N * C and 10 * N * C operations, N <= 256); the backward in practice
// by the shared-memory round trips of its f32 scores.
#include "window_attention_fwd.cuh"

extern "C" int sodt_window_attention_tokens(const void* qkv, const void* bias,
                                            const void* mask, void* out, int Wn, int N,
                                            int C, int nh, int nw, float scale, int groups,
                                            void* stream) {
  return sodt::launch_window_attention(sodt::TokenWindows{N, nw}, qkv, bias, mask, out, Wn, C,
                                       nh, N, scale, groups, stream);
}

// part: (groups, nh, N, N) f32 scratch, groups <= Wn; dbias: (nh, N, N) f32.
extern "C" int sodt_window_attention_tokens_bwd(const void* qkv, const void* gy,
                                                const void* bias, const void* mask,
                                                void* dqkv, void* part, void* dbias, int Wn,
                                                int N, int C, int nh, int nw, float scale,
                                                int groups, void* stream) {
  return sodt::launch_window_attention_bwd(sodt::TokenWindows{N, nw}, qkv, gy, bias, mask,
                                           dqkv, part, dbias, Wn, C, nh, N, scale, groups,
                                           stream);
}
