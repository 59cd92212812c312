// K9: backward of the windowed attention core (K1) on an unpartitioned
// (B, H, W, 3C) map. Replaces sodt_tpu/pallas/window_attention.py
// _bwd_strip_kernel (_pallas_attention_nhwc_bwd, _unpack_dbias): the kernel
// window_attn_bwd_kernel<MapWindows> of window_attention.cuh, which holds
// the formulas, the design and the deterministic two-pass dbias.
#include "window_attention.cuh"

// part: (groups, nh, N, N) f32 scratch, groups <= B * nW; dbias: (nh, N, N) f32.
extern "C" int sodt_window_attention_bwd(const void* qkv, const void* gy, const void* bias,
                                         const void* mask, void* dqkv, void* part,
                                         void* dbias, int B, int H, int W, int C, int nh,
                                         int ws, int has_mask, float scale, int groups,
                                         void* stream) {
  return sodt::launch_window_attention_bwd(
      sodt::MapWindows{H, W, ws, 0}, qkv, gy, bias, has_mask ? mask : nullptr, dqkv, part,
      dbias, B * (H / ws) * (W / ws), C, nh, ws * ws, scale, groups, stream);
}
