// K9: backward of the windowed attention core (K1) on an unpartitioned
// (B, H, W, 3C) map. Replaces sodt_tpu/pallas/window_attention.py
// _bwd_strip_kernel (_pallas_attention_nhwc_bwd, _unpack_dbias). Two bodies,
// chosen by the window's token count N (the Python wrapper picks the entry):
//   N <= 64  window_attn_bwd_regs_kernel<., ., WrMap> of
//            window_attention_bwd.cuh: the scores in registers, five
//            products, the dbias partial held in registers across a CTA's
//            windows (the flagship's windows of 64; K11's backward runs
//            the same body on its token windows);
//   N > 64   window_attn_bwd_kernel<MapWindows> of window_attention.cuh, the
//            score strips in shared memory.
// Both hold the formulas and sum dbias in two deterministic passes.
#include "window_attention_bwd.cuh"

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

// N = ws * ws <= 64, head dim 16, 32, 48 or 64; part: (groups, nh, N, N) f32
// scratch with groups <= the number of stages (B * nW windows, four to a
// stage at N <= 16); dbias: (nh, N, N) f32.
extern "C" int sodt_window_attention_bwd_regs(const void* qkv, const void* gy,
                                              const void* bias, const void* mask, void* dqkv,
                                              void* part, void* dbias, int B, int H, int W,
                                              int C, int nh, int ws, int has_mask, float scale,
                                              int groups, void* stream) {
  const sodt::WrMap m{H, W, ws, W / ws, (H / ws) * (W / ws)};
  return sodt::window_attention_bwd_regs(m, qkv, gy, bias, has_mask ? mask : nullptr, dqkv,
                                         part, dbias, B * (H / ws) * (W / ws), C, nh, ws * ws,
                                         scale, groups, stream);
}
