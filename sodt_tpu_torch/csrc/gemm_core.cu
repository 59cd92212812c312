// K6 and K7 on the GEMM core of gemm_core.cuh (the design and the TPU
// kernels they replace are noted there). One entry launches one GEMM; the
// Python wrappers (kernels/swin_block.py) chain them:
//   K6 `fused_mlp_tail`:           H = fc1(y) + GELU (GC_GELU), then
//                                  out = fc2(H) + r (GC_RESIDUAL);
//   K7 `fused_conv_mlp_tail_noln`: f1 = fc1(y) (GC_BIAS), then
//                                  z = conv2x2(pad_br(f1)) + GELU
//                                  (GC_CONV2X2 with GC_GELU), then
//                                  out = fc2(z) + r (GC_RESIDUAL).
#include "gemm_core.cuh"

// mode: 0 rows + GELU, 1 rows + bias, 2 rows + bias + residual, 3 the 2x2
// conv's gather (K = 4C over a (B, H, Wd, C) map, M = B * H * Wd) + GELU
extern "C" int sodt_gemm_core(const void* A, const void* W, const void* bias, const void* R,
                              void* out, int M, int N, int K, int H, int Wd, int mode,
                              void* stream) {
  using namespace sodt;
  if (M <= 0 || N <= 0 || N % 8 != 0 || K % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const GemmArgs a{(const bf16*)A, (const bf16*)W, (const bf16*)bias, (const bf16*)R,
                   (bf16*)out, M, N, K, H, Wd};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return launch_gemm_core<GC_ROWS, GC_GELU>(a, s);
    case 1:
      return launch_gemm_core<GC_ROWS, GC_BIAS>(a, s);
    case 2:
      return launch_gemm_core<GC_ROWS, GC_RESIDUAL>(a, s);
    case 3:
      if (K % 32 != 0 || H <= 0 || Wd <= 0 || M % (H * Wd) != 0)
        return (int)cudaErrorInvalidValue;
      return launch_gemm_core<GC_CONV2X2, GC_GELU>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
