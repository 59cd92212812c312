// K5: qkv GEMM + (shifted) W-MSA + proj GEMM for the Swin blocks.
// Replaces sodt_tpu/pallas/window_attention.py fused_block_attention
// (_block_attn_kernel without the LN). Two kernels:
//
//  * gemm_bias_kernel: out = A . B^T + bias in one bf16 rounding, f32
//    accumulation on the tensor cores; 64x64 tiles, K steps of 32 staged
//    in shared memory. Launched for the qkv and the output projection.
//  * the windowed attention forward (launch_window_attention of
//    window_attention_fwd.cuh: its register body at N <= 64, the strip body
//    of window_attention.cuh above) on the unpartitioned map. Token t of
//    window (wr, wc) in shifted coordinates (r, c) reads its q/k/v at
//    ((r + shift) mod H, (c + shift) mod W); the head's output is written
//    at (r, c), i.e. in shifted coordinates, as the Pallas kernel does.
//    With shift 0 this is also K1, the windowed attention core
//    (`fused_window_attention_nhwc`, body `_strip_kernel`).
#include "window_attention_fwd.cuh"

namespace sodt {

constexpr int GB_M = 64, GB_N = 64, GB_K = 32;
constexpr int GB_LD = GB_K + 8, GB_CLD = GB_N + 4;

__global__ void __launch_bounds__(128)
gemm_bias_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int N,
                 int K, int lda, int ldo) {
  __shared__ __align__(128) bf16 As[GB_M * GB_LD];
  __shared__ __align__(128) bf16 Bs[GB_N * GB_LD];
  __shared__ __align__(128) float Cs[GB_M * GB_CLD];
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  FragC acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += GB_K) {
    for (int v = threadIdx.x; v < GB_M * (GB_K / 8); v += blockDim.x) {
      const int r = v / (GB_K / 8), cv = (v % (GB_K / 8)) * 8;
      const int gk = k0 + cv;
      uint4 a = make_uint4(0u, 0u, 0u, 0u), b = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && gk < K)
        a = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * lda + gk);
      if (n0 + r < N && gk < K)
        b = *reinterpret_cast<const uint4*>(B + (size_t)(n0 + r) * K + gk);
      *reinterpret_cast<uint4*>(&As[r * GB_LD + cv]) = a;
      *reinterpret_cast<uint4*>(&Bs[r * GB_LD + cv]) = b;
    }
    __syncthreads();
    for (int kk = 0; kk < GB_K; kk += 16) {
      FragA a[2];
      FragBT b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm + i * 16) * GB_LD + kk], GB_LD);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[(wn + j * 16) * GB_LD + kk], GB_LD);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm + i * 16) * GB_CLD + wn + j * 16], acc[i][j],
                              GB_CLD, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < GB_M * GB_N; e += blockDim.x) {
    const int r = e / GB_N, c = e % GB_N;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N)
      out[(size_t)gr * ldo + gc] =
          __float2bfloat16(Cs[r * GB_CLD + c] + __bfloat162float(bias[gc]));
  }
}

}  // namespace sodt

extern "C" int sodt_gemm_bias(const void* A, const void* B, const void* bias, void* out,
                              int M, int N, int K, int lda, int ldo, void* stream) {
  dim3 grid((N + sodt::GB_N - 1) / sodt::GB_N, (M + sodt::GB_M - 1) / sodt::GB_M);
  sodt::gemm_bias_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const sodt::bf16*)A, (const sodt::bf16*)B, (const sodt::bf16*)bias,
      (sodt::bf16*)out, M, N, K, lda, ldo);
  return (int)cudaGetLastError();
}

// groups: windows' groups per head of the register body (N <= 64), at most
// the number of its stages (B * nW windows, four to a stage at N <= 16)
extern "C" int sodt_window_attention(const void* qkv, const void* bias, const void* mask,
                                     void* out, int B, int H, int W, int C, int nh, int ws,
                                     int shift, int has_mask, float scale, int groups,
                                     void* stream) {
  return sodt::launch_window_attention(sodt::MapWindows{H, W, ws, shift}, qkv, bias,
                                       has_mask ? mask : nullptr, out,
                                       B * (H / ws) * (W / ws), C, nh, ws * ws, scale, groups,
                                       stream);
}
