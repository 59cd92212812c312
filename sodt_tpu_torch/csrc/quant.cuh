// int8 serving pieces (K12): the quantizers' arithmetic, the strips and
// row sources every int8 body shares, and the WMMA s8 x s8 -> s32 GEMM with
// on-load activation quantization, the f32 LayerNorm and the per-strip
// abs-max of K3's, K5's and K6's twins (int8_blocks.cu). K2's and K4's /
// K7's twins run on the s8 wgmma core of gemm_s8_core.cuh instead.
//
// The arithmetic is the Pallas kernels' (sodt_tpu/pallas/swin_block.py
// _q8_weight, _q8_dot, _q8_weight_conv): weights carry one f32 scale per
// output channel; an activation carries ONE scale per strip (a Pallas grid
// program: image b, ws map rows, plus the conv's halo row), sx =
// max(max|x|, 1e-8) / 127, codes clip(rint(x / sx), -127, 127) with a true
// division (no fast math) and round half to even; the int32 sum is exact
// and dequantizes as float(acc) * (s_w * sx).
//
// A strip is shared by many CTAs here (a GEMM tile is 64 rows; a strip of
// the flagship's stage 1 is 1,024 tokens), and its scale must be known
// before any of them quantizes. So a body runs as launches split at its
// quantization points: the producer of an activation (an LN pass, an
// abs-max pass, or the previous GEMM's epilogue) writes it and folds
// max|x| into a per-strip f32 slot with atomicMax on the bit pattern (exact
// and order-independent for non-negative floats: deterministic), and the
// consumer GEMM reads the finished scale. The slots are zeroed by the
// launcher (cudaMemsetAsync). A thread-block cluster (16 CTAs at most) or a
// cooperative grid sync (the whole grid resident) would not hold a strip.
#pragma once

#include "common.cuh"

namespace sodt {

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> FragA8;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> FragB8;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> FragC32;

// The strip of row m: M0 main rows in strips of R rows, then the halo rows,
// W per strip in strip order (none when the rows end at M0).
struct Strips {
  int M0, R, W;
  __device__ __forceinline__ int operator()(int m) const {
    return m < M0 ? m / R : (m - M0) / W;
  }
};

__device__ __forceinline__ void atomic_max_nonneg(float* addr, float v) {
  atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
}

__device__ __forceinline__ float q8_scale(float amax) { return fmaxf(amax, 1e-8f) / 127.0f; }

__device__ __forceinline__ signed char q8_code(float v, float s) {
  return (signed char)(int)fminf(fmaxf(rintf(v / s), -127.0f), 127.0f);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
  for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(e[i]);
}

// ----------------------------------------------------------- row sources
// A GEMM's A(m, k): a pointer to element k of row m (4 elements are read
// from there), or null for a row of zeros.

template <class T>
struct RowsOf {
  const T* p;
  int ld;
  __device__ __forceinline__ const T* operator()(int m, int k) const {
    return p + (size_t)m * ld + k;
  }
};

// Token m of a (B, H, W, C) map in shifted coordinates, read at
// ((i + shift) mod H, (j + shift) mod W): the (-shift, -shift) roll as
// index arithmetic.
struct ShiftedMap {
  const bf16* x;
  int H, W, C, shift;
  __device__ __forceinline__ const bf16* operator()(int m, int k) const {
    const int j = m % W, i = (m / W) % H, b = m / (W * H);
    return x + ((size_t)(b * H + (i + shift) % H) * W + (j + shift) % W) * C + k;
  }
};

// The M0 rows of a (B, H, W, C) map, then one halo row per strip of ws
// rows: the first row of the next strip, clamped to the last strip (the
// Pallas `nxt` BlockSpec, index min(r + 1, nr - 1)).
struct MapWithHalo {
  const bf16* y;
  int M0, H, W, C, ws;
  __device__ __forceinline__ const bf16* operator()(int m, int k) const {
    // both rows computed, one taken: no branch between a row pass's loads
    const int h = max(m - M0, 0), j = h % W, s = h / W, nr = H / ws;
    const size_t halo = (size_t)((s / nr) * H + min(s % nr + 1, nr - 1) * ws) * W + j;
    return y + (m < M0 ? (size_t)m : halo) * C + k;
  }
};

// A row source read as f32 values.
template <class P>
struct Val {
  P p;
  __device__ __forceinline__ float operator()(int m, int c) const { return to_f(*p(m, c)); }
};

// K4's LN input, 4 channels from c on: res1 = x + a read at its shifted
// position (the un-shift); the halo row of strip r is x's row min(r + 1,
// nr - 1) * ws plus a's unshifted row u = (r + 1) * ws mod H when shift > 0
// (the Pallas kernel takes it from the current strip's shifted rows), x's
// row otherwise. A row source of gemm_s8_core.cuh's row passes.
struct ConvTailIn {
  const bf16 *x, *a;
  int M0, H, W, C, ws, shift;
  __device__ __forceinline__ void load(int m, int c, float v[4]) const {
    // the map row and the halo row both computed, one taken (no branch)
    const int jm = m % W, im = (m / W) % H, bm = m / (W * H);
    const int h = max(m - M0, 0), s = h / W, nr = H / ws, r = s % nr;
    const int ih = min(r + 1, nr - 1) * ws, iah = shift ? ((r + 1) * ws) % H : ih;
    const bool main = m < M0;
    const int b = main ? bm : s / nr, i = main ? im : ih, j = main ? jm : h % W;
    const int ia = main ? im : iah;
    const size_t xr = (size_t)(b * H + i) * W + j;
    const size_t ar = (size_t)(b * H + (ia - shift + H) % H) * W + (j - shift + W) % W;
    float av[4];
    load4(x + xr * C + c, v);
    load4(a + ar * C + c, av);
    for (int e = 0; e < 4; ++e) v[e] = __fadd_rn(v[e], av[e]);
  }
};

// ------------------------------------------------------------- epilogues
// epi(m, n, v) gets the dequantized product v = float(acc) * (s_w[n] * sx)
// and returns |what it stored| where that feeds the next quantization point
// (else 0).

struct EpiBf16 {  // bf16(v + b): qkv and the K3 / K5 projection
  const float* b;
  bf16* out;
  int ld;
  __device__ __forceinline__ float operator()(int m, int n, float v) const {
    out[(size_t)m * ld + n] = __float2bfloat16(v + b[n]);
    return 0.0f;
  }
};

struct EpiGelu {  // tanh-GELU(v + b) in f32
  const float* b;
  float* out;
  int ld;
  __device__ __forceinline__ float operator()(int m, int n, float v) const {
    const float g = gelu_tanh(v + b[n]);
    out[(size_t)m * ld + n] = g;
    return fabsf(g);
  }
};

struct EpiOut {  // bf16(r + (v + b)): K6's output
  const bf16* r;
  const float* b;
  bf16* out;
  int ld;
  __device__ __forceinline__ float operator()(int m, int n, float v) const {
    const size_t e = (size_t)m * ld + n;
    out[e] = __float2bfloat16(__bfloat162float(r[e]) + (v + b[n]));
    return 0.0f;
  }
};

// ------------------------------------------------------------------ GEMM
// out(m, n) = epi(m, n, float(sum_k q(A(m, k)) * Wq(n, k)) * (sw[n] * sx(m)))
// with q(a) = the int8 code of a under its strip's scale sx(m) =
// q8_scale(amax_in[sin(m)]). A is f32 or bf16 (T), quantized while it is
// staged; Wq (N, K) int8 row-major (a torch Linear weight). 64 x 64 tiles,
// K steps of 32, 4 warps of 2 x 2 WMMA s8 fragments (int32 accumulation on
// the tensor cores). With amax_out, the epilogue's returns fold into the
// strips sout(m) of the next quantization point. Needs K % 32 == 0.
constexpr int QG_M = 64, QG_N = 64, QG_K = 32, QG_CLD = QG_N + 4;

template <class T, class ARows, class Epi>
__global__ void __launch_bounds__(128)
q8_gemm_kernel(ARows arow, const signed char* __restrict__ Wq, const float* __restrict__ sw,
               const float* __restrict__ amax_in, Strips sin, int M, int N, int K, Epi epi,
               float* __restrict__ amax_out, Strips sout) {
  __shared__ __align__(128) signed char As[2][QG_M][16];
  __shared__ __align__(128) signed char Bs[2][QG_N][16];
  __shared__ __align__(128) int Cs[QG_M * QG_CLD];
  __shared__ float sx[QG_M];
  __shared__ float red[4];
  const int m0 = blockIdx.y * QG_M, n0 = blockIdx.x * QG_N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  if (tid < QG_M) sx[tid] = m0 + tid < M ? q8_scale(amax_in[sin(m0 + tid)]) : 1.0f;
  __syncthreads();

  FragC32 acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
  for (int k0 = 0; k0 < K; k0 += QG_K) {
    for (int v = tid; v < QG_M * QG_K / 4; v += blockDim.x) {
      const int r = v / (QG_K / 4), kv = (v % (QG_K / 4)) * 4;
      char4 q = make_char4(0, 0, 0, 0);
      const T* p = m0 + r < M ? arow(m0 + r, k0 + kv) : nullptr;
      if (p) {
        float f[4];
        load4(p, f);
        const float s = sx[r];
        q = make_char4(q8_code(f[0], s), q8_code(f[1], s), q8_code(f[2], s), q8_code(f[3], s));
      }
      *reinterpret_cast<char4*>(&As[kv >> 4][r][kv & 15]) = q;
    }
    {
      const int n = tid >> 1, half = tid & 1;
      uint4 bv = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + n < N)
        bv = *reinterpret_cast<const uint4*>(Wq + (size_t)(n0 + n) * K + k0 + half * 16);
      *reinterpret_cast<uint4*>(&Bs[half][n][0]) = bv;
    }
    __syncthreads();
    for (int kh = 0; kh < 2; ++kh) {
      FragA8 a[2];
      FragB8 b[2];
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[kh][wm + 16 * i][0], 16);
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[kh][wn + 16 * j][0], 16);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm + 16 * i) * QG_CLD + wn + 16 * j], acc[i][j], QG_CLD,
                              wmma::mem_row_major);
  __syncthreads();

  float local = 0.0f;
  const int s0 = sout(m0);
  for (int e = tid; e < QG_M * QG_N; e += blockDim.x) {
    const int r = e / QG_N, c = e % QG_N, m = m0 + r, n = n0 + c;
    if (m < M && n < N) {
      // no contraction into an FMA: the product rounds as JAX's does
      const float v = __fmul_rn((float)Cs[r * QG_CLD + c], __fmul_rn(sw[n], sx[r]));
      const float a = epi(m, n, v);
      if (amax_out) {
        const int s = sout(m);
        if (s == s0)
          local = fmaxf(local, a);
        else
          atomic_max_nonneg(amax_out + s, a);
      }
    }
  }
  if (amax_out) {
    local = warp_max(local);
    if (lane == 0) red[warp] = local;
    __syncthreads();
    if (tid == 0)
      atomic_max_nonneg(amax_out + s0, fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3])));
  }
}

// ------------------------------------------------------ LN and abs-max
// One warp per row. q8_ln_kernel: out = LN(row) * g + b in f32 (statistics
// E[x^2] - mu^2, eps 1e-5: `_ln_rows_vpu`), rounded to bf16 and back when
// round_bf16 (K3 / K5 quantize the bf16 LN output), and max |out| folded
// into the row's strip. q8_amax_kernel: only the abs-max.
template <class Src>
__global__ void __launch_bounds__(256)
q8_ln_kernel(Src src, int rows, int C, const float* __restrict__ g,
             const float* __restrict__ b, int round_bf16, float* __restrict__ out,
             float* __restrict__ amax, Strips strips) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.0f, s2 = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float v = src(row, c);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / C;
  const float rstd = rsqrtf(s2 / C - mu * mu + 1e-5f);
  float mx = 0.0f;
  for (int c = lane; c < C; c += 32) {
    float y = (src(row, c) - mu) * rstd * g[c] + b[c];
    if (round_bf16) y = __bfloat162float(__float2bfloat16(y));
    out[(size_t)row * C + c] = y;
    mx = fmaxf(mx, fabsf(y));
  }
  mx = warp_max(mx);
  if (lane == 0) atomic_max_nonneg(amax + strips(row), mx);
}

template <class Src>
__global__ void __launch_bounds__(256)
q8_amax_kernel(Src src, int rows, int C, float* __restrict__ amax, Strips strips) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= rows) return;
  float mx = 0.0f;
  for (int c = lane; c < C; c += 32) mx = fmaxf(mx, fabsf(src(row, c)));
  mx = warp_max(mx);
  if (lane == 0) atomic_max_nonneg(amax + strips(row), mx);
}

// ------------------------------------------------------------- launchers

template <class T, class ARows, class Epi>
inline int q8_gemm(ARows arow, const void* wq, const void* sw, const float* amax_in, Strips sin,
                   int M, int N, int K, Epi epi, float* amax_out, Strips sout,
                   cudaStream_t stream) {
  const dim3 grid((N + QG_N - 1) / QG_N, (M + QG_M - 1) / QG_M);
  if (K % QG_K || grid.y > 65535) return (int)cudaErrorInvalidValue;
  q8_gemm_kernel<T><<<grid, 128, 0, stream>>>(arow, (const signed char*)wq, (const float*)sw,
                                              amax_in, sin, M, N, K, epi, amax_out, sout);
  return (int)cudaGetLastError();
}

template <class Src>
inline int q8_ln(Src src, int rows, int C, const void* g, const void* b, int round_bf16,
                 float* out, float* amax, Strips strips, cudaStream_t stream) {
  q8_ln_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(src, rows, C, (const float*)g,
                                                   (const float*)b, round_bf16, out, amax,
                                                   strips);
  return (int)cudaGetLastError();
}

template <class Src>
inline int q8_amax(Src src, int rows, int C, float* amax, Strips strips, cudaStream_t stream) {
  q8_amax_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(src, rows, C, amax, strips);
  return (int)cudaGetLastError();
}

}  // namespace sodt

#define Q8_TRY(call)          \
  do {                        \
    const int err_ = (call);  \
    if (err_) return err_;    \
  } while (0)
