// int8 serving pieces (K12): the quantizers' arithmetic, the strips and
// the row sources every int8 body shares (int8_chains.cu, on the s8 wgmma
// core and the row passes of gemm_s8_core.cuh).
//
// The arithmetic is the Pallas kernels' (sodt_tpu/pallas/swin_block.py
// _q8_weight, _q8_dot, _q8_weight_conv): weights carry one f32 scale per
// output channel; an activation carries ONE scale per strip (a Pallas grid
// program: image b, ws map rows, plus the conv's halo row), sx =
// max(max|x|, 1e-8) / 127, codes clip(rint(x / sx), -127, 127) with a true
// division (no fast math) and round half to even; the int32 sum is exact
// and dequantizes as float(acc) * (s_w * sx).
//
// A strip is shared by many CTAs (a GEMM tile is 128 rows; a strip of the
// flagship's stage 1 is 1,024 tokens), and its scale must be known before
// any of them quantizes. So a body runs as launches split at its
// quantization points: the producer of an activation (a row pass, or a
// GEMM's epilogue) folds max|x| into a per-strip f32 slot with atomicMax on
// the bit pattern (exact and order-independent for non-negative floats:
// deterministic), and the launches after it read the finished scale. The
// slots are zeroed by the launcher (cudaMemsetAsync). A thread-block
// cluster (16 CTAs at most) or a cooperative grid sync (the whole grid
// resident) would not hold a strip.
#pragma once

#include "common.cuh"

namespace sodt {

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
// What a row pass reads (gemm_s8_core.cuh Ptr4): a pointer to element k of
// row m, 4 elements read from there.

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

}  // namespace sodt

#define Q8_TRY(call)          \
  do {                        \
    const int err_ = (call);  \
    if (err_) return err_;    \
  } while (0)
