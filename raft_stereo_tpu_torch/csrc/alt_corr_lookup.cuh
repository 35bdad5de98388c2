// Device code of the alt-correlation lookup in the first launch of the
// fused refinement step (fused_update.cu's motion_in_kernel). The K1
// lookup kernel (alt_corr.cu) has its own design and does not include it.
//
// One warp serves one pixel p of f1 [B,H,W1,D]. The warp keeps p's f1 row
// in registers (D/32 floats a lane, float4 loads). For level l of the
// width-pooled pyramid f2_l [B,H,W2_l,D] and x = coords[p] / 2^l, the 2r+1
// window taps at integer offsets share the 2r+2 f2 rows from floor(x) - r
// on, so ``level_dots`` forms those 2r+2 dot products (warp butterfly
// reductions, every lane ends with every sum); rows outside [0, W2_l) give
// 0 and are not loaded. Tap k is then
//
//   ((1 - frac) * c[k] + frac * c[k+1]) / sqrt(D),   frac = x - floor(x).

#pragma once

#include <cuda_runtime.h>

namespace rst {

constexpr int kMaxLevels = 8;

struct Pyramid {
  const float* f2[kMaxLevels];
  int w2[kMaxLevels];
};

// The f1 row of one pixel: lane holds float4 chunks lane + 32 v, v < NV
// (D <= 128 * NV); chunks past D/4 are zero.
template <int NV>
__device__ __forceinline__ void load_f1_row(const float* __restrict__ f1p, int D4, int lane,
                                            float4 (&a)[NV]) {
  const float4* q = reinterpret_cast<const float4*>(f1p);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = lane + 32 * v;
    a[v] = c < D4 ? __ldg(q + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The 2R+2 window dot products of one level, summed over the warp (all
// lanes return them), and the window's fractional position. ``f2row``
// points at the level's first feature row of the pixel's image row.
template <int NV, int R>
__device__ __forceinline__ void level_dots(const float4 (&a)[NV], const float* __restrict__ f2row,
                                           int W2, int D, int D4, float xl, int lane,
                                           float (&c)[2 * R + 2], float& frac) {
  constexpr int NP = 2 * R + 2;
  const float x0 = floorf(xl);
  frac = xl - x0;
  // Clamp before the int conversion: a window wholly outside stays wholly
  // outside.
  const float first = fminf(fmaxf(x0 - (float)R, -(float)(NP + 1)), (float)W2 + 1.0f);
  const int base = (int)first;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int pos = base + j;
    float s = 0.f;
    if (pos >= 0 && pos < W2) {  // uniform across the warp
      const float4* q = reinterpret_cast<const float4*>(f2row + (long long)pos * D);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int cc = lane + 32 * v;
        if (cc < D4) {
          const float4 b = __ldg(q + cc);
          s = fmaf(a[v].x, b.x, s);
          s = fmaf(a[v].y, b.y, s);
          s = fmaf(a[v].z, b.z, s);
          s = fmaf(a[v].w, b.w, s);
        }
      }
    }
    c[j] = s;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < NP; ++j) c[j] += __shfl_xor_sync(0xffffffffu, c[j], off);
  }
}

// Tap k of a level from its window dot products.
__device__ __forceinline__ float window_tap(float ck, float ck1, float frac, float inv_sqrt_d) {
  return ((1.f - frac) * ck + frac * ck1) * inv_sqrt_d;
}

}  // namespace rst
