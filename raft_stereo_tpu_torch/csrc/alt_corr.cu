// Streaming alt-correlation lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel raft_stereo_tpu/ops/pallas_corr.py::_alt_kernel
// (one launch per pyramid level there). It computes, for every pixel p of
// f1 [B,H,W1,D] and every level l of the width-pooled pyramid f2_l
// [B,H,W2_l,D]:
//
//   out[p, l*K + k] = ((1-frac) * c[k] + frac * c[k+1]) / sqrt(D),
//   c[j] = <f1[p], f2_l[row(p), x0 - r + j]>  (0 outside [0, W2_l)),
//
// with x = coords[p] / 2^l, x0 = floor(x), frac = x - x0, k in [0, 2r].
// That is the recompute-at-offsets lookup of ops/corr.py, level-major.
//
// Design: one warp per output pixel, all levels in one launch. The warp
// keeps the pixel's f1 row in registers (D/32 floats a lane, float4 loads)
// for all levels. The 2r+1 taps at integer offsets share 2r+2 f2 rows, so
// each level touches 2r+2 rows and forms 2r+2 dot products (warp butterfly
// reductions); rows outside [0, W2_l) are not loaded. Whole correlation
// rows are never built: f1 is read once, and neighbouring pixels of a row
// re-read the same f2 rows from L1/L2. The per-warp device code lives in
// alt_corr_lookup.cuh, which the fused refinement step shares.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32) at the 544x960 slice
// shape (H=136, W1=240, D=256, L=4, r=4): bytes f1 33.4 MB + f2 pyramid
// 62.7 MB + coords 0.13 MB + out 4.7 MB = 100.9 MB -> 30 us; operations
// 32,640 px x 4 levels x 10 dots x 512 = 0.67 GFLOP -> 10 us. So the
// lookup is bound by memory traffic.
//
// Interface: plain C, loaded with ctypes. The function launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "alt_corr_lookup.cuh"

namespace {

using rst::kMaxLevels;
using rst::Pyramid;

constexpr int kWarpsPerBlock = 8;

// NV: float4 chunks of the f1 row held by each lane (D <= 128 * NV).
// R: window radius.
template <int NV, int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
alt_corr_kernel(const float* __restrict__ f1, Pyramid pyr, int levels,
                const float* __restrict__ coords, float* __restrict__ out,
                long long n_pix, int W1, int D, float inv_sqrt_d) {
  constexpr int K = 2 * R + 1;
  const int lane = threadIdx.x & 31;
  const long long p =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= n_pix) return;  // whole warp leaves together
  const int D4 = D >> 2;
  const long long row = p / W1;  // b*H + h

  float4 a[NV];
  rst::load_f1_row<NV>(f1 + p * D, D4, lane, a);
  const float x = __ldg(coords + p);
  float* outp = out + p * (long long)(levels * K);

  for (int l = 0; l < levels; ++l) {
    const int W2 = pyr.w2[l];
    const float xl = x * (1.0f / (float)(1 << l));  // exact power-of-two scale
    float c[K + 1];
    float frac;
    rst::level_dots<NV, R>(a, pyr.f2[l] + row * (long long)W2 * D, W2, D, D4, xl, lane, c,
                           frac);
    float val = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (lane == k) val = rst::window_tap(c[k], c[k + 1], frac, inv_sqrt_d);
    }
    if (lane < K) outp[l * K + lane] = val;
  }
}

template <int NV>
cudaError_t launch_nv(int radius, dim3 grid, dim3 block, cudaStream_t stream,
                      const float* f1, const Pyramid& pyr, int levels,
                      const float* coords, float* out, long long n_pix, int W1,
                      int D, float inv_sqrt_d) {
  switch (radius) {
#define ALT_CORR_CASE(R)                                                      \
  case R:                                                                     \
    alt_corr_kernel<NV, R><<<grid, block, 0, stream>>>(                       \
        f1, pyr, levels, coords, out, n_pix, W1, D, inv_sqrt_d);              \
    return cudaSuccess;
    ALT_CORR_CASE(1)
    ALT_CORR_CASE(2)
    ALT_CORR_CASE(3)
    ALT_CORR_CASE(4)
#undef ALT_CORR_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// f2_levels / widths are host arrays of ``levels`` entries. f1, every level,
// coords and out are contiguous fp32 device buffers; f1 and every level are
// 16-byte aligned with D % 4 == 0 (the wrapper checks both).
extern "C" int alt_corr_lookup(const void* f1, const void* const* f2_levels,
                               const int* widths, int levels, const void* coords,
                               void* out, int rows, int W1, int D, int radius,
                               void* stream) {
  if (levels < 1 || levels > kMaxLevels || D < 4 || D % 4 != 0 || D > 512 ||
      rows < 1 || W1 < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Pyramid pyr;
  for (int l = 0; l < kMaxLevels; ++l) {
    pyr.f2[l] = l < levels ? static_cast<const float*>(f2_levels[l]) : nullptr;
    pyr.w2[l] = l < levels ? widths[l] : 0;
  }
  const long long n_pix = (long long)rows * W1;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((unsigned)((n_pix + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const float inv_sqrt_d = 1.0f / sqrtf((float)D);
  const float* f1p = static_cast<const float*>(f1);
  const float* cp = static_cast<const float*>(coords);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nv = (D / 4 + 31) / 32;
  cudaError_t err;
  if (nv == 1) {
    err = launch_nv<1>(radius, grid, block, s, f1p, pyr, levels, cp, op, n_pix, W1, D, inv_sqrt_d);
  } else if (nv == 2) {
    err = launch_nv<2>(radius, grid, block, s, f1p, pyr, levels, cp, op, n_pix, W1, D, inv_sqrt_d);
  } else {
    err = launch_nv<4>(radius, grid, block, s, f1p, pyr, levels, cp, op, n_pix, W1, D, inv_sqrt_d);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
