// Alt-correlation lookup for Hopper (sm_90a).
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
// Design: one block for each (image row, level, segment of up to 256
// pixels of W1), all in one launch; the level varies fastest in the grid,
// so the level blocks of one segment run side by side and L2 feeds them
// the segment's f1 rows. The block loops over D in chunks of DC channels.
// For each chunk it copies the segment's f1 rows [seg, DC] and the level's
// whole f2 row [W2_l, DC] into shared memory with 16-byte cp.async, in two
// stages, so that the next chunk's copy overlaps this chunk's products.
// The windows depend on the data, so any position of the row may be
// needed. One thread serves one pixel: it keeps its 2r+2 window dot
// products in registers across the chunks, sums each chunk's products
// into a partial of its own and adds the partials (a blocked order, as the
// warp tree's was), and at the end forms its 2r+1 taps. No warp shuffles.
// Staged rows are DC floats, unpadded, and thread t reads the float4s of
// a row in the order q ^ (t mod 8): at DC = 32 a row is one 128-byte line
// of the 32 banks, so the 8 threads of a quarter-warp read 8 disjoint
// bank groups whatever rows their windows fall on. (Rows padded to DC + 4
// floats keep only neighbouring positions apart: with uniform random
// disparities that took about twice the shared-memory wavefronts.) The
// wrapper (ops/alt_corr.py::launch_geometry) picks DC = 32 where D allows
// and a segment short enough for two stages to fit in 227 KB; a partial
// last chunk is zero-filled.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32) at the 544x960 slice
// shape (H=136, W1=240, D=256, L=4, r=4): bytes f1 33.4 MB + f2 pyramid
// 62.7 MB + coords 0.13 MB + out 4.7 MB = 100.9 MB -> 30 us; operations
// 32,640 px x 4 levels x 10 dots x 512 = 0.67 GFLOP -> 10 us. So the
// lookup is bound by memory traffic. What bounds this design is
// shared-memory reads instead: 11 float loads (the f1 value and 10 window
// rows) a pixel, channel and level, about 1.47 GB at the slice shape, at
// 128 B/clk on each of 132 SMs (about 30 TB/s) about 0.05 ms. HBM sees
// each f2 byte once per segment and f1 about once. At the slice shape a
// block takes 120 KB (one an SM, 544 blocks in 5 waves), so each thread's
// 10 sums advance together, a float4 step at a time, for their loads and
// multiply-adds to overlap. Predicted 0.065-0.085 ms there and 0.75-1.0 ms
// at Middlebury-F width ([1, 496, 720, 256], four segments of 180 pixels
// a row, where restaging the level row for each segment puts 4.1 GB
// through L2), where the warp-per-pixel kernel before this one took 0.117
// and 1.16 ms. Measured (chip_smoke.py, H100 80GB HBM3 at 700 W): 0.103
// and 1.12 ms, the old kernel 0.117 and 1.16 in the same run. The bound
// of the shared-memory reads is not reached: with one block an SM, every
// warp stops for each chunk's copies and two barriers.
//
// Interface: plain C, loaded with ctypes. The function launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxThreads = 256;        // pixels a segment
constexpr int kMaxSmem = 227 * 1024;    // dynamic shared memory a block may opt into

struct Pyramid {
  const float* f2[kMaxLevels];
  int w2[kMaxLevels];
};

// 16-byte global -> shared copy that does not wait; zero-fills when
// ``valid`` is false (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);  // all but the newest group landed
}

// Copies channels [c0, c0 + DC) of the segment's n_pix f1 rows and then of
// the level's W2 f2 rows into consecutive staged rows of DC floats;
// channels past D are zero-filled. blockDim.x is a multiple of 32, so a
// thread copies the same 16-byte piece of every row it copies.
template <int DC>
__device__ __forceinline__ void stage_chunk(float* st, const float* __restrict__ f1seg, int n_pix,
                                            const float* __restrict__ f2row, int W2, int D,
                                            int c0) {
  constexpr int Q = DC / 4;  // 16-byte pieces a staged row
  const int q = threadIdx.x % Q;
  const int step = blockDim.x / Q;
  const int c = c0 + 4 * q;
  const bool valid = c < D;
  const int cc = valid ? c : 0;
  for (int r = threadIdx.x / Q; r < n_pix; r += step) {
    cp_async16(st + r * DC + 4 * q, f1seg + (long long)r * D + cc, valid);
  }
  float* st2 = st + n_pix * DC;
  for (int r = threadIdx.x / Q; r < W2; r += step) {
    cp_async16(st2 + r * DC + 4 * q, f2row + (long long)r * D + cc, valid);
  }
}

template <int DC, int R>
__global__ void __launch_bounds__(kMaxThreads, 2)
alt_corr_kernel(const float* __restrict__ f1, Pyramid pyr, int levels,
                const float* __restrict__ coords, float* __restrict__ out, int W1, int D,
                int seg, int n_seg, float inv_sqrt_d) {
  constexpr int K = 2 * R + 1;
  constexpr int NP = 2 * R + 2;
  constexpr int Q = DC / 4;
  extern __shared__ __align__(16) float smem[];

  const int l = blockIdx.x % levels;
  const int s = (blockIdx.x / levels) % n_seg;
  const long long row = blockIdx.x / (levels * n_seg);  // b*H + h
  const int seg0 = s * seg;
  const int n_pix = min(seg, W1 - seg0);
  const int W2 = pyr.w2[l];
  const float* f1seg = f1 + (row * W1 + seg0) * D;
  const float* f2row = pyr.f2[l] + row * W2 * D;
  const int t = threadIdx.x;
  const bool active = t < n_pix;
  const long long p = row * W1 + seg0 + (active ? t : 0);

  // Window position, as in alt_corr_lookup.cuh's level_dots.
  const float xl = __ldg(coords + p) * (1.0f / (float)(1 << l));  // exact power-of-two scale
  const float x0 = floorf(xl);
  const float frac = xl - x0;
  // Clamp before the int conversion: a window wholly outside stays wholly
  // outside.
  const float first = fminf(fmaxf(x0 - (float)R, -(float)(NP + 1)), (float)W2 + 1.0f);
  const int base = (int)first;

  float acc[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) acc[j] = 0.f;

  const int stage_floats = (n_pix + W2) * DC;
  const int rot = t & 7 & (Q - 1);  // this thread's order of a row's float4s
  const int chunks = (D + DC - 1) / DC;
  stage_chunk<DC>(smem, f1seg, n_pix, f2row, W2, D, 0);
  cp_async_commit();
  for (int ci = 0; ci < chunks; ++ci) {
    if (ci + 1 < chunks) {
      stage_chunk<DC>(smem + ((ci + 1) & 1) * stage_floats, f1seg, n_pix, f2row, W2, D,
                      (ci + 1) * DC);
    }
    cp_async_commit();  // an empty group on the last chunk keeps the count
    cp_async_wait_prev();
    __syncthreads();
    if (active) {
      // q outermost: the 2r+2 sums of a step are independent, so their
      // loads and multiply-adds overlap
      const float* st = smem + (ci & 1) * stage_floats;
      const float* rows2 = st + n_pix * DC;
      float part[NP];
#pragma unroll
      for (int j = 0; j < NP; ++j) part[j] = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int off = 4 * (q ^ rot);
        const float4 a = *reinterpret_cast<const float4*>(st + t * DC + off);
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          // positions outside the row read a clamped one and are zeroed below
          const int pos = min(max(base + j, 0), W2 - 1);
          const float4 b = *reinterpret_cast<const float4*>(rows2 + pos * DC + off);
          part[j] = fmaf(a.x, b.x, part[j]);
          part[j] = fmaf(a.y, b.y, part[j]);
          part[j] = fmaf(a.z, b.z, part[j]);
          part[j] = fmaf(a.w, b.w, part[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NP; ++j) acc[j] += part[j];
    }
    __syncthreads();  // the next chunk's copy refills this stage
  }
  if (!active) return;

  float* outp = out + p * (long long)(levels * K) + l * K;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int pos = base + j;
    if (pos < 0 || pos >= W2) acc[j] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    outp[k] = ((1.f - frac) * acc[k] + frac * acc[k + 1]) * inv_sqrt_d;
  }
}

template <int DC, int R>
cudaError_t launch(unsigned blocks, int threads, int smem, cudaStream_t st, const float* f1,
                   const Pyramid& pyr, int levels, const float* coords, float* out, int W1,
                   int D, int seg, int n_seg, float inv_sqrt_d) {
  static bool attr_set = false;  // above 48 KB only after opting in
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(alt_corr_kernel<DC, R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(alt_corr_kernel<DC, R>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  alt_corr_kernel<DC, R><<<blocks, threads, smem, st>>>(f1, pyr, levels, coords, out, W1, D,
                                                        seg, n_seg, inv_sqrt_d);
  return cudaSuccess;
}

template <int DC>
cudaError_t launch_dc(int radius, unsigned blocks, int threads, int smem, cudaStream_t st,
                      const float* f1, const Pyramid& pyr, int levels, const float* coords,
                      float* out, int W1, int D, int seg, int n_seg, float inv_sqrt_d) {
  switch (radius) {
#define ALT_CORR_CASE(R)                                                                  \
  case R:                                                                                 \
    return launch<DC, R>(blocks, threads, smem, st, f1, pyr, levels, coords, out, W1, D, \
                         seg, n_seg, inv_sqrt_d);
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
// 16-byte aligned with D % 4 == 0 (the wrapper checks both). seg (pixels a
// segment), threads (a block), dc (channels a chunk) and smem (dynamic
// shared memory a block, bytes) come from ops/alt_corr.py::launch_geometry.
extern "C" int alt_corr_lookup(const void* f1, const void* const* f2_levels,
                               const int* widths, int levels, const void* coords,
                               void* out, int rows, int W1, int D, int radius, int seg,
                               int threads, int dc, int smem, void* stream) {
  if (levels < 1 || levels > kMaxLevels || D < 4 || D % 4 != 0 || rows < 1 || W1 < 1 ||
      seg < 1 || seg > threads || threads > kMaxThreads || threads % 32 != 0 ||
      smem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  Pyramid pyr;
  int w2max = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    pyr.f2[l] = l < levels ? static_cast<const float*>(f2_levels[l]) : nullptr;
    pyr.w2[l] = l < levels ? widths[l] : 0;
    if (l < levels && widths[l] < 1) return (int)cudaErrorInvalidValue;
    if (pyr.w2[l] > w2max) w2max = pyr.w2[l];
  }
  if (2LL * (seg + w2max) * dc * (long long)sizeof(float) > smem) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_seg = (W1 + seg - 1) / seg;
  const long long blocks = (long long)rows * levels * n_seg;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float inv_sqrt_d = 1.0f / sqrtf((float)D);
  const float* f1p = static_cast<const float*>(f1);
  const float* cp = static_cast<const float*>(coords);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = (unsigned)blocks;
  cudaError_t err;
  switch (dc) {
#define ALT_CORR_DC(DC)                                                                      \
  case DC:                                                                                   \
    err = launch_dc<DC>(radius, nb, threads, smem, s, f1p, pyr, levels, cp, op, W1, D, seg, \
                        n_seg, inv_sqrt_d);                                                  \
    break;
    ALT_CORR_DC(4)
    ALT_CORR_DC(8)
    ALT_CORR_DC(16)
    ALT_CORR_DC(32)
#undef ALT_CORR_DC
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
