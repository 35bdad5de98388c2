// Fused test-mode refinement step for Hopper (sm_90a).
//
// Replaces the TPU kernel
// raft_stereo_tpu/ops/pallas_fused_update.py::_fused_kernel (one Pallas
// program per iteration there). One call computes one refinement iteration
// at the finest level of RAFT-Stereo, from the alt correlation state
// (f1 [B,H,W,D] and the width-pooled pyramid, fp32), the x-flow [B,H,W]
// (fp32), the hidden state h [B,H,W,dh], the upsampled coarser state
// inp16 [B,H,W,Ci] (optional) and the context gate biases
// ctx = cz|cr|cq [B,H,W,3dh], all three in the compute type T (fp32 or
// bf16):
//
//   cor   = relu(convc1(lookup(f1, pyramid, x + flow)))        1x1, L(2r+1) -> 64
//   flo   = relu(convf1(flow))                                 7x7, 1 -> 64
//   cf2   = relu(convc2(cor) | convf2(flo))                    3x3, 2 x (64 -> 64)
//   m     = relu(conv(cf2)) with channel 126 = flow            3x3, 128 -> 126 (+2)
//   z, r  = sigmoid(convz|convr([h, m, inp16]) + cz|cr)        3x3, din -> 2 dh
//   h'    = (1-z) h + z tanh(convq([r h, m, inp16]) + cq)      3x3, din -> dh
//   delta = convfh2(relu(convfh1(h')))[x]                      3x3, dh -> 256 -> 1
//
// and writes h' (in T) and delta (fp32). Products take T operands and
// accumulate in fp32; every intermediate is rounded to T where the plain
// version (ops/fused_update.py::reference_refine_step) rounds it.
//
// Bound on an H100 SXM at the 544x960 slice shape (B=1, 136x240, D=256,
// dh=128, with inp16): about 121 GFLOP and 150 MB per step, so arithmetic
// binds (0.12 ms at the bf16 tensor-core rate, 1.8 ms on fp32 FMA, 45 us of
// HBM traffic).
//
// Design. The TPU kernel keeps a whole row band of the chain in VMEM with
// a 9-row halo; with 128-384 channels per intermediate that band is
// megabytes, against 227 KB of shared memory per block here. So the step
// is a chain of 7 launches on one stream, and the intermediates (about
// 40 MB in bf16) round-trip through the 50 MB L2 instead:
//   1. motion_in_kernel: one warp per pixel does the lookup (the device
//      code of K1, alt_corr_lookup.cuh), convc1 + relu and convf1 + relu,
//      writing cor|flo;
//   2-6. conv_kernel: one implicit-GEMM NHWC 3x3 conv (128 pixels, or 64
//      in fp32, x 64 output channels a block; K in chunks of 32 input
//      channels, copied two stages deep with cp.async; inputs concatenated
//      from up to three tensors without a copy), with bf16 tensor cores
//      through WMMA (fp32 accumulate) or fp32 FMA (never TF32), and a
//      fused epilogue: bias+relu (convc2|convf2 as two groups,
//      flow head conv1), bias+relu plus the flow channel (motion conv), the
//      sigmoid gates writing z and r·h (z/r conv), tanh and the GRU blend
//      (q conv);
//   7. head_out_kernel: the x-only flow head conv2 as a 2304-term reduction,
//      one warp per pixel.
// Zero padding at every image edge, the TPU kernel's per-stage row mask,
// comes from the loaders, which read zeros outside the image.
//
// Interface: plain C, loaded with ctypes. ``fused_update_step`` launches
// the chain on the given stream and returns the first cudaGetLastError()
// that is not cudaSuccess. The wrapper allocates every output and the
// scratch buffers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "alt_corr_lookup.cuh"

namespace {

using rst::kMaxLevels;
using rst::Pyramid;
using bf16 = __nv_bfloat16;

// Pointer slots of fused_update_step, in this order (ops/fused_update.py
// mirrors it).
enum Slot {
  kF1, kFlow, kH, kInp, kCtx,
  kWc1, kBc1, kKf7, kBf7, kWcf, kBcf, kKm, kBm, kWzr, kBzr, kWq, kBq,
  kKfh1, kBfh1, kKfh2, kBfh2,
  kHOut, kDelta,
  kCf, kCf2, kM, kZ, kRh, kFh1,
  kSlots
};

constexpr int kMotionCh = 128;    // cor|flo, cf2 and m channels
constexpr int kFlowCh = 126;      // m's flow channel
constexpr int kHeadCh = 256;      // flow head hidden channels
constexpr int kWarps = 8;         // warps a block in the per-pixel kernels

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// v rounded to T and widened again: a cast point of the plain version.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// ---------------------------------------------------------------- stage 1
// One warp per pixel: the L(2r+1) window taps (K1's device code), rounded
// to T, into convc1 (lane owns output channels lane and lane + 32); then
// convf1 over the 7x7 neighbourhood of the flow, rounded to T.
template <typename T, int NV, int R>
__global__ void __launch_bounds__(32 * kWarps)
motion_in_kernel(const float* __restrict__ f1, Pyramid pyr, int levels,
                 const float* __restrict__ flow, const T* __restrict__ wc1,
                 const float* __restrict__ bc1, const T* __restrict__ kf7,
                 const float* __restrict__ bf7, T* __restrict__ cf, int P, int H, int W,
                 int D, float inv_sqrt_d) {
  constexpr int K = 2 * R + 1;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= P) return;  // whole warp leaves together
  const int x = p % W;
  const int row = p / W;  // b*H + y
  const int y = row % H;
  const int D4 = D >> 2;

  float4 a[NV];
  rst::load_f1_row<NV>(f1 + (long long)p * D, D4, lane, a);
  const float coord = (float)x + __ldg(flow + p);

  float c0 = 0.f, c1 = 0.f;
  for (int l = 0; l < levels; ++l) {
    const int W2 = pyr.w2[l];
    const float xl = coord * (1.0f / (float)(1 << l));  // exact power-of-two scale
    float c[K + 1];
    float frac;
    rst::level_dots<NV, R>(a, pyr.f2[l] + (long long)row * W2 * D, W2, D, D4, xl, lane, c,
                           frac);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float t = round_to<T>(rst::window_tap(c[k], c[k + 1], frac, inv_sqrt_d));
      const T* w = wc1 + (l * K + k) * 64;
      c0 = fmaf(t, to_f(w[lane]), c0);
      c1 = fmaf(t, to_f(w[lane + 32]), c1);
    }
  }
  T* out = cf + (long long)p * kMotionCh;
  out[lane] = from_f<T>(fmaxf(c0 + bc1[lane], 0.f));
  out[lane + 32] = from_f<T>(fmaxf(c1 + bc1[lane + 32], 0.f));

  float g0 = 0.f, g1 = 0.f;
  for (int dy = -3; dy <= 3; ++dy) {
    const int yy = y + dy;
    if (yy < 0 || yy >= H) continue;
    for (int dx = -3; dx <= 3; ++dx) {
      const int xx = x + dx;
      if (xx < 0 || xx >= W) continue;
      const float v = round_to<T>(__ldg(flow + p + dy * W + dx));
      const T* w = kf7 + ((dy + 3) * 7 + (dx + 3)) * 64;
      g0 = fmaf(v, to_f(w[lane]), g0);
      g1 = fmaf(v, to_f(w[lane + 32]), g1);
    }
  }
  out[64 + lane] = from_f<T>(fmaxf(g0 + bf7[lane], 0.f));
  out[96 + lane] = from_f<T>(fmaxf(g1 + bf7[lane + 32], 0.f));
}

// -------------------------------------------------------------- the conv
constexpr int BN = 64;   // output channels a block
constexpr int BK = 32;   // input channels a K chunk
constexpr int kConvThreads = 128;

enum Epilogue { kEpiRelu, kEpiMotion, kEpiGates, kEpiGru };

struct Seg {
  const void* ptr;  // [P][ld] in T
  int ch;           // channels taken, a multiple of BK
  int ld;
};

struct ConvArgs {
  Seg seg[3];        // the input: these tensors' channels, concatenated
  int nseg;
  const void* w;     // [ks*ks][cin][cout] in T
  int cin;           // input channels per tap that an output channel reads
  int cout;          // output channels, a multiple of BN
  int group_cout;    // 0, or the output channels of a group: output tile n0
                     // reads input channels from (n0 / group_cout) * cin on
  int ks;            // kernel size (odd)
  int P, H, W;
  const float* bias;  // [cout]
  void* out;          // kEpiRelu, kEpiMotion, kEpiGru: [P][ldo] in T
  int ldo;
  const float* flow;  // kEpiMotion: [P]
  const void* ctx;    // kEpiGates, kEpiGru: [P][3 dh] in T
  const void* h;      // kEpiGates, kEpiGru: [P][dh] in T
  float* z;           // written by kEpiGates, read by kEpiGru: [P][dh]
  void* rh;           // kEpiGates: [P][dh] in T
  int dh;
};

// Shared-memory tiles of one block: two stages of A (pixels x input
// channels) and B (input channels x output channels), and, over them once
// the K loop is done, the fp32 result tile for the epilogue. BM output
// pixels a block: 128 for bf16 (each of the 4 warps a 64x32 tile on the
// tensor cores), 64 for fp32 (8x4 a thread on the FMA units).
template <typename T>
struct Tiles {
  static constexpr int BM = sizeof(T) == 2 ? 128 : 64;
  static constexpr int VEC = 16 / sizeof(T);  // elements in a 16-byte chunk
  static constexpr int ALD = BK + VEC;        // padded row lengths
  static constexpr int BLD = BN + VEC;
  static constexpr int CLD = BN + 4;
  struct Stage {
    T a[BM][ALD];
    T b[BK][BLD];
  };
  union Smem {
    Stage st[2];
    float c[BM][CLD];
  };
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

// The block's BM x 64 fp32 product, accumulated chunk by chunk.
template <typename T>
struct Mma;

// fp32: FMA, each thread an 8x4 register tile (rows 8 ty.., cols 4 tx..).
template <>
struct Mma<float> {
  using Tl = Tiles<float>;
  float acc[8][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  __device__ void step(const Tl::Stage& s) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(&s.b[k][tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = s.a[ty * 8 + i][k];
        acc[i][0] = fmaf(av, bv.x, acc[i][0]);
        acc[i][1] = fmaf(av, bv.y, acc[i][1]);
        acc[i][2] = fmaf(av, bv.z, acc[i][2]);
        acc[i][3] = fmaf(av, bv.w, acc[i][3]);
      }
    }
  }
  __device__ void store(Tl::Smem& s) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(&s.c[ty * 8 + i][tx * 4]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
};

// bf16: tensor cores through WMMA 16x16x16 (fp32 accumulate); the 4 warps
// tile the 128x64 block 2x2, each warp 64x32 (4x2 fragments).
template <>
struct Mma<bf16> {
  using Tl = Tiles<bf16>;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[4][2];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
  }
  __device__ void step(const Tl::Stage& s) {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], &s.a[wm * 64 + i * 16][kk], Tl::ALD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &s.b[kk][wn * 32 + j * 16], Tl::BLD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  __device__ void store(Tl::Smem& s) {
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(&s.c[wm * 64 + i * 16][wn * 32 + j * 16], acc[i][j],
                                        Tl::CLD, nvcuda::wmma::mem_row_major);
  }
};

// SAME ks x ks conv over NHWC rows as an implicit GEMM: M = pixels,
// N = output channels, K = taps x input channels. K runs as one sequence
// of (tap, 32-channel chunk) steps; each step's slices of the (shifted,
// zero-padded) input and of the weights go to shared memory with 16-byte
// cp.async copies, two stages deep, so the next step's copies overlap this
// step's products. The fused epilogue reads the fp32 tile back from shared
// memory, one output channel a thread, so its global reads and writes are
// coalesced.
template <typename T, int EPI>
__global__ void __launch_bounds__(kConvThreads) conv_kernel(const ConvArgs args) {
  using Tl = Tiles<T>;
  constexpr int BM = Tl::BM;
  constexpr int VEC = Tl::VEC;
  constexpr int A_CPR = BK / VEC;                    // 16-byte chunks an A row
  constexpr int A_CPT = BM * A_CPR / kConvThreads;   // A chunks a thread
  constexpr int B_CPR = BN / VEC;
  constexpr int B_CPT = BK * B_CPR / kConvThreads;
  // Raw bytes: the union is never constructed.
  __shared__ __align__(128) unsigned char smem[sizeof(typename Tl::Smem)];
  typename Tl::Smem& sm = *reinterpret_cast<typename Tl::Smem*>(smem);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int P = args.P, H = args.H, W = args.W;
  const int half = args.ks / 2;
  const int cin_off = args.group_cout ? (n0 / args.group_cout) * args.cin : 0;
  const int n_chunks = args.cin / BK;
  const int n_steps = args.ks * args.ks * n_chunks;

  // The A rows (pixels) this thread stages stay the same for the whole K
  // loop; y < 0 marks a row past the last pixel.
  int a_row[A_CPT], a_col[A_CPT], a_y[A_CPT], a_x[A_CPT];
#pragma unroll
  for (int i = 0; i < A_CPT; ++i) {
    const int chunk = tid + i * kConvThreads;
    a_row[i] = chunk / A_CPR;
    a_col[i] = (chunk % A_CPR) * VEC;
    const int pm = m0 + a_row[i];
    a_x[i] = pm % W;
    a_y[i] = pm < P ? (pm / W) % H : -H - 8;
  }

  // Starts the copies of K step ``k`` into stage ``st``.
  auto load = [&](int st, int k) {
    const int tap = k / n_chunks;
    const int c0 = (k - tap * n_chunks) * BK;
    const int dy = tap / args.ks - half, dx = tap % args.ks - half;
    int g = cin_off + c0, s = 0;
    while (s < args.nseg - 1 && g >= args.seg[s].ch) {
      g -= args.seg[s].ch;
      ++s;
    }
    const T* src = static_cast<const T*>(args.seg[s].ptr);
    const int ld = args.seg[s].ld;
#pragma unroll
    for (int i = 0; i < A_CPT; ++i) {
      const int yy = a_y[i] + dy, xx = a_x[i] + dx;
      const bool valid = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const long long pix = valid ? (long long)(m0 + a_row[i]) + dy * W + dx : 0;
      cp_async16(&sm.st[st].a[a_row[i]][a_col[i]], src + pix * ld + g + a_col[i], valid);
    }
    const T* wp = static_cast<const T*>(args.w) +
                  ((long long)tap * args.cin + c0) * args.cout + n0;
#pragma unroll
    for (int i = 0; i < B_CPT; ++i) {
      const int chunk = tid + i * kConvThreads;
      const int r = chunk / B_CPR, col = (chunk % B_CPR) * VEC;
      cp_async16(&sm.st[st].b[r][col], wp + (long long)r * args.cout + col, true);
    }
  };

  Mma<T> mma;
  mma.zero();
  load(0, 0);
  cp_async_commit();
  for (int k = 0; k < n_steps; ++k) {
    if (k + 1 < n_steps) load((k + 1) & 1, k + 1);
    cp_async_commit();  // an empty group on the last step keeps the count
    cp_async_wait_prev();
    __syncthreads();
    mma.step(sm.st[k & 1]);
    __syncthreads();  // the next step's copies overwrite this stage
  }
  mma.store(sm);
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += kConvThreads) {
    const int r = idx / BN, n = idx % BN;
    const long long pm = m0 + r;
    if (pm >= P) break;  // rows only grow with idx
    const int nn = n0 + n;
    const float v = sm.c[r][n] + args.bias[nn];
    if constexpr (EPI == kEpiRelu) {
      static_cast<T*>(args.out)[pm * args.ldo + nn] = from_f<T>(fmaxf(v, 0.f));
    } else if constexpr (EPI == kEpiMotion) {
      float m = fmaxf(v, 0.f);
      if (nn == kFlowCh) m += args.flow[pm];
      static_cast<T*>(args.out)[pm * args.ldo + nn] = from_f<T>(m);
    } else if constexpr (EPI == kEpiGates) {
      const int dh = args.dh;
      const T* ctx = static_cast<const T*>(args.ctx) + pm * 3 * dh;
      if (nn < dh) {
        args.z[pm * dh + nn] = sigmoid(v + to_f(ctx[nn]));
      } else {
        const int j = nn - dh;
        const float rg = sigmoid(v + to_f(ctx[dh + j]));
        const float hv = to_f(static_cast<const T*>(args.h)[pm * dh + j]);
        static_cast<T*>(args.rh)[pm * dh + j] = from_f<T>(rg * hv);
      }
    } else {  // kEpiGru
      const int dh = args.dh;
      const float q = tanhf(v + to_f(static_cast<const T*>(args.ctx)[pm * 3 * dh + 2 * dh + nn]));
      const float hv = to_f(static_cast<const T*>(args.h)[pm * dh + nn]);
      const float zz = args.z[pm * dh + nn];
      static_cast<T*>(args.out)[pm * args.ldo + nn] = from_f<T>((1.f - zz) * hv + zz * q);
    }
  }
}

// ---------------------------------------------------------------- stage 7
// The flow head's conv2, x channel only: a 3x3xC reduction a pixel, one
// warp a pixel, lanes over channels.
template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
head_out_kernel(const T* __restrict__ fh1, const T* __restrict__ k2,
                const float* __restrict__ b2, float* __restrict__ delta, int P, int H, int W,
                int C) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= P) return;
  const int x = p % W;
  const int y = (p / W) % H;
  float s = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int yy = y + dy, xx = x + dx;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
    const T* src = fh1 + ((long long)p + dy * W + dx) * C;
    const T* w = k2 + tap * C;
    for (int c = lane; c < C; c += 32) s = fmaf(to_f(src[c]), to_f(w[c]), s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[p] = s + b2[0];
}

template <typename T, int NV>
void launch_motion_in(int radius, dim3 grid, dim3 block, cudaStream_t st, const float* f1,
                      const Pyramid& pyr, int levels, const float* flow, const T* wc1,
                      const float* bc1, const T* kf7, const float* bf7, T* cf, int P, int H,
                      int W, int D, float inv_sqrt_d) {
  switch (radius) {
#define MOTION_IN_CASE(R)                                                               \
  case R:                                                                               \
    motion_in_kernel<T, NV, R><<<grid, block, 0, st>>>(f1, pyr, levels, flow, wc1, bc1, \
                                                       kf7, bf7, cf, P, H, W, D,        \
                                                       inv_sqrt_d);                     \
    break;
    MOTION_IN_CASE(1)
    MOTION_IN_CASE(2)
    MOTION_IN_CASE(3)
    MOTION_IN_CASE(4)
#undef MOTION_IN_CASE
    default:
      break;
  }
}

template <typename T, int EPI>
cudaError_t launch_conv(const ConvArgs& a, cudaStream_t st) {
  constexpr int BM = Tiles<T>::BM;
  const dim3 grid((unsigned)((a.P + BM - 1) / BM), (unsigned)(a.cout / BN));
  conv_kernel<T, EPI><<<grid, kConvThreads, 0, st>>>(a);
  return cudaGetLastError();
}

Seg seg_of(const void* ptr, int ch) { return Seg{ptr, ch, ch}; }

template <typename T>
int step(const void* const* ptrs, const Pyramid& pyr, int levels, int B, int H, int W, int D,
         int radius, int dh, int inp_ch, cudaStream_t st) {
  const int P = B * H * W;
  const float inv_sqrt_d = 1.0f / sqrtf((float)D);
  auto tp = [&](Slot s) { return static_cast<const T*>(ptrs[s]); };
  auto fp = [&](Slot s) { return static_cast<const float*>(ptrs[s]); };
  cudaError_t err;

  // 1. lookup + convc1 + relu, convf1 + relu -> cf = cor|flo
  {
    const dim3 grid((unsigned)((P + kWarps - 1) / kWarps)), block(32 * kWarps);
    const int nv = (D / 4 + 31) / 32;
    T* cf = static_cast<T*>(const_cast<void*>(ptrs[kCf]));
    if (nv == 1) {
      launch_motion_in<T, 1>(radius, grid, block, st, fp(kF1), pyr, levels, fp(kFlow),
                             tp(kWc1), fp(kBc1), tp(kKf7), fp(kBf7), cf, P, H, W, D,
                             inv_sqrt_d);
    } else if (nv == 2) {
      launch_motion_in<T, 2>(radius, grid, block, st, fp(kF1), pyr, levels, fp(kFlow),
                             tp(kWc1), fp(kBc1), tp(kKf7), fp(kBf7), cf, P, H, W, D,
                             inv_sqrt_d);
    } else {
      launch_motion_in<T, 4>(radius, grid, block, st, fp(kF1), pyr, levels, fp(kFlow),
                             tp(kWc1), fp(kBc1), tp(kKf7), fp(kBf7), cf, P, H, W, D,
                             inv_sqrt_d);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  ConvArgs base{};
  base.ks = 3;
  base.P = P;
  base.H = H;
  base.W = W;
  base.dh = dh;

  // 2. convc2 | convf2 as two groups of 64 -> cf2
  {
    ConvArgs a = base;
    a.seg[0] = seg_of(ptrs[kCf], kMotionCh);
    a.nseg = 1;
    a.w = ptrs[kWcf];
    a.cin = 64;
    a.cout = kMotionCh;
    a.group_cout = 64;
    a.bias = fp(kBcf);
    a.out = const_cast<void*>(ptrs[kCf2]);
    a.ldo = kMotionCh;
    if ((err = launch_conv<T, kEpiRelu>(a, st)) != cudaSuccess) return (int)err;
  }
  // 3. the motion conv, flow in channel 126 -> m
  {
    ConvArgs a = base;
    a.seg[0] = seg_of(ptrs[kCf2], kMotionCh);
    a.nseg = 1;
    a.w = ptrs[kKm];
    a.cin = kMotionCh;
    a.cout = kMotionCh;
    a.bias = fp(kBm);
    a.out = const_cast<void*>(ptrs[kM]);
    a.ldo = kMotionCh;
    a.flow = fp(kFlow);
    if ((err = launch_conv<T, kEpiMotion>(a, st)) != cudaSuccess) return (int)err;
  }
  // 4-5. the ConvGRU: z/r conv over [h, m, inp16], then q conv over
  // [r h, m, inp16] with the blend -> h'
  ConvArgs g = base;
  g.seg[1] = seg_of(ptrs[kM], kMotionCh);
  g.nseg = 2;
  if (inp_ch > 0) {
    g.seg[2] = seg_of(ptrs[kInp], inp_ch);
    g.nseg = 3;
  }
  g.cin = dh + kMotionCh + inp_ch;
  g.ctx = ptrs[kCtx];
  g.h = ptrs[kH];
  g.z = static_cast<float*>(const_cast<void*>(ptrs[kZ]));
  {
    ConvArgs a = g;
    a.seg[0] = seg_of(ptrs[kH], dh);
    a.w = ptrs[kWzr];
    a.cout = 2 * dh;
    a.bias = fp(kBzr);
    a.rh = const_cast<void*>(ptrs[kRh]);
    if ((err = launch_conv<T, kEpiGates>(a, st)) != cudaSuccess) return (int)err;
  }
  {
    ConvArgs a = g;
    a.seg[0] = seg_of(ptrs[kRh], dh);
    a.w = ptrs[kWq];
    a.cout = dh;
    a.bias = fp(kBq);
    a.out = const_cast<void*>(ptrs[kHOut]);
    a.ldo = dh;
    if ((err = launch_conv<T, kEpiGru>(a, st)) != cudaSuccess) return (int)err;
  }
  // 6. flow head conv1 + relu -> fh1
  {
    ConvArgs a = base;
    a.seg[0] = seg_of(ptrs[kHOut], dh);
    a.nseg = 1;
    a.w = ptrs[kKfh1];
    a.cin = dh;
    a.cout = kHeadCh;
    a.bias = fp(kBfh1);
    a.out = const_cast<void*>(ptrs[kFh1]);
    a.ldo = kHeadCh;
    if ((err = launch_conv<T, kEpiRelu>(a, st)) != cudaSuccess) return (int)err;
  }
  // 7. flow head conv2, x channel -> delta
  {
    const dim3 grid((unsigned)((P + kWarps - 1) / kWarps)), block(32 * kWarps);
    head_out_kernel<T><<<grid, block, 0, st>>>(tp(kFh1), tp(kKfh2), fp(kBfh2),
                                               static_cast<float*>(const_cast<void*>(ptrs[kDelta])),
                                               P, H, W, kHeadCh);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// One refinement step. ``ptrs`` holds kSlots device pointers in Slot order
// (ptrs[kInp] is null when inp_ch == 0); f2_levels / widths are host arrays
// of ``levels`` entries. Every buffer is contiguous and 16-byte aligned
// (the wrapper checks): f1, the pyramid, flow, the biases, z and delta in
// fp32, everything else in the compute type (bf16 when ``use_bf16`` is 1).
extern "C" int fused_update_step(int use_bf16, const void* const* ptrs, const void* const* f2_levels,
                                 const int* widths, int levels, int B, int H, int W, int D,
                                 int radius, int dh, int inp_ch, void* stream) {
  if (levels < 1 || levels > kMaxLevels || D < 4 || D % 4 != 0 || D > 512 || radius < 1 ||
      radius > 4 || B < 1 || H < 1 || W < 1 || dh < BN || dh % BN != 0 || inp_ch < 0 ||
      inp_ch % BK != 0 || (inp_ch > 0) != (ptrs[kInp] != nullptr) ||
      (long long)B * H * W > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  Pyramid pyr;
  for (int l = 0; l < kMaxLevels; ++l) {
    pyr.f2[l] = l < levels ? static_cast<const float*>(f2_levels[l]) : nullptr;
    pyr.w2[l] = l < levels ? widths[l] : 0;
    if (l < levels && widths[l] < 1) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_bf16) return step<bf16>(ptrs, pyr, levels, B, H, W, D, radius, dh, inp_ch, st);
  return step<float>(ptrs, pyr, levels, B, H, W, D, radius, dh, inp_ch, st);
}

// The number of pointer slots fused_update_step reads, for the wrapper's check.
extern "C" int fused_update_slots() { return kSlots; }
