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
//   1. motion_in_kernel: one warp per pixel does the lookup (the warp-per-
//      pixel device code of alt_corr_lookup.cuh), convc1 + relu and
//      convf1 + relu, writing cor|flo;
//   2-6. one 3x3 SAME conv each, with inputs concatenated from up to
//      three tensors without a copy and a fused epilogue: bias+relu
//      (convc2|convf2 as two groups, flow head conv1), bias+relu plus the
//      flow channel (motion conv), the sigmoid gates writing z and r·h
//      (z/r conv), tanh and the GRU blend (q conv).
//      bf16 (conv_sm90, on the mainloop of conv3x3_sm90.cuh): what bounds
//      these launches is arithmetic (121 GFLOP a step, 0.12 ms at the bf16
//      rate), so the design keeps the tensor cores fed and gathers each
//      input byte as few times as it can. A block owns 8 x 16 output pixels
//      x all the launch's output channels (up to 256, one m64nNk16 wgmma a
//      warpgroup and k16 step), so the input is gathered once for every
//      output channel; for each 64-channel input chunk the tile's
//      10 x 18-pixel halo is copied into shared memory once (cp.async)
//      and all 9 taps read it (A from registers through ldmatrix at the
//      tap's shift); the (tap, chunk) weight slabs stream by TMA through a
//      5-slot ring, 3 steps ahead; the epilogue works from the
//      accumulators (16-byte loads and stores, the gates on the hardware's
//      exp2 and reciprocal). What still holds them back (PERF.md): each
//      block re-streams the launch's weights from L2 (1.8 MB for z/r) and
//      pays a barrier and the copies' issue every step, so the tensor
//      cores idle about half of the z/r launch.
//      fp32 (conv_kernel, the parity phases' type): 64 pixels x 64 output
//      channels a block on FMA (never TF32), K in chunks of 32 input
//      channels copied two stages deep with cp.async, the epilogue from an
//      fp32 tile in shared memory;
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

#include <type_traits>

#include "alt_corr_lookup.cuh"
#include "conv3x3_sm90.cuh"

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

// The bf16 epilogues' gates: the same functions through the hardware's
// approximate exp2 and reciprocal (a few fp32 ulps from the above, far
// below the bf16 rounding of h' they feed).
__device__ __forceinline__ float sigmoid_fast(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }
__device__ __forceinline__ float tanh_fast(float v) {
  return 1.f - __fdividef(2.f, __expf(2.f * v) + 1.f);
}

// ---------------------------------------------------------------- stage 1
// One warp per pixel: the L(2r+1) window taps (alt_corr_lookup.cuh),
// rounded to T, into convc1 (lane owns output channels lane and lane +
// 32); then convf1 over the 7x7 neighbourhood of the flow, rounded to T.
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

// Shared-memory tiles of one fp32 block: two stages of A (pixels x input
// channels) and B (input channels x output channels), and, over them once
// the K loop is done, the fp32 result tile for the epilogue. BM = 64 output
// pixels a block, 8x4 a thread on the FMA units.
template <typename T>
struct Tiles {
  static constexpr int BM = 64;
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

// The fp32 block's BM x 64 product, accumulated chunk by chunk: FMA, each
// thread an 8x4 register tile (rows 8 ty.., cols 4 tx..).
struct Mma {
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

  Mma mma;
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

// --------------------------------------------------------- the conv, bf16
// One block a spatial tile of kTileH x kTileW output pixels x N output
// channels (all of the launch's, up to 256), on the mainloop of
// conv3x3_sm90.cuh. K runs as steps (input chunk c, tap t): for each chunk
// of 64 input channels (a 32-channel tail allowed) the tile's halo is
// copied into shared memory once and all 9 taps read it; tap t's weight
// slab [kc][N] streams through a ring of kStages slots, kAhead steps
// ahead, by TMA (one 64 x 64 box an N block, completing the slot's
// mbarrier). One barrier a step; a step's products run on through the next
// step's barrier and copies.
namespace tc {
constexpr int kTileH = 8, kTileW = 16;                   // 2 row blocks of 64 pixels
constexpr int kHaloH = kTileH + 2, kHaloW = kTileW + 2;  // its halo
constexpr int kThreads = 256;        // 2 warpgroups, one row block each
constexpr int kChunk = 64;           // input channels a chunk
constexpr int kStages = 5;           // weight ring slots
constexpr int kAhead = kStages - 2;  // steps whose copies are in flight
constexpr int kHalo = kHaloH * kHaloW * sm90::kHaloPitch;
constexpr int kBlock = kChunk * 128;  // a slab's 64-wide N block: 64 K-rows of 128 bytes
constexpr int kBatch = 4;            // epilogue iterations loaded together
template <int N>
__host__ __device__ constexpr int slab_bytes() { return N * kChunk * 2; }
template <int N>
__host__ __device__ constexpr int smem_bytes() {
  // the ring, the halos, an mbarrier a slot and the slack to align the ring
  return kStages * slab_bytes<N>() + 2 * kHalo + kStages * 8 + 1024;
}
}  // namespace tc

// Input chunk c: channels 64c .. 64c + kc of the concatenated input, which
// are channels ch .. of one input tensor (src, row length ld); its weight
// rows start at wrow; a grouped conv's chunk feeds only group ``group``'s
// output channels.
struct Chunk {
  const bf16* src;
  int ld, ch, kc, wrow, group;
};

__device__ __forceinline__ Chunk chunk_at(const ConvArgs& a, int c) {
  const int g = c * tc::kChunk;
  int s = 0, rest = g;
  while (s < a.nseg - 1 && rest >= a.seg[s].ch) {
    rest -= a.seg[s].ch;
    ++s;
  }
  Chunk k;
  k.src = static_cast<const bf16*>(a.seg[s].ptr);
  k.ld = a.seg[s].ld;
  k.ch = rest;
  k.kc = min(tc::kChunk, a.seg[s].ch - rest);
  k.group = a.group_cout ? g / a.cin : 0;
  k.wrow = g - k.group * a.cin;
  return k;
}

template <int N, int EPI>
__global__ void __launch_bounds__(tc::kThreads, 1)
conv_sm90(const ConvArgs args, int tiles_x, int tiles_y,
          const __grid_constant__ CUtensorMap wmap) {
  using namespace tc;
  constexpr int kSlab = slab_bytes<N>();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_ring = (sm90::smem_addr(smem) + 1023) & ~1023u;  // slab atoms 1024-aligned
  const uint32_t s_halo = s_ring + kStages * kSlab;
  const uint32_t s_full = s_halo + 2 * kHalo;  // a slot's slab has landed
  const int tid = threadIdx.x;
  const int H = args.H, W = args.W;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int y0 = (blockIdx.x / tiles_x % tiles_y) * kTileH;
  const int b = blockIdx.x / tiles_x / tiles_y;
  const int n0 = blockIdx.y * N;
  int total = 0;
  for (int s = 0; s < args.nseg; ++s) total += args.seg[s].ch;
  const int n_steps = 9 * ((total + kChunk - 1) / kChunk);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) sm90::mbar_init(s_full + i * 8, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // Starts the copies of step s: tap t's weight slab into ring slot
  // s % kStages and, on tap 0, chunk c's halo into buffer c % 2.
  auto issue = [&](int s) {
    if (s >= n_steps) return;
    const int c = s / 9, t = s - 9 * c;
    const Chunk k = chunk_at(args, c);
    if (t == 0) {
      const uint32_t dst = s_halo + (c & 1) * kHalo;
      const int cpp = k.kc / 8;  // 16-byte copies a pixel
      for (int i = tid; i < kHaloH * kHaloW * cpp; i += kThreads) {
        const int px = i / cpp, ch = (i - px * cpp) * 8;
        const int yy = y0 - 1 + px / kHaloW, xx = x0 - 1 + px % kHaloW;
        const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
        const bf16* src =
            inside ? k.src + (((long long)b * H + yy) * W + xx) * k.ld + k.ch + ch : k.src;
        sm90::cp_async16(dst + px * sm90::kHaloPitch + ch * 2, src, inside);
      }
    }
    if (tid == 0) {  // the slab: one 64 x 64 TMA box an N block, 64 rows even for a tail
      const uint32_t slot = s_ring + (s % kStages) * kSlab, bar = s_full + (s % kStages) * 8;
      sm90::mbar_expect_tx(bar, kSlab);
#pragma unroll
      for (int nb = 0; nb < N / 64; ++nb) {
        const int x = n0 + nb * 64;
        // a grouped conv's other groups read zero weights: a box past the last column
        const bool live = !args.group_cout || x / args.group_cout == k.group;
        sm90::tma_load_2d(slot + nb * kBlock, &wmap, live ? x : args.cout,
                          t * args.cin + k.wrow, bar);
      }
    }
  };

  const int wgp = tid >> 7;
  const int pm_row = wgp * 64 + sm90::a_row();  // this lane's ldmatrix row
  const uint32_t row_off =
      ((pm_row / kTileW) * kHaloW + pm_row % kTileW) * sm90::kHaloPitch + sm90::a_col_bytes();
  float acc[1][N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[0][i] = 0.f;
  // A fragments, two sets: step s loads set s & 1 while step s-1's
  // products still read the other (a 32-channel tail uses half of one).
  uint32_t a4[2][1][4][4];

  for (int s = 0; s < kAhead; ++s) {
    issue(s);
    sm90::cp_async_commit();
  }
  // Step s, on fragment set P = s & 1. One barrier: after it, step s's
  // copies are visible to every thread and every warpgroup's step s-2 is
  // done, so its ring slot takes step s + kAhead's copies. Step s-1's
  // products run on through the barrier and the copies' issue.
  auto run_step = [&](auto par, int s) {
    constexpr int P = decltype(par)::value;
    sm90::cp_async_wait<kAhead - 1>();  // this thread's halo copies of step s landed
    sm90::wgmma_wait<1>();  // this warpgroup's step s-2 is done
    sm90::keep(acc);
    sm90::keep(a4[P]);
    __syncthreads();
    issue(s + kAhead);
    sm90::cp_async_commit();
    const int c = s / 9, t = s - 9 * c;
    const uint32_t rows[1] = {s_halo + (c & 1) * kHalo + row_off};
    const uint32_t shift = sm90::tap_shift(t, kHaloW);
    const uint32_t slab = s_ring + (s % kStages) * kSlab;
    sm90::mbar_wait(s_full + (s % kStages) * 8, (s / kStages) & 1);  // step s's slab landed
    sm90::load_a(a4[P], rows, shift);
    sm90::keep(acc);
    sm90::wgmma_fence();
    if (total - c * kChunk >= kChunk) {
      sm90::mma_a<N, 1, 4>(acc, a4[P], slab, kBlock);
    } else {  // a 32-channel tail
      sm90::mma_a<N, 1, 4, 2>(acc, a4[P], slab, kBlock);
    }
    sm90::wgmma_commit();
  };
  for (int s = 0; s < n_steps; s += 2) {
    run_step(std::integral_constant<int, 0>{}, s);
    if (s + 1 < n_steps) run_step(std::integral_constant<int, 1>{}, s + 1);
  }
  sm90::wgmma_wait<0>();
  sm90::keep(acc);
  sm90::keep(a4[0]);
  sm90::keep(a4[1]);
  sm90::cp_async_wait<0>();

  // The fused epilogue, 8 channels of a pixel a lane at a time. The
  // inputs of kBatch iterations are loaded before any of them is stored,
  // so their latencies overlap.
  const int dh = args.dh;
  const bf16* ctx = static_cast<const bf16*>(args.ctx);
  const bf16* hin = static_cast<const bf16*>(args.h);
#pragma unroll
  for (int i0 = 0; i0 < N / 16; i0 += kBatch) {
    long long px[kBatch];
    bool live[kBatch];
    uint4 in0[kBatch], in1[kBatch];
    float4 zi[kBatch][2];
    float fl[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int pm = wgp * 64 + sm90::epi_row(i0 + j);
      const int yy = y0 + pm / kTileW, xx = x0 + pm % kTileW;
      live[j] = yy < H && xx < W;
      px[j] = live[j] ? ((long long)b * H + yy) * W + xx : 0;
      const int nn = n0 + sm90::epi_col(i0 + j);
      const long long p = px[j];
      if constexpr (EPI == kEpiMotion) {
        fl[j] = args.flow[p];
      } else if constexpr (EPI == kEpiGates) {
        if (nn < dh) {  // 8 channels of z (dh % 64 == 0: a group never straddles)
          in0[j] = *reinterpret_cast<const uint4*>(ctx + p * 3 * dh + nn);
        } else {  // 8 channels of r
          in0[j] = *reinterpret_cast<const uint4*>(ctx + p * 3 * dh + nn);
          in1[j] = *reinterpret_cast<const uint4*>(hin + p * dh + nn - dh);
        }
      } else if constexpr (EPI == kEpiGru) {
        in0[j] = *reinterpret_cast<const uint4*>(ctx + p * 3 * dh + 2 * dh + nn);
        in1[j] = *reinterpret_cast<const uint4*>(hin + p * dh + nn);
        zi[j][0] = *reinterpret_cast<const float4*>(args.z + p * dh + nn);
        zi[j][1] = *reinterpret_cast<const float4*>(args.z + p * dh + nn + 4);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (!live[j]) continue;
      const long long p = px[j];
      const int nn = n0 + sm90::epi_col(i0 + j);
      float v[8], o[8];
      sm90::take8<N>(acc[0], i0 + j, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = v[e] + args.bias[nn + e];
      if constexpr (EPI == kEpiRelu) {
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = fmaxf(o[e], 0.f);
        sm90::store8(static_cast<bf16*>(args.out) + p * args.ldo + nn, o);
      } else if constexpr (EPI == kEpiMotion) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          o[e] = fmaxf(o[e], 0.f);
          if (nn + e == kFlowCh) o[e] += fl[j];
        }
        sm90::store8(static_cast<bf16*>(args.out) + p * args.ldo + nn, o);
      } else if constexpr (EPI == kEpiGates) {
        float g[8], zz[8];
        sm90::unpack8(in0[j], g);
        if (nn < dh) {
          for (int e = 0; e < 8; ++e) zz[e] = sigmoid_fast(o[e] + g[e]);
          float4* zp = reinterpret_cast<float4*>(args.z + p * dh + nn);
          zp[0] = make_float4(zz[0], zz[1], zz[2], zz[3]);
          zp[1] = make_float4(zz[4], zz[5], zz[6], zz[7]);
        } else {  // written as r·h
          float hv[8];
          sm90::unpack8(in1[j], hv);
#pragma unroll
          for (int e = 0; e < 8; ++e) zz[e] = sigmoid_fast(o[e] + g[e]) * hv[e];
          sm90::store8(static_cast<bf16*>(args.rh) + p * dh + nn - dh, zz);
        }
      } else {  // kEpiGru
        float cq[8], hv[8];
        sm90::unpack8(in0[j], cq);
        sm90::unpack8(in1[j], hv);
        const float zz[8] = {zi[j][0].x, zi[j][0].y, zi[j][0].z, zi[j][0].w,
                             zi[j][1].x, zi[j][1].y, zi[j][1].z, zi[j][1].w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float q = tanh_fast(o[e] + cq[e]);
          o[e] = (1.f - zz[e]) * hv[e] + zz[e] * q;
        }
        sm90::store8(static_cast<bf16*>(args.out) + p * args.ldo + nn, o);
      }
    }
  }
}

// The weight [9 cin rows][cout] as a TMA tensor map: 64 x 64 boxes, the
// 128-byte swizzle, zeros outside (sm90::tensor_map_encoder).
cudaError_t weight_map(const ConvArgs& a, CUtensorMap* map) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  const cudaError_t err = sm90::tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)a.cout, (cuuint64_t)(9 * a.cin)};
  const cuuint64_t strides[1] = {(cuuint64_t)a.cout * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)tc::kChunk}, unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(a.w), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int N, int EPI>
cudaError_t launch_sm90(const ConvArgs& a, cudaStream_t st) {
  static bool attr_set = false;  // above 48 KB only after opting in
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_sm90<N, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::smem_bytes<N>());
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  CUtensorMap wmap;
  const cudaError_t err = weight_map(a, &wmap);
  if (err != cudaSuccess) return err;
  const int tiles_x = (a.W + tc::kTileW - 1) / tc::kTileW;
  const int tiles_y = (a.H + tc::kTileH - 1) / tc::kTileH;
  const int B = a.P / (a.H * a.W);
  const dim3 grid((unsigned)(B * tiles_x * tiles_y), (unsigned)(a.cout / N));
  conv_sm90<N, EPI><<<grid, tc::kThreads, tc::smem_bytes<N>(), st>>>(a, tiles_x, tiles_y, wmap);
  return cudaGetLastError();
}

// The widest N the launch's output channels split into: all of them up to
// 256. The motion conv has 128; flow head conv1 256; convc2|convf2 128;
// the gates 2 dh and the GRU dh, with dh % 64 == 0.
template <int EPI>
cudaError_t launch_conv_bf16(const ConvArgs& a, cudaStream_t st) {
  if constexpr (EPI == kEpiMotion) {
    return launch_sm90<128, EPI>(a, st);
  } else {
    if (a.cout % 256 == 0) return launch_sm90<256, EPI>(a, st);
    if constexpr (EPI == kEpiGru) {
      if (a.cout % 128 == 0) return launch_sm90<128, EPI>(a, st);
      return launch_sm90<64, EPI>(a, st);
    } else {
      return launch_sm90<128, EPI>(a, st);
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
  if constexpr (sizeof(T) == 2) {
    return launch_conv_bf16<EPI>(a, st);
  } else {
    constexpr int BM = Tiles<T>::BM;
    const dim3 grid((unsigned)((a.P + BM - 1) / BM), (unsigned)(a.cout / BN));
    conv_kernel<T, EPI><<<grid, kConvThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
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

// Dynamic shared memory of the bf16 conv kernel at n output channels a
// block (64, 128 or 256), for the build report.
extern "C" int fused_update_conv_smem(int n) {
  return n == 256 ? tc::smem_bytes<256>() : n == 128 ? tc::smem_bytes<128>() : tc::smem_bytes<64>();
}
