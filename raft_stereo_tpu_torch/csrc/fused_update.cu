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
//   1. motion_in_kernel: the lookup, convc1 + relu and convf1 + relu,
//      writing cor|flo. What bounds it is memory traffic: at the slice
//      shape it reads f1 and the pyramid (96 MB, fp32) once, 0.031 ms at
//      3.35 TB/s, for 0.83 GFLOP on fp32 FMA. One block a (row, segment):
//      the segment's f1 rows and every level's whole row are staged in
//      shared memory a chunk of channels at a time, so HBM sees each byte
//      about once and L2 each level row once a segment (about 280 MB), and
//      every window sum is read from shared memory (11 loads a pixel,
//      channel and level, about 0.05 ms at the card's shared-memory rate);
//      convc1 and convf1 read the taps, weights and flow from shared memory
//      too. Details at the kernel;
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
//   7. head_out_kernel: the x-only flow head conv2 as a 2304-term reduction
//      a pixel. What bounds it is reading fh1 once (16.7 MB in bf16 at the
//      slice shape). A block owns an 8 x 32 output tile: it projects each
//      pixel of the tile's 10 x 34 halo onto the 9 taps (4 lanes a pixel,
//      16-byte loads, weights in shared memory), then adds each output
//      pixel's 9 shifted taps from shared memory. Details at the kernel.
// Zero padding at every image edge, the TPU kernel's per-stage row mask,
// comes from the loaders, which read zeros outside the image.
//
// Interface: plain C, loaded with ctypes. ``fused_update_step`` launches
// the chain on the given stream and returns the first cudaGetLastError()
// that is not cudaSuccess; ``fused_motion_in`` launches stage 1 alone and
// ``fused_head_out`` stage 7 alone. The
// wrapper allocates every output and the scratch buffers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "conv3x3_sm90.cuh"

namespace {

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

// ---------------------------------------------------------------- stage 1
// The lookup with convc1 and convf1, writing cor|flo. One block for each
// (image row, segment of ``seg`` pixels), all L levels in the block; the
// segment varies fastest in the grid, so the segments of one row run side
// by side and L2 serves them the level rows. The geometry (seg, threads,
// the channel chunk DC, the shared memory) comes from
// ops/fused_update.py::motion_in_geometry, which picks DC for three blocks
// an SM where the rows allow.
//
// Lookup phase: thread t serves (level t / seg, pixel t % seg). For each
// chunk of DC channels the block copies the segment's f1 rows [seg, DC]
// and every level's whole f2 row [W2_l, DC] into shared memory with
// 16-byte cp.async, two stages deep; a partial last chunk is zero-filled.
// Each thread adds its 2r+2 window dot products over the chunk, all of
// them a float4 step at a time, into partials that it adds to its sums:
// K1's inner loop (alt_corr.cu), except that a window position outside
// the row is not read (K1 reads a clamped one and zeroes its sum). Thread
// t reads a row's float4s in the order q ^ rot(t). At DC = 32 a row fills
// a 128-byte line of the banks and rot = t mod 8 (K1's) puts the 8 threads
// of a quarter-warp in 8 distinct bank groups whatever rows they read.
// Below, 32 / DC rows share a line, so where a row starts in the line
// depends on the data; rot is then the thread's rank among the threads of
// its quarter-warp whose window rows start at the same place, and threads
// collide only where more than DC / 4 of them do (neighbouring pixels of
// a smooth disparity field never do; unrelated ones often do). Then each
// thread writes its 2r+1 taps, rounded to T and widened, into a tile
// taps[seg][L(2r+1) | 1] over the stages.
//
// Conv phase: a warp takes 64 pixels x 16 output channels at a time, of
// convc1 (the taps summed over (l, k) ascending from 0, then the bias,
// then the relu) or of convf1 (the 7 x (seg + 6) flow patch staged rounded
// to T, zero outside the image, its 49 taps in (dy, dx) order). The
// weights sit in shared memory as fp32, once a block, and a warp's reads
// of them broadcast; the odd row stride of the tap tile puts 32 pixels'
// reads of one tap in 32 banks. The [seg, 128] cor|flo tile is built in
// shared memory in T and written out with 16-byte stores: a segment's rows
// of cf are contiguous, so the stores coalesce.
constexpr int kMaxLevels = 8;

struct Pyramid {
  const float* f2[kMaxLevels];
  int w2[kMaxLevels];
};

namespace mi {
constexpr int kMaxThreads = 256;      // (level, pixel) pairs a block
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory a block may opt into
constexpr int kSlice = 16;            // output channels of a warp's conv item
constexpr int kFlowRows = 7;          // convf1's rows

// The conv phase's tiles (float offsets), over the lookup's stages.
struct Layout {
  int tap_ld, flow_ld, out_ld;  // row strides: floats, floats, bytes
  int wc1, kf7, flow, out, floats;
  __host__ __device__ Layout(int seg, int lk, int esize) {
    tap_ld = lk | 1;
    flow_ld = seg + 6;
    out_ld = kMotionCh * esize + 16;  // padded: 8 rows' 16-byte pieces in 8 bank groups
    wc1 = round4(seg * tap_ld);
    kf7 = wc1 + lk * 64;
    flow = kf7 + 49 * 64;
    out = flow + round4(kFlowRows * flow_ld);
    floats = out + seg * out_ld / 4;
  }
  static __host__ __device__ int round4(int n) { return (n + 3) & ~3; }
};
}  // namespace mi

struct MotionIn {
  const float* f1;  // [P][D]
  Pyramid pyr;
  int levels;
  const float* flow;  // [P]
  const void* wc1;    // [L(2r+1)][64] in T
  const float* bc1;
  const void* kf7;  // [49][64] in T
  const float* bf7;
  void* cf;  // [P][128] in T
  int H, W, D;
  int seg, n_seg;  // pixels a segment, segments a row
};

// Copies channels [c0, c0 + DC) of the segment's n_pix f1 rows and then of
// every level's f2 row into consecutive staged rows of DC floats; channels
// past D are zero-filled. blockDim.x is a multiple of 32, so a thread
// copies the same 16-byte piece of every row it copies.
template <int DC>
__device__ __forceinline__ void stage_chunk(float* st, const MotionIn& a, const float* f1seg,
                                            int n_pix, long long row, int c0) {
  constexpr int Q = DC / 4;  // 16-byte pieces a staged row
  const int q = threadIdx.x % Q;
  const int step = blockDim.x / Q;
  const int c = c0 + 4 * q;
  const bool valid = c < a.D;
  const int cc = valid ? c : 0;
  for (int r = threadIdx.x / Q; r < n_pix; r += step) {
    cp_async16(st + r * DC + 4 * q, f1seg + (long long)r * a.D + cc, valid);
  }
  float* dst = st + n_pix * DC;
  for (int l = 0; l < a.levels; ++l) {
    const int W2 = a.pyr.w2[l];
    const float* src = a.pyr.f2[l] + row * W2 * a.D;
    for (int r = threadIdx.x / Q; r < W2; r += step) {
      cp_async16(dst + r * DC + 4 * q, src + (long long)r * a.D + cc, valid);
    }
    dst += W2 * DC;
  }
}

// n weights (n % 64 == 0, 16-byte aligned) widened to fp32 into shared
// memory, 16 bytes a load.
__device__ __forceinline__ void stage_weights(float* dst, const float* src, int n) {
  for (int e = 4 * threadIdx.x; e < n; e += 4 * blockDim.x)
    *reinterpret_cast<float4*>(dst + e) = __ldg(reinterpret_cast<const float4*>(src + e));
}
__device__ __forceinline__ void stage_weights(float* dst, const bf16* src, int n) {
  for (int e = 8 * threadIdx.x; e < n; e += 8 * blockDim.x) {
    float v[8];
    sm90::unpack8(__ldg(reinterpret_cast<const uint4*>(src + e)), v);
    *reinterpret_cast<float4*>(dst + e) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + e + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// 16 channels of a pixel into the output tile, rounded to T.
__device__ __forceinline__ void store_slice(float* dst, const float (&o)[mi::kSlice]) {
#pragma unroll
  for (int e = 0; e < mi::kSlice; e += 4)
    *reinterpret_cast<float4*>(dst + e) = make_float4(o[e], o[e + 1], o[e + 2], o[e + 3]);
}
__device__ __forceinline__ void store_slice(bf16* dst, const float (&o)[mi::kSlice]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = o[8 * h + e];
    sm90::store8(dst + 8 * h, v);
  }
}

// The products of two pixels' input values with a 16-channel slice of a
// weight row in shared memory (broadcast to the warp).
__device__ __forceinline__ void fma_slice(float v0, float v1, const float* w,
                                          float (&o)[2][mi::kSlice]) {
#pragma unroll
  for (int e = 0; e < mi::kSlice; e += 4) {
    const float4 ww = *reinterpret_cast<const float4*>(w + e);
    const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[0][e + i] = fmaf(v0, wv[i], o[0][e + i]);
      o[1][e + i] = fmaf(v1, wv[i], o[1][e + i]);
    }
  }
}

template <typename T, int DC, int R>
__global__ void __launch_bounds__(mi::kMaxThreads, 3)
motion_in_kernel(const MotionIn a, float inv_sqrt_d) {
  constexpr int K = 2 * R + 1;
  constexpr int NP = 2 * R + 2;
  constexpr int Q = DC / 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int W = a.W, seg = a.seg, levels = a.levels;
  const int s = blockIdx.x % a.n_seg;
  const long long row = blockIdx.x / a.n_seg;  // b*H + y
  const int y = (int)(row % a.H);
  const int seg0 = s * seg;
  const int n_pix = min(seg, W - seg0);
  const int t = threadIdx.x;
  const int lk = levels * K;
  const mi::Layout lay(seg, lk, (int)sizeof(T));

  // This thread's level and pixel, and its window (as in K1).
  const int l = min(t / seg, levels - 1);
  const int i = t % seg;
  const bool active = t < levels * seg && i < n_pix;
  int level_row = 0, n_rows = n_pix;  // staged rows: the level's first, all
  for (int m = 0; m < levels; ++m) {
    if (m == l) level_row = n_rows;
    n_rows += a.pyr.w2[m];
  }
  const int W2 = a.pyr.w2[l];
  const long long p = row * W + seg0 + (active ? i : 0);
  // exact power-of-two scale
  const float xl = ((float)(seg0 + i) + __ldg(a.flow + p)) * (1.0f / (float)(1 << l));
  const float x0 = floorf(xl);
  const float frac = xl - x0;
  // Clamp before the int conversion: a window wholly outside stays wholly
  // outside.
  const float first = fminf(fmaxf(x0 - (float)R, -(float)(NP + 1)), (float)W2 + 1.0f);
  const int base = (int)first;
  // The window's positions inside the row; the others read nothing and
  // their sums stay 0.
  unsigned inside = 0;
#pragma unroll
  for (int j = 0; j < NP; ++j) inside |= (unsigned)(base + j >= 0 && base + j < W2) << j;

  float acc[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) acc[j] = 0.f;

  const int stage_floats = n_rows * DC;
  // This thread's order of a row's float4s, q ^ rot. K1's order, rot =
  // t / (32 / DC) mod (DC / 4), gives the lanes of a quarter-warp distinct
  // bank groups unless two lanes that share a rot read two rows that start
  // at the same place in a 128-byte line. Where a lane of the quarter-warp
  // meets that, rot is instead its row's rank among the distinct rows of
  // the quarter-warp that start where its row does.
  constexpr int kRowsALine = 32 / DC;
  const int lane = t & 31;
  // an idle lane: a row of its own (a window's rows start at -(NP + 1) at least)
  const int row_key = active ? level_row + base : INT_MIN + lane;
  const unsigned same_row = __match_any_sync(0xffffffffu, row_key);
  const unsigned same_place = __match_any_sync(
      0xffffffffu, active ? row_key & (kRowsALine - 1) : kRowsALine + lane);
  const unsigned quarter = 0xffu << (lane & ~7);
  const unsigned k1_group = ((1u << kRowsALine) - 1) << (lane & ~(kRowsALine - 1));
  const bool clash = (same_place & k1_group & ~same_row) != 0;
  const int leader = __ffs(same_row & quarter) - 1;  // the lowest lane reading my row
  const unsigned leaders = __ballot_sync(0xffffffffu, lane == leader);
  const int rot = (__ballot_sync(0xffffffffu, clash) & quarter)
                      ? __popc(leaders & same_place & quarter & ((1u << leader) - 1)) & (Q - 1)
                      : (lane / kRowsALine) & (Q - 1);
  const int chunks = (a.D + DC - 1) / DC;
  const float* f1seg = a.f1 + (row * W + seg0) * a.D;
  stage_chunk<DC>(smem, a, f1seg, n_pix, row, 0);
  cp_async_commit();
  for (int ci = 0; ci < chunks; ++ci) {
    if (ci + 1 < chunks) {
      stage_chunk<DC>(smem + ((ci + 1) & 1) * stage_floats, a, f1seg, n_pix, row, (ci + 1) * DC);
    }
    cp_async_commit();  // an empty group on the last chunk keeps the count
    cp_async_wait_prev();
    __syncthreads();
    if (active) {
      // q outermost: the 2r+2 sums of a step are independent, so their
      // loads and multiply-adds overlap
      const float* st = smem + (ci & 1) * stage_floats;
      const float* rows2 = st + level_row * DC;
      float part[NP];
#pragma unroll
      for (int j = 0; j < NP; ++j) part[j] = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int off = 4 * (q ^ rot);
        const float4 f = *reinterpret_cast<const float4*>(st + i * DC + off);
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          // predicated: a lane outside the row takes no part in the load's
          // bank accesses
          if (inside >> j & 1u) {
            const float4 b = *reinterpret_cast<const float4*>(rows2 + (base + j) * DC + off);
            part[j] = fmaf(f.x, b.x, part[j]);
            part[j] = fmaf(f.y, b.y, part[j]);
            part[j] = fmaf(f.z, b.z, part[j]);
            part[j] = fmaf(f.w, b.w, part[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NP; ++j) acc[j] += part[j];
    }
    __syncthreads();  // the next chunk's copy refills this stage
  }

  // The taps, rounded to T, and the weights and the flow patch, over the
  // stages that no thread reads any more.
  float* taps = smem;
  if (active) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      taps[i * lay.tap_ld + l * K + k] =
          round_to<T>(((1.f - frac) * acc[k] + frac * acc[k + 1]) * inv_sqrt_d);
    }
  }
  float* w1 = smem + lay.wc1;
  float* w7 = smem + lay.kf7;
  float* fl = smem + lay.flow;
  stage_weights(w1, static_cast<const T*>(a.wc1), lk * 64);
  stage_weights(w7, static_cast<const T*>(a.kf7), 49 * 64);
  for (int e = t; e < mi::kFlowRows * lay.flow_ld; e += blockDim.x) {
    const int dy = e / lay.flow_ld - 3, xx = seg0 - 3 + e % lay.flow_ld;
    const bool inside = y + dy >= 0 && y + dy < a.H && xx >= 0 && xx < W;
    const long long src = inside ? (row + dy) * W + xx : 0;
    fl[e] = inside ? round_to<T>(__ldg(a.flow + src)) : 0.f;
  }
  __syncthreads();

  // convc1 and convf1: item = (64 pixels, two a lane, 16 channels of one
  // conv), so that each weight load serves two pixels.
  unsigned char* out = reinterpret_cast<unsigned char*>(smem + lay.out);
  constexpr int kSlices = kMotionCh / mi::kSlice;  // 4 of convc1, then 4 of convf1
  const int items = (n_pix + 63) / 64 * kSlices;
  for (int it = t >> 5; it < items; it += blockDim.x >> 5) {
    const int px = it / kSlices * 64 + (t & 31);  // and px + 32
    // lanes past the segment compute a copy and store nothing
    const int pc[2] = {min(px, n_pix - 1), min(px + 32, n_pix - 1)};
    const int sl = it % kSlices;
    const int c0 = (sl % 4) * mi::kSlice;  // the slice's first channel in its conv
    float o[2][mi::kSlice];
#pragma unroll
    for (int e = 0; e < mi::kSlice; ++e) o[0][e] = o[1][e] = 0.f;
    if (sl < 4) {
      const float* tp0 = taps + pc[0] * lay.tap_ld;
      const float* tp1 = taps + pc[1] * lay.tap_ld;
      for (int k = 0; k < lk; ++k) fma_slice(tp0[k], tp1[k], w1 + k * 64 + c0, o);
    } else {
      for (int dy = 0; dy < 7; ++dy) {
        const float* row0 = fl + dy * lay.flow_ld + pc[0];
        const float* row1 = fl + dy * lay.flow_ld + pc[1];
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          fma_slice(row0[dx], row1[dx], w7 + (dy * 7 + dx) * 64 + c0, o);
        }
      }
    }
    const float* bias = (sl < 4 ? a.bc1 : a.bf7) + c0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < mi::kSlice; ++e) o[h][e] = fmaxf(o[h][e] + bias[e], 0.f);
      if (px + 32 * h < n_pix) {
        store_slice(reinterpret_cast<T*>(out + (px + 32 * h) * lay.out_ld) + (sl < 4 ? 0 : 64) + c0,
                    o[h]);
      }
    }
  }
  __syncthreads();

  // The tile to cf, 16 bytes a thread.
  constexpr int kPieces = kMotionCh * (int)sizeof(T) / 16;  // a row's 16-byte pieces
  uint4* dst = reinterpret_cast<uint4*>(static_cast<T*>(a.cf) + (row * W + seg0) * kMotionCh);
  for (int e = t; e < n_pix * kPieces; e += blockDim.x) {
    const int r = e / kPieces;
    dst[e] = *reinterpret_cast<const uint4*>(out + r * lay.out_ld + (e - r * kPieces) * 16);
  }
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
// The flow head's conv2, x channel only ("project, then shift-add"):
//
//   delta[y, x] = b2 + sum over taps (ky, kx), channels c of
//                 fh1[y + ky - 1, x + kx - 1, c] * k2[3 ky + kx, c]
//
// with zeros outside the image. What bounds it is reading fh1 once (16.7
// MB in bf16 at the slice shape, 5 us at 3.35 TB/s); its 2304 FMAs a pixel
// take about as long. The one-warp-a-pixel kernel it replaces read each
// fh1 byte from L2 nine times (once for every window that covers it) in
// 2-byte loads, and each weight from global memory for every pixel.
// Here a block owns an 8 x 32 output tile of one image and first projects
// each of the 10 x 34 pixels of its halo onto the 9 taps: t[tap][pixel] =
// sum_c fh1[pixel, c] * k2[tap, c], four lanes a pixel (lane j of a quad
// loads channels 8 (j + 4 i) .. + 7 for i = 0..7 in 16-byte ld.global.nc
// vectors, 64 contiguous bytes a quad and load), the weights converted to
// fp32 in shared memory once a block, the quad's partial sums reduced by
// two shuffles. So each fh1 byte is read 340 / 256 = 1.33 times, and the
// 16-byte load count falls about 100x. Then each thread adds its pixel's 9
// taps from shared memory (delta = sum_tap t[tap][pixel + shift(tap)]).
// Sums in a fixed order (a lane's channels ascending, the quad by
// shuffles, the taps ascending, then b2), no atomics: bitwise repeatable.
namespace ho {
constexpr int kRows = 8, kCols = 32;                       // output tile
constexpr int kHaloRows = kRows + 2, kHaloCols = kCols + 2;
constexpr int kHalo = kHaloRows * kHaloCols;               // 340 halo pixels
constexpr int kThreads = kRows * kCols;                    // a thread an output pixel
constexpr int kQuad = 4;                                   // lanes a halo pixel
constexpr int kPixelsAWarp = 32 / kQuad;                   // halo pixels a warp a step
constexpr int kVecs = kHeadCh / (8 * kQuad);               // 8-channel vectors a lane
}  // namespace ho

// Eight channels of T from 16-byte aligned global memory, through the
// read-only path; at(e) widens channel e to fp32 exactly.
template <typename T>
struct Vec8;
template <>
struct Vec8<bf16> {
  uint4 u;
  __device__ __forceinline__ void load(const bf16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float at(int e) const {
    const unsigned w = e < 2 ? u.x : e < 4 ? u.y : e < 6 ? u.z : u.w;
    return __uint_as_float(e % 2 ? w & 0xffff0000u : w << 16);
  }
};
template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float at(int e) const {
    const float4& v = e < 4 ? a : b;
    const int f = e % 4;
    return f == 0 ? v.x : f == 1 ? v.y : f == 2 ? v.z : v.w;
  }
};

template <typename T>
__global__ void __launch_bounds__(ho::kThreads, 2)
head_out_kernel(const T* __restrict__ fh1, const T* __restrict__ k2,
                const float* __restrict__ b2, float* __restrict__ delta, int B, int H, int W) {
  using namespace ho;
  __shared__ __align__(16) float w[9][kHeadCh];  // 9,216 bytes
  __shared__ float t[9][kHalo];                  // 12,240 bytes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (W + kCols - 1) / kCols, tiles_y = (H + kRows - 1) / kRows;
  const int x0 = (blockIdx.x % tiles_x) * kCols;
  const int y0 = (blockIdx.x / tiles_x % tiles_y) * kRows;
  const int b = blockIdx.x / tiles_x / tiles_y;
  for (int i = tid; i < 9 * kHeadCh; i += kThreads) w[i / kHeadCh][i % kHeadCh] = to_f(k2[i]);
  const float bias = b2[0];
  __syncthreads();

  // Phase A: t[tap][halo pixel], 8 halo pixels a warp a step.
  const int j = lane % kQuad;
  for (int base = warp * kPixelsAWarp; base < kHalo; base += kPixelsAWarp * (kThreads / 32)) {
    const int hp = base + lane / kQuad;
    const int hy = hp / kHaloCols, hx = hp % kHaloCols;
    const int y = y0 + hy - 1, x = x0 + hx - 1;
    const bool in_image = hp < kHalo && y >= 0 && y < H && x >= 0 && x < W;
    Vec8<T> v[kVecs] = {};
    if (in_image) {
      const T* src = fh1 + (((long long)b * H + y) * W + x) * kHeadCh + 8 * j;
#pragma unroll
      for (int i = 0; i < kVecs; ++i) v[i].load(src + 8 * kQuad * i);
    }
    float s[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) s[tap] = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int c = 8 * (j + kQuad * i);
#pragma unroll
      for (int h = 0; h < 8; h += 4) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          // the 8 lanes that share j read one address: a broadcast
          const float4 wv = *reinterpret_cast<const float4*>(&w[tap][c + h]);
          s[tap] = fmaf(v[i].at(h), wv.x, s[tap]);
          s[tap] = fmaf(v[i].at(h + 1), wv.y, s[tap]);
          s[tap] = fmaf(v[i].at(h + 2), wv.z, s[tap]);
          s[tap] = fmaf(v[i].at(h + 3), wv.w, s[tap]);
        }
      }
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      s[tap] += __shfl_xor_sync(0xffffffffu, s[tap], 1);
      s[tap] += __shfl_xor_sync(0xffffffffu, s[tap], 2);
    }
    if (j == 0 && hp < kHalo) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) t[tap][hp] = in_image ? s[tap] : 0.f;
    }
  }
  __syncthreads();

  // Phase B: each thread's pixel from its 3 x 3 window of t.
  const int ty = tid / kCols, tx = tid % kCols;
  const int y = y0 + ty, x = x0 + tx;
  float acc = 0.f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) acc += t[3 * ky + kx][(ty + ky) * kHaloCols + tx + kx];
  }
  if (y < H && x < W) delta[((long long)b * H + y) * W + x] = acc + bias;
}

// Stage 7 over B images of H x W: one block an output tile, x fastest.
template <typename T>
cudaError_t head_out(const void* fh1, const void* k2, const float* b2, float* delta, int B, int H,
                     int W, cudaStream_t st) {
  const long long blocks = (long long)B * ((H + ho::kRows - 1) / ho::kRows) *
                           ((W + ho::kCols - 1) / ho::kCols);
  if (B < 1 || H < 1 || W < 1 || (long long)B * H * W > (1LL << 30) || blocks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  head_out_kernel<T><<<(unsigned)blocks, ho::kThreads, 0, st>>>(
      static_cast<const T*>(fh1), static_cast<const T*>(k2), b2, delta, B, H, W);
  return cudaGetLastError();
}

// Stage 1's launch geometry (ops/fused_update.py::motion_in_geometry).
struct Geometry {
  int seg, threads, dc, smem;
};

template <typename T, int DC, int R>
cudaError_t launch_motion_in(const MotionIn& a, float inv_sqrt_d, unsigned blocks, int threads,
                             int smem, cudaStream_t st) {
  static bool attr_set = false;  // above 48 KB only after opting in
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        motion_in_kernel<T, DC, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, mi::kMaxSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(motion_in_kernel<T, DC, R>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  motion_in_kernel<T, DC, R><<<blocks, threads, smem, st>>>(a, inv_sqrt_d);
  return cudaGetLastError();
}

template <typename T, int DC>
cudaError_t launch_motion_in_dc(int radius, const MotionIn& a, float inv_sqrt_d, unsigned blocks,
                                int threads, int smem, cudaStream_t st) {
  switch (radius) {
#define MOTION_IN_CASE(R) \
  case R:                 \
    return launch_motion_in<T, DC, R>(a, inv_sqrt_d, blocks, threads, smem, st);
    MOTION_IN_CASE(1)
    MOTION_IN_CASE(2)
    MOTION_IN_CASE(3)
    MOTION_IN_CASE(4)
#undef MOTION_IN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// Stage 1 over ``rows`` image rows, after checking that the geometry covers
// the rows: every (level, pixel) pair a thread, two stages of the staged
// rows and the conv phase's tiles within the shared memory.
template <typename T>
cudaError_t motion_in(MotionIn a, int rows, int radius, const Geometry& g, cudaStream_t st) {
  int staged = g.seg;
  for (int l = 0; l < a.levels; ++l) staged += a.pyr.w2[l];
  const mi::Layout lay(g.seg, a.levels * (2 * radius + 1), (int)sizeof(T));
  if (g.seg < 1 || (long long)g.seg * a.levels > g.threads || g.threads > mi::kMaxThreads ||
      g.threads % 32 != 0 || g.smem > mi::kMaxSmem || 8LL * staged * g.dc > g.smem ||
      4LL * lay.floats > g.smem) {
    return cudaErrorInvalidValue;
  }
  a.seg = g.seg;
  a.n_seg = (a.W + g.seg - 1) / g.seg;
  const long long blocks = (long long)rows * a.n_seg;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float inv_sqrt_d = 1.0f / sqrtf((float)a.D);
  const unsigned nb = (unsigned)blocks;
  switch (g.dc) {
#define MOTION_IN_DC(DC) \
  case DC:               \
    return launch_motion_in_dc<T, DC>(radius, a, inv_sqrt_d, nb, g.threads, g.smem, st);
    MOTION_IN_DC(4)
    MOTION_IN_DC(8)
    MOTION_IN_DC(16)
    MOTION_IN_DC(32)
#undef MOTION_IN_DC
    default:
      return cudaErrorInvalidValue;
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
int step(const void* const* ptrs, const MotionIn& mi_args, int B, int H, int W, int radius, int dh,
         int inp_ch, const Geometry& geo, cudaStream_t st) {
  const int P = B * H * W;
  auto fp = [&](Slot s) { return static_cast<const float*>(ptrs[s]); };
  cudaError_t err;

  // 1. lookup + convc1 + relu, convf1 + relu -> cf = cor|flo
  if ((err = motion_in<T>(mi_args, B * H, radius, geo, st)) != cudaSuccess) return (int)err;

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
  return (int)head_out<T>(ptrs[kFh1], ptrs[kKfh2], fp(kBfh2),
                          static_cast<float*>(const_cast<void*>(ptrs[kDelta])), B, H, W, st);
}

// Stage 1's arguments, or false where the shapes are outside the kernel's
// range. f2_levels / widths are host arrays of ``levels`` entries.
bool motion_in_args(const void* f1, const void* const* f2_levels, const int* widths, int levels,
                    const void* flow, const void* wc1, const void* bc1, const void* kf7,
                    const void* bf7, void* cf, int B, int H, int W, int D, int radius,
                    MotionIn* a) {
  if (levels < 1 || levels > kMaxLevels || D < 4 || D % 4 != 0 || D > 512 || radius < 1 ||
      radius > 4 || B < 1 || H < 1 || W < 1 || (long long)B * H * W > (1LL << 30)) {
    return false;
  }
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < levels && widths[l] < 1) return false;
    a->pyr.f2[l] = l < levels ? static_cast<const float*>(f2_levels[l]) : nullptr;
    a->pyr.w2[l] = l < levels ? widths[l] : 0;
  }
  a->f1 = static_cast<const float*>(f1);
  a->levels = levels;
  a->flow = static_cast<const float*>(flow);
  a->wc1 = wc1;
  a->bc1 = static_cast<const float*>(bc1);
  a->kf7 = kf7;
  a->bf7 = static_cast<const float*>(bf7);
  a->cf = cf;
  a->H = H;
  a->W = W;
  a->D = D;
  return true;
}

}  // namespace

// One refinement step. ``ptrs`` holds kSlots device pointers in Slot order
// (ptrs[kInp] is null when inp_ch == 0); f2_levels / widths are host arrays
// of ``levels`` entries. Every buffer is contiguous and 16-byte aligned
// (the wrapper checks): f1, the pyramid, flow, the biases, z and delta in
// fp32, everything else in the compute type (bf16 when ``use_bf16`` is 1).
// seg (pixels a segment), threads (a block), dc (channels a chunk) and smem
// (dynamic shared memory a block, bytes) are stage 1's geometry, from
// ops/fused_update.py::motion_in_geometry.
extern "C" int fused_update_step(int use_bf16, const void* const* ptrs, const void* const* f2_levels,
                                 const int* widths, int levels, int B, int H, int W, int D,
                                 int radius, int dh, int inp_ch, int seg, int threads, int dc,
                                 int smem, void* stream) {
  MotionIn a;
  if (!motion_in_args(ptrs[kF1], f2_levels, widths, levels, ptrs[kFlow], ptrs[kWc1], ptrs[kBc1],
                      ptrs[kKf7], ptrs[kBf7], const_cast<void*>(ptrs[kCf]), B, H, W, D, radius,
                      &a) ||
      dh < BN || dh % BN != 0 || inp_ch < 0 || inp_ch % BK != 0 ||
      (inp_ch > 0) != (ptrs[kInp] != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g{seg, threads, dc, smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_bf16) return step<bf16>(ptrs, a, B, H, W, radius, dh, inp_ch, g, st);
  return step<float>(ptrs, a, B, H, W, radius, dh, inp_ch, g, st);
}

// Stage 1 alone: cor|flo [B*H*W][128] into ``cf`` from f1, the pyramid,
// the x-flow and convc1's and convf1's weights, with fused_update_step's
// buffers, types and geometry.
extern "C" int fused_motion_in(int use_bf16, const void* f1, const void* const* f2_levels,
                               const int* widths, int levels, const void* flow, const void* wc1,
                               const void* bc1, const void* kf7, const void* bf7, void* cf,
                               int B, int H, int W, int D, int radius, int seg, int threads,
                               int dc, int smem, void* stream) {
  MotionIn a;
  if (!motion_in_args(f1, f2_levels, widths, levels, flow, wc1, bc1, kf7, bf7, cf, B, H, W, D,
                      radius, &a)) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g{seg, threads, dc, smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = use_bf16 ? motion_in<bf16>(a, B * H, radius, g, st)
                                   : motion_in<float>(a, B * H, radius, g, st);
  return (int)err;
}

// Stage 7 alone: delta [B*H*W] (fp32) from fh1 [B*H*W][256] and the flow
// head conv2's x weights kfh2 [9][256], both in the compute type, and its
// bias bfh2 [1] (fp32), with fused_update_step's buffers and types.
extern "C" int fused_head_out(int use_bf16, const void* fh1, const void* kfh2, const void* bfh2,
                              void* delta, int B, int H, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b2 = static_cast<const float*>(bfh2);
  float* out = static_cast<float*>(delta);
  const cudaError_t err = use_bf16 ? head_out<bf16>(fh1, kfh2, b2, out, B, H, W, st)
                                   : head_out<float>(fh1, kfh2, b2, out, B, H, W, st);
  return (int)err;
}

// The number of pointer slots fused_update_step reads, for the wrapper's check.
extern "C" int fused_update_slots() { return kSlots; }

// Dynamic shared memory of the bf16 conv kernel at n output channels a
// block (64, 128 or 256), for the build report.
extern "C" int fused_update_conv_smem(int n) {
  return n == 256 ? tc::smem_bytes<256>() : n == 128 ? tc::smem_bytes<128>() : tc::smem_bytes<64>();
}
