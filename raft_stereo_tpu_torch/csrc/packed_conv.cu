// 3x3 stride-1 SAME conv, 64 -> 64 channels, no bias, with an optional
// per-(batch, lane) affine + relu prologue, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// raft_stereo_tpu/experiments/pallas_packed_conv.py::_kernel, which runs
// the full-resolution C=64 encoder stage's convs (layer1) on the
// phase-packed layout [B, H, W/2, 128], lane = (w parity, channel). That
// layout is a pure reshape of NHWC [B, H, W, 64], so this kernel reads and
// writes NHWC rows; the packing was a 128-lane trick of the TPU and the
// weight stays the conv's own [3, 3, cin, cout], passed tap-major as
// [9][64][64]. It computes
//
//   out = conv3x3(pad0(prologue(x)), w)      prologue(x) = relu?(x * s + t)
//
// where s and t are [B, 128] in the input type T, indexed by the column's
// parity (lane = (x & 1) * 64 + c), and pad0 puts the SAME padding's zeros
// around the image after the prologue: out-of-image taps read zero even
// when t > 0. Rounding points, those of the plain version
// (experiments/packed_conv.py::packed_conv3x3_plain): x * s rounded to T,
// + t rounded to T, relu; products of T operands summed in fp32 and the
// output rounded once to T.
//
// Bound on an H100 SXM at the encoder shape (B=2, 272x480, bf16): 19.2
// GFLOP (19 us at the bf16 tensor-core rate) against 66.9 MB of input and
// output (20 us at 3.35 TB/s), so bf16 sits on the boundary; fp32 (FMA,
// never TF32) is bound by arithmetic at 0.29 ms.
//
// bf16 design (conv3x3_sm90.cuh holds the mainloop it shares with K2's
// convs). What bounds it: at 64 output channels every product is
// m64n64k16, whose operands (2 KB of A and 2 KB of B a product) come from
// shared memory at about the rate the tensor cores consume them, and the
// input and output bytes alone take 20 us. So the design moves no byte
// twice that it need not:
//  - persistent blocks, one an SM (211 KB of shared memory), whose 2
//    warpgroups each walk their own 8 x 16-pixel output tiles (W = 480
//    and H = 272 split into whole tiles; halo overhead 10 x 18 / 128 =
//    1.41) and synchronise only among themselves (named barriers), so one
//    warpgroup's copies and epilogue overlap the other's products;
//  - the 9 x 64 x 64 weights loaded into shared memory once a block, in
//    the layout wgmma reads B from;
//  - each tile's input halo copied by TMA over a 4-D NHWC tensor map,
//    whose zero fill outside the image is the SAME padding, into one of its
//    warpgroup's three buffers, two tiles ahead (the 128-byte swizzle keeps
//    ldmatrix free of bank conflicts); the prologue then runs in place on
//    the in-image pixels;
//  - a tile's two 64-pixel row blocks: all 9 taps on wgmma with A from
//    registers (ldmatrix at the tap's shift), the next tap's ldmatrix
//    overlapping this tap's products;
//  - the epilogue from the accumulators to 16-byte bf16 stores.
// What still holds it back (PERF.md): operand traffic in shared memory
// (ldmatrix for A and wgmma's reads of B, both 2 KB a product at N = 64)
// and the warpgroups' phases that do not overlap.
//
// fp32 (FMA, the parity phases' type) keeps its first design: a block owns
// 1 output row x 64 columns, copies its (1+2) x 66-pixel halo once with
// cp.async, and streams tap t's weight slab through two stages, 128
// threads each 8 pixels x 4 channels.
//
// Interface: plain C, loaded with ctypes. ``packed_conv3x3`` launches one
// kernel on the given stream and returns cudaGetLastError(). The wrapper
// allocates the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv3x3_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 64;       // input and output channels
constexpr int TW = 64;      // output columns a tile
constexpr int HC = TW + 2;  // halo columns

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// v rounded to T and widened again: a rounding point of the plain version.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

template <typename T>
struct Cfg;

template <>
struct Cfg<float> {
  static constexpr int TH = 1;
  static constexpr int kThreads = 128;  // 8 x 16: 8 pixels x 4 channels each
  static constexpr int CP = 68;
  static constexpr int WLD = 68;
  static constexpr int CLD = 0;         // results go out from registers
};

template <typename T>
struct Smem {
  using G = Cfg<T>;
  static constexpr int HR = G::TH + 2;
  static constexpr int VEC = 16 / sizeof(T);  // elements in a 16-byte chunk
  static constexpr int HALO = HR * HC * G::CP * sizeof(T);
  static constexpr int WST = C * G::WLD * sizeof(T);  // one weight stage
  static constexpr int TILE = G::TH * TW * G::CLD * 4;  // fp32 result tile, over the rest
  static constexpr int BYTES = HALO + 2 * WST > TILE ? HALO + 2 * WST : TILE;
};

struct Args {
  const void* x;      // [B][H][W][64] in T
  const void* w;      // [9][64 cin][64 cout] in T
  const void* scale;  // [B][128] in T, or null: no prologue
  const void* shift;  // [B][128] in T
  int relu;
  void* out;          // [B][H][W][64] in T
  int H, W;
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

// The block's fp32 product over one tap: halo rows/columns shifted by
// (dy, dx), weight slab ``w`` [64][WLD].
template <typename T>
struct Mma;

// fp32: FMA, thread (ty, tx) owns pixels 8 ty .. 8 ty + 7 and output
// channels 4 tx .. 4 tx + 3 of the one-row tile.
template <>
struct Mma<float> {
  using G = Cfg<float>;
  float acc[8][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  __device__ void tap(const float* halo, const float* w, int dy, int dx) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const float* a = halo + (dy * HC + ty * 8 + dx) * G::CP;
#pragma unroll 8
    for (int k = 0; k < C; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(w + k * G::WLD + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = a[i * G::CP + k];
        acc[i][0] = fmaf(av, bv.x, acc[i][0]);
        acc[i][1] = fmaf(av, bv.y, acc[i][1]);
        acc[i][2] = fmaf(av, bv.z, acc[i][2]);
        acc[i][3] = fmaf(av, bv.w, acc[i][3]);
      }
    }
  }
  __device__ void store(unsigned char*, float* out, int H, int W, int b, int y0, int x0) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    if (y0 >= H) return;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int xx = x0 + ty * 8 + i;
      if (xx >= W) break;
      *reinterpret_cast<float4*>(out + (((long long)b * H + y0) * W + xx) * C + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(Cfg<T>::kThreads) packed_conv_kernel(const Args args) {
  using G = Cfg<T>;
  using S = Smem<T>;
  constexpr int VEC = S::VEC;
  constexpr int CPP = C / VEC;  // chunks a pixel
  extern __shared__ __align__(128) unsigned char smem[];
  T* halo = reinterpret_cast<T*>(smem);
  T* wst = reinterpret_cast<T*>(smem + S::HALO);

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * G::TH, x0 = blockIdx.x * TW;
  const int H = args.H, W = args.W;
  const T* x = static_cast<const T*>(args.x);
  const T* wg = static_cast<const T*>(args.w);

  // The halo's chunk idx: pixel (hr, hc) of the halo, channels ch..ch+VEC.
  auto halo_pos = [&](int idx, int& hr, int& hc, int& ch) {
    const int pix = idx / CPP;
    ch = (idx - pix * CPP) * VEC;
    hr = pix / HC;
    hc = pix - hr * HC;
  };
  for (int idx = tid; idx < S::HR * HC * CPP; idx += G::kThreads) {
    int hr, hc, ch;
    halo_pos(idx, hr, hc, ch);
    const int yy = y0 - 1 + hr, xx = x0 - 1 + hc;
    const bool valid = yy >= 0 && yy < H && xx >= 0 && xx < W;
    const T* src = valid ? x + (((long long)b * H + yy) * W + xx) * C + ch : x;
    cp_async16(halo + (hr * HC + hc) * G::CP + ch, src, valid);
  }
  // Starts the copy of tap t's weight slab into stage st.
  auto load_w = [&](int st, int t) {
    for (int idx = tid; idx < C * CPP; idx += G::kThreads) {
      const int r = idx / CPP, col = (idx - r * CPP) * VEC;
      cp_async16(wst + st * C * G::WLD + r * G::WLD + col, wg + ((long long)t * C + r) * C + col,
                 true);
    }
  };
  load_w(0, 0);
  cp_async_commit();  // group 0: the halo and tap 0

  Mma<T> mma;
  mma.zero();
  for (int t = 0; t < 9; ++t) {
    if (t + 1 < 9) load_w((t + 1) & 1, t + 1);
    cp_async_commit();  // an empty group on the last tap keeps the count
    cp_async_wait_prev();
    if (t == 0 && args.scale != nullptr) {
      // The prologue, on the chunks this thread copied (they have landed),
      // at in-image pixels only: the zero padding stays zero.
      const T* sc = static_cast<const T*>(args.scale) + b * 2 * C;
      const T* sh = static_cast<const T*>(args.shift) + b * 2 * C;
      for (int idx = tid; idx < S::HR * HC * CPP; idx += G::kThreads) {
        int hr, hc, ch;
        halo_pos(idx, hr, hc, ch);
        const int yy = y0 - 1 + hr, xx = x0 - 1 + hc;
        if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;  // padding: no prologue
        T* v = halo + (hr * HC + hc) * G::CP + ch;
        const int lane = (xx & 1) * C + ch;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float u = round_to<T>(__fmul_rn(to_f(v[e]), to_f(sc[lane + e])));
          u = round_to<T>(__fadd_rn(u, to_f(sh[lane + e])));
          if (args.relu) u = fmaxf(u, 0.f);
          v[e] = from_f<T>(u);
        }
      }
    }
    __syncthreads();
    mma.tap(halo, wst + (t & 1) * C * G::WLD, t / 3, t % 3);
    __syncthreads();  // the next tap's copy overwrites this stage
  }
  mma.store(smem, static_cast<T*>(args.out), H, W, b, y0, x0);
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  using G = Cfg<T>;
  static bool attr_set = false;  // above 48 KB only after opting in
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T>::BYTES);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((unsigned)((a.W + TW - 1) / TW), (unsigned)((a.H + G::TH - 1) / G::TH),
                  (unsigned)B);
  packed_conv_kernel<T><<<grid, G::kThreads, Smem<T>::BYTES, st>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------------------- bf16
namespace k3 {
constexpr int kTileH = 8, kTileW = 16;                   // a warpgroup's output tile
constexpr int kHaloH = kTileH + 2, kHaloW = kTileW + 2;  // its halo
constexpr int kThreads = 256;  // 2 warpgroups, each its own tiles
constexpr int MB = 2;          // 64-pixel row blocks a tile
constexpr int kSlab = C * C * 2;     // one tap's weights (bytes)
constexpr int kLbo = C * 128;        // B's N-neighbouring atoms (one N block: unused)
constexpr int kWeights = 9 * kSlab;
constexpr int kHaloBytes = kHaloH * kHaloW * C * 2;        // what TMA writes
constexpr int kHalo = (kHaloBytes + 1023) / 1024 * 1024;  // a buffer, 1024-aligned
constexpr int kHalos = 3;  // halo buffers a warpgroup: this tile's and the next two tiles'
// the weights, the halos, an mbarrier a halo buffer and the slack to align
constexpr int kSmem = kWeights + 2 * kHalos * kHalo + 2 * kHalos * 8 + 1024;
}  // namespace k3

// A barrier of one warpgroup's 128 threads (id 1 or 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wgp) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgp) : "memory");
}

// Persistent: warpgroup g of block i takes tiles 2i + g, 2i + g + 2
// gridDim.x, ... of the B x tiles_y x tiles_x output tiles, each on its
// own halo buffers and barriers, so one warpgroup's copies and epilogue
// overlap the other's products. xmap: x as a 4-D TMA tensor map
// [B][H][W][64] with (10, 18, 64) boxes, the 128-byte swizzle and zeros
// outside the image: a box at (x0 - 1, y0 - 1) is a tile's halo with its
// SAME padding.
__global__ void __launch_bounds__(k3::kThreads, 1)
packed_conv_sm90(const Args args, int tiles_x, int tiles_y, int n_tiles,
                 const __grid_constant__ CUtensorMap xmap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_w = (sm90::smem_addr(smem) + 1023) & ~1023u;  // atoms 1024-aligned
  const int tid = threadIdx.x;
  const int wgp = tid >> 7, wtid = tid & 127;
  const uint32_t s_halo = s_w + k3::kWeights + wgp * k3::kHalos * k3::kHalo;
  const uint32_t s_bar = s_w + k3::kWeights + 2 * k3::kHalos * k3::kHalo + wgp * k3::kHalos * 8;
  const int H = args.H, W = args.W;
  const bf16* wg = static_cast<const bf16*>(args.w);

  if (tid == 0) {
    for (int i = 0; i < 2 * k3::kHalos; ++i)
      sm90::mbar_init(s_w + k3::kWeights + 2 * k3::kHalos * k3::kHalo + i * 8, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  // The weights, once: row (tap, cin k) of 64 cout is one swizzled row.
  for (int i = tid; i < 9 * C * 8; i += k3::kThreads) {
    const int n8 = i & 7, k = (i >> 3) & (C - 1), t = i >> 9;
    sm90::cp_async16(s_w + t * k3::kSlab + sm90::b_chunk(k, n8, k3::kLbo),
                     wg + (t * C + k) * C + n8 * 8, true);
  }
  sm90::cp_async_commit();
  auto tile_pos = [&](int tile, int& b, int& y0, int& x0) {
    x0 = (tile % tiles_x) * k3::kTileW;
    const int r = tile / tiles_x;
    y0 = (r % tiles_y) * k3::kTileH;
    b = r / tiles_y;
  };
  // Starts the TMA copy of a tile's halo into buffer i (none past the last
  // tile), once the warpgroup is done with the buffer.
  auto load_halo = [&](int tile, int i) {
    if (wtid != 0 || tile >= n_tiles) return;
    int b, y0, x0;
    tile_pos(tile, b, y0, x0);
    sm90::mbar_expect_tx(s_bar + i * 8, k3::kHaloBytes);
    sm90::tma_load_4d(s_halo + i * k3::kHalo, &xmap, 0, x0 - 1, y0 - 1, b, s_bar + i * 8);
  };
  const int stride = 2 * gridDim.x;
  int tile = 2 * blockIdx.x + wgp;
  load_halo(tile, 0);
  load_halo(tile + stride, 1);
  sm90::cp_async_wait<0>();  // this thread's weight copies landed
  sm90::fence_proxy_async();
  __syncthreads();  // and every thread's

  // This lane's ldmatrix row (a halo pixel at tap (0, 0)) in each of the
  // tile's row blocks.
  int prow[k3::MB];
#pragma unroll
  for (int m = 0; m < k3::MB; ++m) {
    const int pm = m * 64 + sm90::a_row();
    prow[m] = (pm / k3::kTileW) * k3::kHaloW + pm % k3::kTileW;
  }

  for (int j = 0; tile < n_tiles; tile += stride, ++j) {
    // The warpgroup is done with the buffer the next copy fills; the fence
    // orders its reads and the prologue's writes there before that copy.
    sm90::fence_proxy_async();
    wg_sync(wgp);
    load_halo(tile + 2 * stride, (j + 2) % k3::kHalos);
    const int buf = j % k3::kHalos;
    sm90::mbar_wait(s_bar + buf * 8, (j / k3::kHalos) & 1);  // this tile's halo landed
    int b, y0, x0;
    tile_pos(tile, b, y0, x0);
    const uint32_t cur = s_halo + buf * k3::kHalo;
    if (args.scale != nullptr) {
      // The prologue in place, at in-image pixels only.
      const bf16* sc = static_cast<const bf16*>(args.scale) + b * 2 * C;
      const bf16* sh = static_cast<const bf16*>(args.shift) + b * 2 * C;
      unsigned char* halo = smem + (cur - sm90::smem_addr(smem));
      for (int i = wtid; i < k3::kHaloH * k3::kHaloW * 8; i += 128) {
        const int px = i >> 3, c8 = i & 7, ch = c8 * 8;
        const int yy = y0 - 1 + px / k3::kHaloW, xx = x0 - 1 + px % k3::kHaloW;
        if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;  // the SAME padding stays zero
        bf16* v = reinterpret_cast<bf16*>(halo + px * 128 + ((c8 ^ (px & 7)) << 4));
        const int lane = (xx & 1) * C + ch;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float u = round_to<bf16>(__fmul_rn(__bfloat162float(v[e]), __bfloat162float(sc[lane + e])));
          u = round_to<bf16>(__fadd_rn(u, __bfloat162float(sh[lane + e])));
          if (args.relu) u = fmaxf(u, 0.f);
          v[e] = __float2bfloat16(u);
        }
      }
      wg_sync(wgp);
    }
    float acc[k3::MB][C / 2];
#pragma unroll
    for (int m = 0; m < k3::MB; ++m)
#pragma unroll
      for (int i = 0; i < C / 2; ++i) acc[m][i] = 0.f;
    sm90::conv9<C, k3::MB, 4>(
        acc,
        [&](uint32_t (&a)[k3::MB][4][4], int t) {
          sm90::load_a_swz(a, cur, prow, (t / 3) * k3::kHaloW + t % 3);
        },
        s_w, k3::kSlab, k3::kLbo);

    bf16* out = static_cast<bf16*>(args.out);
#pragma unroll
    for (int m = 0; m < k3::MB; ++m) {
      sm90::for_each_8<C>(acc[m], [&](int r, int c, const float (&v)[8]) {
        const int pm = m * 64 + r;
        const int yy = y0 + pm / k3::kTileW, xx = x0 + pm % k3::kTileW;
        if (yy < H && xx < W) sm90::store8(out + (((long long)b * H + yy) * W + xx) * C + c, v);
      });
    }
  }
}

// x [B][H][W][64] bf16 as a TMA tensor map with one tile's halo a box
// (sm90::tensor_map_encoder).
cudaError_t halo_map(const Args& a, int B, CUtensorMap* map) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  const cudaError_t err = sm90::tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)a.W, (cuuint64_t)a.H, (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)C * sizeof(bf16);
  const cuuint64_t strides[3] = {row, row * a.W, row * a.W * a.H};
  const cuuint32_t box[4] = {(cuuint32_t)C, (cuuint32_t)k3::kHaloW, (cuuint32_t)k3::kHaloH, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(a.x), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch_bf16(const Args& a, int B, cudaStream_t st) {
  static int n_sm = 0;
  if (n_sm == 0) {  // above 48 KB only after opting in
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(packed_conv_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 k3::kSmem);
    if (err != cudaSuccess) {
      n_sm = 0;
      return err;
    }
  }
  CUtensorMap xmap;
  const cudaError_t err = halo_map(a, B, &xmap);
  if (err != cudaSuccess) return err;
  const int tiles_x = (a.W + k3::kTileW - 1) / k3::kTileW;
  const int tiles_y = (a.H + k3::kTileH - 1) / k3::kTileH;
  const int n_tiles = B * tiles_x * tiles_y;
  const int pairs = (n_tiles + 1) / 2;  // two warpgroups a block
  const int grid = pairs < n_sm ? pairs : n_sm;
  packed_conv_sm90<<<grid, k3::kThreads, k3::kSmem, st>>>(a, tiles_x, tiles_y, n_tiles, xmap);
  return cudaGetLastError();
}

}  // namespace

// One conv. x and out are NHWC [B][H][W][64], w is [9][64][64] (tap-major,
// then input, then output channel), scale and shift are [B][128] or both
// null; all in bf16 when ``use_bf16`` is 1, else fp32; every pointer
// 16-byte aligned (the wrapper checks).
extern "C" int packed_conv3x3(int use_bf16, const void* x, const void* w, const void* scale,
                              const void* shift, int relu, void* out, int B, int H, int W,
                              void* stream) {
  if (B < 1 || H < 1 || W < 1 || B > 65535 || (scale == nullptr) != (shift == nullptr) ||
      (long long)B * H * W > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x, w, scale, shift, relu, out, H, W};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_bf16) return (int)launch_bf16(a, B, st);
  return (int)launch<float>(a, B, st);
}

// Dynamic shared memory of the bf16 kernel, for the build report.
extern "C" int packed_conv_smem() { return k3::kSmem; }
