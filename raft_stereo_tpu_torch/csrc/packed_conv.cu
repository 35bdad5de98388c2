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
// Design (simple first; wgmma/TMA come later). A block owns a tile of TH
// output rows x 64 columns of one image. It copies the tile's input halo,
// (TH+2) x 66 pixels x 64 channels, into shared memory once with 16-byte
// cp.async copies (zero-filled outside the image), applies the prologue
// in place to the in-image pixels it copied, and then runs the 3x3 as an
// implicit GEMM over the 9 taps: M = the tile's pixels, N = 64 output
// channels, K = 64 input channels a tap. Tap t's 64x64 weight slab
// streams through two shared-memory stages, so the copy of tap t+1
// overlaps tap t's products. bf16 runs on the tensor cores through WMMA
// (fp32 accumulate; TH=4, 8 warps, each one output row x 32 channels); the
// halo's pixel pitch is 80 elements (160 bytes) so that an A fragment
// starting at any pixel shift stays 32-byte aligned. fp32 runs on the FMA
// units (TH=1, 128 threads, 8 pixels x 4 channels a thread).
//
// Interface: plain C, loaded with ctypes. ``packed_conv3x3`` launches one
// kernel on the given stream and returns cudaGetLastError(). The wrapper
// allocates the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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
struct Cfg<bf16> {
  static constexpr int TH = 4;          // output rows a tile
  static constexpr int kThreads = 256;  // 8 warps: 4 rows x 2 channel halves
  static constexpr int CP = 80;         // halo pixel pitch (elements)
  static constexpr int WLD = 72;        // weight slab row pitch
  static constexpr int CLD = 68;        // fp32 result tile row pitch
};

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

// bf16: WMMA 16x16x16 with fp32 accumulate. Warp (wm, wn) owns output row
// wm of the tile (64 pixels, 4 fragments) and channels 32 wn .. 32 wn + 31
// (2 fragments).
template <>
struct Mma<bf16> {
  using G = Cfg<bf16>;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[4][2];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
  }
  __device__ void tap(const bf16* halo, const bf16* w, int dy, int dx) {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 1, wn = warp & 1;
    const bf16* a = halo + ((wm + dy) * HC + dx) * G::CP;
#pragma unroll
    for (int kk = 0; kk < C; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(fa[i], a + i * 16 * G::CP + kk, G::CP);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], w + kk * G::WLD + wn * 32 + j * 16, G::WLD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  // Through an fp32 tile in shared memory (over the halo and weights,
  // which are no longer read), so each thread writes whole 16-byte chunks.
  __device__ void store(unsigned char* smem, bf16* out, int H, int W, int b, int y0, int x0) {
    float* c = reinterpret_cast<float*>(smem);
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(c + (wm * TW + i * 16) * G::CLD + wn * 32 + j * 16,
                                        acc[i][j], G::CLD, nvcuda::wmma::mem_row_major);
    __syncthreads();
    for (int idx = threadIdx.x; idx < G::TH * TW * (C / 8); idx += G::kThreads) {
      const int p = idx >> 3, ch = (idx & 7) * 8;
      const int yy = y0 + p / TW, xx = x0 + p % TW;
      if (yy >= H || xx >= W) continue;
      alignas(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(c[p * G::CLD + ch + e]);
      *reinterpret_cast<uint4*>(out + (((long long)b * H + yy) * W + xx) * C + ch) =
          *reinterpret_cast<const uint4*>(v);
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
  if (use_bf16) return (int)launch<bf16>(a, B, st);
  return (int)launch<float>(a, B, st);
}
