// The mainloop of the port's bf16 3x3 SAME convolutions on Hopper
// (sm_90a), shared by K3 (packed_conv.cu) and K2's five conv launches
// (fused_update.cu).
//
// Both are NHWC implicit GEMMs. A block owns a spatial tile of output
// pixels. The tile's input halo, a (rows + 2) x (cols + 2) patch of one
// chunk of at most 64 input channels (zero outside the image), sits in
// shared memory once and all 9 taps read it at their shift (dy, dx):
// M = the tile's pixels, N = output channels, K = the chunk's channels.
//
// - Products run on wgmma.mma_async m64nNk16 (bf16 operands, fp32
//   accumulate), one warpgroup a 64-row block. A comes from registers:
//   ldmatrix.x4 reads each warp's 16 pixel rows out of the halo at the
//   tap's shift, so a shifted window needs no realignment (a shared-memory
//   descriptor would need its rows at a fixed 16-byte pitch). The 8 rows
//   an ldmatrix phase reads sit in distinct banks: K2's halo has a pitch of
//   kHaloPitch bytes a pixel, K3's the 128-byte swizzle TMA writes.
// - B (the weights) is read by wgmma from shared memory through a matrix
//   descriptor, N contiguous (trans-b), in the 128-byte swizzle: atoms of
//   8 K-rows x 64 N-values (1024 bytes, 1024-aligned), each row's eight
//   16-byte chunks XOR-ed with the row's index in the atom, so the tensor
//   cores read 8 rows without bank conflicts. K-neighbouring atoms are
//   kAtom bytes apart (SBO), N-neighbouring 64-wide blocks LBO bytes. A
//   16-byte piece [k][n .. n+7] of an HWIO weight row is one chunk, so a
//   slab is copied with no transpose: by TMA with the same swizzle (K2) or
//   16-byte cp.async (K3).
// - The epilogue reads the accumulators: the 4 lanes of a quad hold 8
//   consecutive channels of a pixel between them, and a shuffle transpose
//   gives each lane all 8, for 16-byte stores.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kHaloPitch = 144;  // bytes a halo pixel: 64 bf16 and 16 bytes of pad
constexpr int kAtom = 1024;      // bytes of a 128-byte-swizzle atom: 8 rows x 128 bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that does not wait; zero-fills when
// ``valid`` is false (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's landed copies visible to wgmma's reads (the async
// proxy); a barrier then publishes them to the other threads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarriers in shared memory: init (one thread, then a fence and a
// barrier), and wait for the completion of the phase with the given
// parity (acquire).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrives and adds ``bytes`` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// TMA: the box at (x, y) of a 2-D tensor map into shared memory at dst,
// completing ``bar``'s transactions.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, int x, int y,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}
// TMA: the box at (c0, c1, c2, c3) of a 4-D tensor map (out-of-bounds
// elements read zero) into shared memory at dst, completing ``bar``'s
// transactions.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, int c0, int c1, int c2,
                                            int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an in-flight wgmma reads or writes: the compiler may
// neither reuse nor move them across this point.
template <int K>
__device__ __forceinline__ void keep(float (&v)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(v[i])::"memory");
}
template <int MB, int K>
__device__ __forceinline__ void keep(float (&v)[MB][K]) {
#pragma unroll
  for (int b = 0; b < MB; ++b) keep(v[b]);
}
template <int MB, int KS>
__device__ __forceinline__ void keep(uint32_t (&a)[MB][KS][4]) {
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[b][s][i])::"memory");
}

// Byte offset, in a B slab whose 64-wide N blocks are ``lbo`` bytes apart,
// of the 16-byte chunk holding K-row k, N-values 8 n8 .. 8 n8 + 7.
__device__ __forceinline__ uint32_t b_chunk(int k, int n8, uint32_t lbo) {
  return (n8 >> 3) * lbo + (k >> 3) * kAtom + (k & 7) * 128 + (((n8 ^ k) & 7) << 4);
}

// Matrix descriptor of a B operand at shared address ``addr`` (a 1024-byte
// aligned atom): 128-byte swizzle, LBO ``lbo``, SBO kAtom.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(kAtom >> 4) << 32) | (1ull << 62);
}

// d[64 x N] += a[64 x 16] (registers, this warp's 16 rows) x b[16 x N]
// (descriptor, N contiguous).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// This lane's ldmatrix.x4 row within its warp's 16-row share of a 64-row
// block (lanes 8m .. 8m+7 address matrix m: rows 0-7 | 8-15, channels
// 0-7 | 8-15), and the byte offset of its channel half.
__device__ __forceinline__ int a_row() {
  const int lane = threadIdx.x & 31;
  return 16 * ((threadIdx.x >> 5) & 3) + (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ uint32_t a_col_bytes() { return ((threadIdx.x & 31) >> 4) * 16; }

// Byte offset of tap t (dy = t / 3, dx = t % 3 in halo coordinates) in a
// halo ``halo_w`` pixels wide.
__device__ __forceinline__ uint32_t tap_shift(int t, int halo_w) {
  return static_cast<uint32_t>(((t / 3) * halo_w + t % 3) * kHaloPitch);
}

// The A fragments of one tap: for each of the warpgroup's MB 64-row blocks
// and each of the chunk's KS k16 steps, one ldmatrix.x4. row[b] is this
// lane's row address in block b at tap (0, 0).
template <int MB, int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[MB][KS][4], const uint32_t (&row)[MB],
                                       uint32_t shift) {
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int s = 0; s < KS; ++s) ldmatrix_x4(a[b][s], row[b] + shift + s * 32);
}

// Issues the products of one tap (not committed): acc[b] += A_b x slab
// over the first KUSE of the KS k16 steps loaded (K-row 16 s starts atom
// 2 s).
template <int N, int MB, int KS, int KUSE = KS>
__device__ __forceinline__ void mma_a(float (&acc)[MB][N / 2], const uint32_t (&a)[MB][KS][4],
                                      uint32_t slab, uint32_t lbo) {
#pragma unroll
  for (int s = 0; s < KUSE; ++s) {
    const uint64_t d = desc(slab + s * 2 * kAtom, lbo);
#pragma unroll
    for (int b = 0; b < MB; ++b) wgmma_rs<N>(acc[b], a[b][s], d);
  }
}

// A halo as TMA writes it with the 128-byte swizzle: pixel p's 64
// channels in the 128 bytes at p * 128, its 16-byte chunk c at
// (c ^ (p & 7)) * 16, so the 8 consecutive pixels an ldmatrix phase reads
// sit in distinct banks. The A fragments of one tap: block b's rows are
// halo pixels prow[b] + shift.
template <int MB, int KS>
__device__ __forceinline__ void load_a_swz(uint32_t (&a)[MB][KS][4], uint32_t halo,
                                           const int (&prow)[MB], int shift) {
  const int hi = (threadIdx.x & 31) >> 4;  // this lane's channel half
#pragma unroll
  for (int b = 0; b < MB; ++b) {
    const int p = prow[b] + shift;
    const uint32_t base = halo + p * 128;
#pragma unroll
    for (int s = 0; s < KS; ++s) ldmatrix_x4(a[b][s], base + (((2 * s + hi) ^ (p & 7)) << 4));
  }
}

// All 9 taps over one halo with the weights resident (9 slabs of
// ``slab_bytes``): load(a, t) fills a with tap t's A fragments, and the
// next tap's ldmatrix overlaps this tap's products. Returns with every
// product done.
template <int N, int MB, int KS, typename L>
__device__ __forceinline__ void conv9(float (&acc)[MB][N / 2], L&& load, uint32_t slabs,
                                      uint32_t slab_bytes, uint32_t lbo) {
  uint32_t a[2][MB][KS][4];
  load(a[0], 0);
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    keep(acc);
    wgmma_fence();
    mma_a<N, MB, KS>(acc, a[t & 1], slabs + t * slab_bytes, lbo);
    wgmma_commit();
    if (t < 8) {
      wgmma_wait<1>();  // tap t-1 is done with the registers tap t+1 loads into
      keep(a[(t + 1) & 1]);
      load(a[(t + 1) & 1], t + 1);
    }
  }
  wgmma_wait<0>();
  keep(acc);
  keep(a[0]);
  keep(a[1]);
}

// Lane q of a quad holds columns 2q, 2q+1 of four consecutive 8-column
// blocks (v[block][0..1]); on return out[0..7] are the 8 columns of block q.
__device__ __forceinline__ void quad_transpose(const float (&v)[4][2], float (&out)[8]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int blk = q ^ k;  // the block partner q^k wants from this lane
    float s0 = v[0][0], s1 = v[0][1];
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      if (blk == j) {
        s0 = v[j][0];
        s1 = v[j][1];
      }
    }
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, k);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (blk == j) {  // columns 2j, 2j+1 of block q came from lane j of the quad
        out[2 * j] = r0;
        out[2 * j + 1] = r1;
      }
    }
  }
}

// The epilogue walks N / 16 iterations it = 2 g + h a lane: row half h
// of the block's 16-row warp share, and group g of four 8-channel blocks,
// of which the lane takes block g·4 + (lane & 3) after the transpose.
// The iteration's row (0..63 of the 64-row block) and first channel:
__device__ __forceinline__ int epi_row(int it) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * (it & 1);
}
__device__ __forceinline__ int epi_col(int it) { return 8 * (4 * (it >> 1) + (threadIdx.x & 3)); }

// Iteration it's fp32 sums of channels epi_col(it) .. + 7 (it must be a
// compile-time constant after unrolling: it indexes registers).
template <int N>
__device__ __forceinline__ void take8(const float (&acc)[N / 2], int it, float (&out)[8]) {
  const int g = it >> 1, h = it & 1;
  float v[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j][0] = acc[4 * (4 * g + j) + 2 * h];
    v[j][1] = acc[4 * (4 * g + j) + 2 * h + 1];
  }
  quad_transpose(v, out);
}

// fn(row, col, v) for every iteration of this lane.
template <int N, typename F>
__device__ __forceinline__ void for_each_8(const float (&acc)[N / 2], F&& fn) {
#pragma unroll
  for (int it = 0; it < N / 16; ++it) {
    float out[8];
    take8<N>(acc, it, out);
    fn(epi_row(it), epi_col(it), out);
  }
}

// 8 fp32 values rounded to bf16, as one 16-byte store.
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162 p;
  p = __floats2bfloat162_rn(v[0], v[1]);
  u.x = *reinterpret_cast<uint32_t*>(&p);
  p = __floats2bfloat162_rn(v[2], v[3]);
  u.y = *reinterpret_cast<uint32_t*>(&p);
  p = __floats2bfloat162_rn(v[4], v[5]);
  u.z = *reinterpret_cast<uint32_t*>(&p);
  p = __floats2bfloat162_rn(v[6], v[7]);
  u.w = *reinterpret_cast<uint32_t*>(&p);
  *reinterpret_cast<uint4*>(dst) = u;
}

// 8 bf16 values (one 16-byte load), widened.
__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Host: cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint
// (no link to libcuda), for the kernels' TMA tensor maps.
inline cudaError_t tensor_map_encoder(PFN_cuTensorMapEncodeTiled_v12000* encode) {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  *encode = fn;
  return cudaSuccess;
}

}  // namespace sm90
