// Hopper (sm_90a) tile helpers of the flash backward passes
// (flash_attention.cu): cp.async copies into 128-byte-swizzled shared
// tiles, mbarriers and named barriers, the shared-memory matrix descriptors
// that wgmma reads the tiles through, and the three wgmma forms the passes
// issue (bf16 operands, f32 accumulators). Inline PTX only: no CUTLASS or
// CuTe headers, so nvcc builds the library in seconds.
//
// Tile layout. A (ROWS, D) bf16 tile of a (B, T, heads, D) view is stored
// as D / 64 "atoms" of ROWS x 64 elements, one after the other, each row
// of an atom 128 bytes; inside each 8-row, 1024-byte group the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8) (the 128-byte swizzle, which
// wgmma and TMA call SWIZZLE_128B). Every tile starts on a 1024-byte
// boundary. The same bytes serve both ways a product reads a tile:
// - K-major (the reduction runs along D): 8-row groups 1024 bytes apart
//   (the stride byte offset), a 16-wide k step moves 32 bytes inside the
//   atom and k >= 64 moves to the next atom;
// - MN-major (the reduction runs along the rows, as in dv += p^T dO): each
//   128-byte row is 64 consecutive N (= D) elements of one k, 8-row groups
//   1024 bytes apart (stride byte offset), the next 64 N elements one atom
//   (ROWS * 128 bytes, the leading byte offset) further; a 16-row k step
//   moves 2048 bytes.
//
// wgmma accumulator layout (m64nN, f32): warp w of the warpgroup holds rows
// 16w + g and 16w + g + 8 (g = lane / 4, t = lane % 4); element 4j + e is
// row 16w + g + 8 * (e / 2), column 8j + 2t + (e % 2). Packed to bf16 in
// pairs, the accumulator of columns [16kk, 16kk + 16) is the register A
// fragment of a k16 step: the f32 scores become the next product's A
// operand without a trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// cp.async: 16-byte chunks into swizzled tiles, 4-byte words into plain
// arrays, their landing tracked by an mbarrier (cp_async_mbar_arrive). A
// chunk past the tensor's end is zero-filled (src-size 0, nothing read):
// rows past T are masked by the kernels, and the zeros keep their products
// finite.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// the landed copies become visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// mbarriers (shared-memory barriers with phases) and named barriers
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival on bar once every cp.async this thread has issued so far has
// landed (the arrival is counted in the barrier's init count)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// until the phase of the given parity (the barrier's k-th phase has parity
// k % 2) has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// named barrier `id` (1..15; 0 is __syncthreads) of n threads: sync waits
// for n arrivals, its own included; arrive adds this thread's and goes on
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// a swizzled tile starts on a 1024-byte boundary (the swizzle's period)
__device__ __forceinline__ uint32_t align1024(uint32_t a) {
  return (a + 1023u) & ~1023u;
}

// byte offset of 16-byte chunk c (D / 8 a row) of row r in a swizzled tile
template <int ROWS>
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// rows [r0, r0 + ROWS) of one head of a (B, T, heads, D) view (row stride
// st elements) into the swizzled tile at shared address dst, by the NT
// threads of the block; rows at or past T are zero
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile_sw128(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                long long st, int r0,
                                                int T) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % NT == 0, "tile not a whole pass");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r0 + r < T;
    cp_async16(dst + sw128_offset<ROWS>(r, c),
               src + (in ? (long long)(r0 + r) * st : 0LL) + c * 8, in);
  }
}

// ---------------------------------------------------------------------------
// wgmma shared-memory matrix descriptors (128-byte swizzle)
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) |  // 8-row groups 1024 bytes apart
         (1ull << 62);                    // layout: 128-byte swizzle
}

// K-major operand: rows [r, r + 64) (A) or the whole tile (B), k step kk
// (16 elements of D) of a swizzled tile of ROWS rows at tile
template <int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int r,
                                                int kk) {
  // the leading byte offset is unused by K-major swizzled layouts
  return sw128_desc(
      tile + (kk >> 2) * (ROWS * 128) + r * 128 + (kk & 3) * 32, 16);
}

// MN-major B operand: rows [16 kk, 16 kk + 16) as k, all D columns as n
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 2048, ROWS * 128);
}

// ---------------------------------------------------------------------------
// wgmma issue, commit and wait, and the operand fences that keep the
// compiler from moving accumulator reads or writes across them
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// every wgmma group but the newest N of this warpgroup has completed
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define WG_F8(d, i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F32(d, i) WG_F8(d, i), WG_F8(d, i + 8), WG_F8(d, i + 16), \
                     WG_F8(d, i + 24)

#define WG_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 64) = A B (+ d when accumulate): A (64 x 16) and B^T (64 x 16)
// both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_F32(d, 0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N) += A B: A (64 x 16) from registers (four packed bf16 pairs
// a thread), B (16 x N) MN-major in shared memory; N = 64 or 128
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t a[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t a[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_F32(d, 0), WG_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_F8
#undef WG_F32
#undef WG_REGS32
#undef WG_REGS64

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
