// Hopper (sm_90a) tile helpers of the attention kernels (flash_attention.cu,
// ring_attention.cu): cp.async copies into 128-byte-swizzled shared tiles,
// mbarriers and named barriers, the ring of tile stages and the warpgroups'
// turns built on them, the shared-memory matrix descriptors that wgmma
// reads the tiles through, the four wgmma forms the kernels issue (bf16
// operands, f32 accumulators), and the online-softmax K loop that the flash
// forward and the ring block update share. Inline PTX only: no CUTLASS or
// CuTe headers, so nvcc builds a library in seconds.
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
// - MN-major (the reduction runs along the rows, as in o += p V or
//   dv += p^T dO): each 128-byte row is 64 consecutive N (= D) elements of
//   one k, 8-row groups 1024 bytes apart (stride byte offset), the next 64 N
//   elements one atom (ROWS * 128 bytes, the leading byte offset) further;
//   a 16-row k step moves 2048 bytes.
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

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // masked logits: finite, never -inf
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;  // a block: two warpgroups

// element strides of a (B, T, heads, D) view; D is contiguous
struct View {
  long long sb, st, sh;
};

View view_at(const long long* s, int i) { return View{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// max and sum over the 4 lanes (t = 0..3) that hold one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// two consecutive output elements (an accumulator pair) as bf16 or f32
__device__ __forceinline__ void store_pair(void* base, long long off,
                                           float x, float y, int out_f32) {
  if (out_f32) {
    *reinterpret_cast<float2*>(static_cast<float*>(base) + off) =
        make_float2(x, y);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(base) + off) =
        __floats2bfloat162_rn(x, y);
  }
}

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

// ---------------------------------------------------------------------------
// The ring of streamed tiles and the warpgroups' turns. A block's threads
// copy each streamed tile into one of the ring's stages with cp.async, every
// thread its share. No __syncthreads in a loop: a stage's "full" mbarrier
// completes when every thread's copies into it have landed, its "empty"
// mbarrier when every thread's warpgroup has done reading it. So the two
// warpgroups run out of step, and two named barriers make them take turns
// issuing their products: one warpgroup's exp (CUDA cores, the exp unit)
// runs while the other's products hold the tensor cores.
// ---------------------------------------------------------------------------

// A ring of kStages = S stages; its mbarriers at bars: full[S], then
// empty[S]. Every thread arrives once on each per tile: its copies on full,
// its release on empty.
template <int S>
struct Ring {
  static constexpr int kStages = S;
  uint32_t bars;
  __device__ uint32_t full(int st) const { return bars + 8 * st; }
  __device__ uint32_t empty(int st) const {
    return bars + 8 * (kStages + st);
  }
  __device__ void init() const {
    if (threadIdx.x == 0)
      for (int st = 0; st < kStages; ++st) {
        mbar_init(full(st), kThreads);
        mbar_init(empty(st), kThreads);
      }
    __syncthreads();
  }
  // before copying tile j: its stage's previous tile is released
  __device__ void acquire(int j) const {
    if (j >= kStages) mbar_wait(empty(j % kStages), (j / kStages - 1) & 1);
  }
  // after issuing tile j's copies
  __device__ void commit(int j) const {
    cp_async_mbar_arrive(full(j % kStages));
  }
  // before reading tile i: its copies have landed, and wgmma sees them
  __device__ void wait(int i) const {
    mbar_wait(full(i % kStages), (i / kStages) & 1);
    fence_proxy_async();
  }
  __device__ void release(int i) const { mbar_arrive(empty(i % kStages)); }
};

// The turn of warpgroup wg (named barriers 1 and 2): warpgroup 0 goes first
// once warpgroup 1 has called turn_end(1) before its loop; after the loop
// warpgroup 0 takes one more turn_begin(0), which consumes warpgroup 1's
// last turn_end
__device__ __forceinline__ void turn_begin(int wg) {
  bar_sync(1 + wg, kThreads);
}
__device__ __forceinline__ void turn_end(int wg) {
  bar_arrive(2 - wg, kThreads);
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
__device__ __forceinline__ void load_tile_sw128(uint32_t dst, const bf16* src,
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

// d (64 x 128) = A B (+ d when accumulate): A (64 x 16) and B^T (128 x 16)
// both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F32(d, 0), WG_F32(d, 32)
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

// ---------------------------------------------------------------------------
// The online-softmax K loop of the flash forward and the ring block update.
// A block of two warpgroups owns 128 query rows [q0, q0 + 128) of one head,
// warpgroup wg the 64 rows from q0 + 64 wg; thread (warp w, g, t) holds the
// carries of rows rowA = q0 + 64 wg + 16 w + g and rowB = rowA + 8: the
// running max m and sum l (natural-log units, as the caller stores them)
// and acc, their accumulator of p V (D / 2 f32 in the accumulator layout).
//
// Q is copied once into a swizzled tile; the 128-key K/V tiles covering
// keys [0, kend) stream through a ring of kFwdStages stages. In its turn at
// tile i a warpgroup issues s = q k^T of tile i (m64n128k16, K-major both,
// from shared memory) and o += p V of tile i - 1 (p packed to bf16 as the
// register A operand, V read through an MN-major descriptor of its tile;
// zeros against tile 0 at i = 0). Then, out of turn: wait for s, take the
// row max over the live keys, the correction 2^((m - m') log2e) and
// p = 2^(s scale log2e - m' log2e) with its f32 row sum; wait for the p V
// product; rescale acc by the correction (after tile i - 1's product has
// landed, before tile i's is issued); pack p. Every product is waited for
// within its tile: none is in flight across the loop's back edge, so ptxas
// keeps the wgmma pipeline.
//
// Key c is live for a row when c < its limit (hiA, hiB), which the caller
// derives from the causal mask and Tk. A warp whose rows all see the whole
// tile skips the mask (at T = 32768 all but the diagonal tiles); the others
// mask every element. A masked logit counts as the finite kNegInf: its p is
// exp(kNegInf - m'), 0 unless the row has seen no live key and m' is still
// kNegInf (then 1, as the plain versions have it). A row that no live key
// moves keeps its carries bit for bit: m' = m, the correction is exactly 1
// and every p of it is 0.
//
// The caller guarantees kend >= 1 and passes the dynamic shared memory
// (fwd_smem_bytes<D>() of it).
// ---------------------------------------------------------------------------
constexpr int kFwdStages = 3;

template <int D>
constexpr int fwd_smem_bytes() {
  // alignment slack, Q, kFwdStages x (K and V), the ring's mbarriers
  return 1024 + 128 * D * 2 + kFwdStages * 2 * 128 * D * 2 +
         2 * kFwdStages * 8;
}

template <int D>
__device__ __forceinline__ void attend_kv_tiles(
    unsigned char* smem, const bf16* qb, long long q_st, int q0, int Tq,
    const bf16* kb, long long k_st, const bf16* vb, long long v_st, int Tk,
    int kend, int hiA, int hiB, float scale, float (&m)[2], float (&l)[2],
    float (&acc)[D / 2]) {
  constexpr int BQ = 128, BK = 128;
  constexpr int kQ = BQ * D * 2, kKV = BK * D * 2;  // tile bytes
  const uint32_t sQ = align1024(smem_u32(smem));
  const uint32_t sKV = sQ + kQ;  // stage s: K at sKV + 2 s kKV, V after it
  const Ring<kFwdStages> ring{sKV + kFwdStages * 2 * kKV};
  ring.init();

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 3;
  const int n = (kend + BK - 1) / BK;
  auto stage = [&](int i) { return sKV + (i % kFwdStages) * 2 * kKV; };  // K
  auto issue = [&](int j) {  // this thread's share of K/V tile j
    if (j >= n) return;
    ring.acquire(j);
    load_tile_sw128<BK, D, kThreads>(stage(j), kb, k_st, j * BK, Tk);
    load_tile_sw128<BK, D, kThreads>(stage(j) + kKV, vb, v_st, j * BK, Tk);
    ring.commit(j);
  };
  load_tile_sw128<BQ, D, kThreads>(sQ, qb, q_st, q0, Tq);
  issue(0);  // Q lands with tile 0
  if (wg == 1) turn_end(1);  // warpgroup 0 takes the first turn

  const float sl2 = scale * kLog2e;
  uint32_t pa[BK / 16][4] = {};  // p of tile i - 1, packed: the A operand

  for (int i = 0; i < n; ++i) {
    issue(i + 1);
    ring.wait(i);
    const uint32_t sK = stage(i);
    const uint32_t sVp = stage(i > 0 ? i - 1 : 0) + kKV;

    float s[BK / 2];
    turn_begin(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(s, desc_kmajor<BQ>(sQ, wg * 64, kk),
                    desc_kmajor<BK>(sK, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(acc, pa[kk], desc_mnmajor<BK>(sVp, kk));
    wgmma_commit();
    turn_end(wg);

    wgmma_wait<1>();  // s is in; the p V product may still run
    fence_regs(s);
    const int k0 = i * BK;
    float corrA, corrB;
    // the online softmax of the tile; column 8j + 2t + (e & 1) is live
    // below the row's limit, or always when the warp sees the whole tile
    auto softmax = [&](auto masked) {
      const int cA = hiA - k0 - 2 * t, cB = hiB - k0 - 2 * t;
      auto live = [&](int j, int e) {
        return !decltype(masked)::value ||
               8 * j + (e & 1) < (e < 2 ? cA : cB);
      };
      // the rows' largest live dot (unscaled: scaling by scale > 0 and
      // rounding keep the order, so max(s) scale = max(s scale))
      float xA = -3.0e38f, xB = -3.0e38f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = live(j, e) ? s[4 * j + e] : -3.0e38f;
          if (e < 2)
            xA = fmaxf(xA, x);
          else
            xB = fmaxf(xB, x);
        }
      }
      // the new running maxima, natural-log units; a masked logit is
      // kNegInf
      const float mA = fmaxf(m[0], fmaxf(kNegInf, quad_max(xA) * scale));
      const float mB = fmaxf(m[1], fmaxf(kNegInf, quad_max(xB) * scale));
      corrA = mA == m[0] ? 1.f : ex2((m[0] - mA) * kLog2e);
      corrB = mB == m[1] ? 1.f : ex2((m[1] - mB) * kLog2e);
      const float nA = -mA * kLog2e, nB = -mB * kLog2e;
      const float zA = mA == kNegInf ? 1.f : 0.f;  // p of a masked key
      const float zB = mB == kNegInf ? 1.f : 0.f;
      float rA = 0.f, rB = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              live(j, e) ? ex2(fmaf(s[4 * j + e], sl2, e < 2 ? nA : nB))
                         : (e < 2 ? zA : zB);
          s[4 * j + e] = p;
          if (e < 2)
            rA += p;
          else
            rB += p;
        }
      }
      l[0] = l[0] * corrA + quad_sum(rA);
      l[1] = l[1] * corrB + quad_sum(rB);
      m[0] = mA;
      m[1] = mB;
    };
    if (__all_sync(0xffffffffu, min(hiA, hiB) >= k0 + BK))
      softmax(std::false_type{});
    else
      softmax(std::true_type{});

    wgmma_wait<0>();  // tile i - 1's p V has landed in acc
    fence_regs(acc);
    fence_regs(pa);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= corrA;
      acc[4 * j + 1] *= corrA;
      acc[4 * j + 2] *= corrB;
      acc[4 * j + 3] *= corrB;
    }
    // p, packed: the A fragment of k step kk is columns [16 kk, 16 kk + 16)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
    if (i > 0) ring.release(i - 1);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(acc, pa[kk], desc_mnmajor<BK>(stage(n - 1) + kKV, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  if (wg == 0) turn_begin(0);  // warpgroup 1's last turn_end
}

}  // namespace
