// Tile helpers shared by the attention kernels of this directory
// (flash_attention.cu, ring_attention.cu): bf16 mma.sync m16n8k16 with f32
// accumulation, its fragment loads from padded shared-memory tiles, 16-byte
// tile loads from (B, T, heads, D) views given by element strides, quad
// reductions over a C fragment's row, the online-softmax K loop that the
// flash forward and the ring block update share, and the launch helpers.
//
// One (64 or 32)-row tile lives in shared memory with a row pitch of D + 8
// elements, so the fragment loads of one warp hit 32 distinct banks. A warp
// owns 16 rows of a C fragment: lane (g = lane / 4, t = lane % 4) holds rows
// g and g + 8, columns 2t and 2t + 1 of every 8-column tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // 4 warps, 16 rows each
constexpr int kPad = 8;        // shared-memory row padding, elements

// element strides of a (B, T, heads, D) view; D is contiguous
struct View {
  long long sb, st, sh;
};

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 x 16, row-major) of the shared tile s (pitch ld) at
// rows r0.., cols c0..
__device__ __forceinline__ void load_a(const bf16* s, int ld, int r0, int c0,
                                       uint32_t a[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* p = s + (r0 + g) * ld + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment (16 x 8, k x n) where the shared tile stores X[n][k]
// (e.g. K[key][d] for s = q.k^T): two 32-bit loads.
__device__ __forceinline__ void load_b_nk(const bf16* s, int ld, int n0,
                                          int k0, uint32_t b[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragment (16 x 8, k x n) where the shared tile stores X[k][n]
// (e.g. V[key][d] for o = p.v): four 16-bit loads, packed.
__device__ __forceinline__ void load_b_kn(const bf16* s, int ld, int k0,
                                          int n0, uint32_t b[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned short* p =
      reinterpret_cast<const unsigned short*>(s) + (k0 + 2 * t) * ld + n0 + g;
  b[0] = (uint32_t)p[0] | ((uint32_t)p[ld] << 16);
  b[1] = (uint32_t)p[8 * ld] | ((uint32_t)p[9 * ld] << 16);
}

// rows [r0, r0 + ROWS) of one head of a (B, T, heads, D) view into a shared
// tile of pitch D + kPad; rows at or past T are zero
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long st, int r0, int T) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  constexpr int ld = D + kPad;
  static_assert(ROWS * kChunks % kThreads == 0, "tile not a whole pass");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < T)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * st + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// two consecutive output elements (a C-fragment pair) as bf16 or f32
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

// The online-softmax K loop of the flash forward and the ring block update:
// streams the 64-key K/V tiles covering keys [0, kend) of one head through
// the shared tiles sK and sV (pitch D + kPad) against the warp's Q
// A-fragments `qa`, and updates the warp's carries in place: the running
// max `m` and sum `l` of rows rowA and rowB, and `acc`, their C fragments
// of p.V. Key c is live for row r when c < Tk and, when causal,
// r + diag >= c, where diag is the query rows' global offset minus the
// keys' (0 for self-attention). s = q.k^T is scaled after the f32 dot; p is
// rounded to bf16 for the p.V product.
template <int D>
__device__ __forceinline__ void attend_kv_tiles(
    bf16* sK, bf16* sV, const bf16* kb, const bf16* vb, long long k_st,
    long long v_st, int kend, int Tk, uint32_t (&qa)[D / 16][4],
    int rowA, int rowB, int causal, int diag, float scale, float (&m)[2],
    float (&l)[2], float (&acc)[D / 8][4]) {
  constexpr int BK = 64, LD = D + kPad;
  const int t = threadIdx.x & 3;
  const int nk = (kend + BK - 1) / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<BK, D>(sK, kb, k_st, k0, Tk);
    load_tile<BK, D>(sV, vb, v_st, k0, Tk);
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t bb[2];
        load_b_nk(sK, LD, n * 8, kk * 16, bb);
        mma16816(s[n], qa[kk], bb);
      }
    }
    // scale, mask, online softmax over the tile's 64 keys
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? rowA : rowB;
        const bool live = col < Tk && (!causal || row + diag >= col);
        s[n][e] = live ? s[n][e] * scale : kNegInf;
      }
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    const float corr0 = __expf(m[0] - mx[0]), corr1 = __expf(m[1] - mx[1]);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = __expf(s[n][0] - mx[0]);
      s[n][1] = __expf(s[n][1] - mx[0]);
      s[n][2] = __expf(s[n][2] - mx[1]);
      s[n][3] = __expf(s[n][3] - mx[1]);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l[0] = l[0] * corr0 + quad_sum(rs0);
    l[1] = l[1] * corr1 + quad_sum(rs1);
    m[0] = mx[0];
    m[1] = mx[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }
    // acc += p v: the C fragments of two adjacent 8-key tiles of p are the
    // A fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bb[2];
        load_b_kn(sV, LD, kk * 16, n * 8, bb);
        mma16816(acc[n], pa, bb);
      }
    }
  }
}

View view_at(const long long* s, int i) { return View{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace
