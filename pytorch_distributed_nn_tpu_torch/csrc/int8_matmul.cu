// W8A16 matmul for Hopper (sm_90a): out = (x @ float(q)) * s.
//
// Replaces the TPU kernel pytorch_distributed_nn_tpu/ops/pallas/int8_matmul.py
// (`_kernel`, launched by `_int8_matmul_tpu`). Same contract: x (M, Kp) bf16,
// q (Kp, Np) int8 row-major, s (1, Np) f32 per output column; the int8 weights
// are exact in bf16, products are exact in f32 and summed in f32 over K, the
// scale is applied once after the K reduction, and the result is cast to bf16
// or f32. The weights are read in their storage layout (shared with the JAX
// package's quantized checkpoints): no repacked copy is kept.
//
// What bounds it on an H100. Decode feeds M = 1..8 rows against every weight
// byte of the model: one Llama-3-8B forward streams ~7.5 GB of int8 weights,
// ~2.2 ms at 3.35 TB/s. Prefill (M up to 128) does 16x the products on the
// same bytes, still under the tensor cores' rate. The design:
//
// - Tensor cores with the operands swapped: mma.sync m16n8k16 (bf16 in, f32
//   accumulate) with the weight tile as A (16 output columns x 16 k) and x^T
//   as B (8 tokens), so M = 1..8 fills one n = 8 tile and no weight work goes
//   to padded rows; a block takes 8 * NT tokens as NT n-tiles that reuse
//   every dequantized A fragment. The same instruction serves every M.
//   wgmma with the same A in registers (it too at every M) timed 4%
//   slower at M = 8 and 11% faster at M = 128 (PERF.md): decode, where the
//   card spends most of its int8 time, keeps mma.sync.
// - Dequantization in registers, no I2F: a weight byte b (xor 0x80, so
//   b + 128) is placed under the f32 exponent of 2^23 by a byte permute
//   (0x4B0000uu = 2^23 + b + 128), one subtract of 2^23 + 128 gives b
//   exactly, and since |b| <= 128 the f32's low 16 bits are zero: a second
//   permute packs the high halves of two such floats into a bf16 pair.
// - The transpose in the permutes: an A fragment holds consecutive k of one
//   output column, storage has N contiguous. Thread (g, t) of a warp (g =
//   lane / 4, t = lane % 4) reads the 32-bit words of rows 2t, 2t+1, 2t+8,
//   2t+9 of the warp's 32 columns at byte 4g: four neighbouring columns
//   4g..4g+3. They stand for mma rows g and g+8 of the warp's two m16 tiles
//   (column 4g+2i+h is row g+8h of tile i), so every byte a thread reads is
//   its own, and the accumulators of one token hold the four columns
//   4g..4g+3, written back with one 8- or 16-byte store.
// - The weight stream in flight: a ring of kStages stages of 64 K rows x 128
//   columns (8 KB), filled with 16-byte cp.async copies of whole row
//   segments (each also asks the L2 for the 256-byte block around it, which
//   the neighbouring column tiles read at about the same time) and x's
//   matching 64 k of the block's tokens (a 128-byte-swizzled tile that
//   ldmatrix reads without bank conflicts); one commit group and one
//   __syncthreads a stage; weight rows are padded to 144 bytes so the
//   fragment reads are conflict-free. At M <= 8 a block holds ~50
//   registers a thread and 41 KB of shared memory, so several blocks of
//   each SM keep their three stages (24 KB each) in flight.
// - One launch a call. Narrow layers split K over blocks so that their tiles
//   fill the card; each split writes its f32 partial sums, and the last block
//   of a column tile to finish (an atomic counter, which it resets to 0)
//   adds the partials in split order, scales and casts. The split and the
//   k-order depend on (Kp, Np) only, and no float is added atomically: a
//   row's bits do not depend on M, on the other rows or on the run.
//
// Measured (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3): one decode
// forward's 129 calls at M = 8 take about as long as torch.sum reading the
// same bytes under the same L2 flush; prefill (M = 128) is bound by the
// mma.sync rate and the split sums' trips through the L2.

#include <stdint.h>

#include "wgmma_tile.cuh"  // smem_u32, cp_async16, allow_smem

namespace {

constexpr int kW8Threads = 128;  // 4 warps of 32 output columns
constexpr int kTileN = 128;      // output columns a block
constexpr int kTileK = 64;       // K rows a ring stage: 4 k16 steps
constexpr int kStages = 4;       // ring stages: 3 in flight while one is read
constexpr int kWChunks = kTileN / 16;  // 16-byte copies a weight row
constexpr int kWRow = kTileN + 16;     // bytes a weight row in shared memory
constexpr int kWTile = kTileK * kWRow;
constexpr int kXRow = kTileK * 2;  // bytes of one token's 64 k of x

// NT n-tiles of 8 tokens a block
template <int NT>
struct W8Cfg {
  static constexpr int kRows = 8 * NT;
  static constexpr int kStage = kWTile + kRows * kXRow;
  static constexpr int kSmem = kStages * kStage;
};

// a 16-byte cp.async of streamed weights that also has the L2 fetch the
// 256-byte block around it (the neighbouring column tiles' bytes, which
// their blocks read at about the same time); a chunk past the tensor is
// zeroed
__device__ __forceinline__ void cp_async16_l2_256(uint32_t dst,
                                                  const void* src, bool in) {
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(dst),
      "l"(src), "r"(in ? 16 : 0)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bytes J of lo and hi (int8 weights xor 0x80) as a bf16 pair, lo in the
// low half: 0x4B0000uu is 2^23 + uu, so subtracting 2^23 + 128 leaves the
// weight exactly, and its f32 bits are zero below the bf16's
template <int J>
__device__ __forceinline__ uint32_t dequant_pair(uint32_t lo, uint32_t hi) {
  constexpr uint32_t kSel = 0x7540u | J;
  const float flo =
      __uint_as_float(__byte_perm(lo, 0x4B000000u, kSel)) - 8388736.f;
  const float fhi =
      __uint_as_float(__byte_perm(hi, 0x4B000000u, kSel)) - 8388736.f;
  return __byte_perm(__float_as_uint(flo), __float_as_uint(fhi), 0x7632);
}

// four consecutive outputs (columns 4g..4g+3 of one token)
__device__ __forceinline__ void store4(void* out, size_t off, float a, float b,
                                       float c, float d, int out_f32) {
  if (out_f32) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + off) =
        make_float4(a, b, c, d);
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
    __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
    uint2 v;
    v.x = *reinterpret_cast<uint32_t*>(&lo);
    v.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + off) = v;
  }
}

// Block b: column tile b % (Np / 128), then split, then token tile (blocks
// that run at once read neighbouring columns of the same rows). Split z
// takes ring stages [z * kc_steps, (z + 1) * kc_steps) of K.
template <int NT>
__global__ void __launch_bounds__(kW8Threads)
    w8a16_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ q, const float* __restrict__ s,
                 void* __restrict__ out, float* __restrict__ ws,
                 int* __restrict__ counters, int M, int Kp, int Np,
                 int kc_steps, int splits, int m_tiles, int out_f32) {
  using C = W8Cfg<NT>;
  constexpr int S = kStages;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int last_block;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = Np / kTileN;
  const int nt = blockIdx.x % tiles;
  const int rest = blockIdx.x / tiles;
  const int z = rest % splits, mt = rest / splits;
  const int m0 = mt * C::kRows, n0 = nt * kTileN;
  const int total = (Kp + kTileK - 1) / kTileK;
  const int first = z * kc_steps;
  const int n = min(kc_steps, total - first);
  const uint32_t base = smem_u32(smem);

  // this thread's copies: weight rows r_w + p * kWStride at chunk c_w, token
  // rows r_x + p * kXStride of x at chunk c_x
  constexpr int kWStride = kW8Threads / kWChunks;
  constexpr int kXStride = kW8Threads / 8;
  const int r_w = tid / kWChunks, c_w = tid % kWChunks;
  const int r_x = tid >> 3, c_x = tid & 7;
  const int8_t* q_src = q + (size_t)(first * kTileK + r_w) * Np + n0 + c_w * 16;
  const __nv_bfloat16* x_src = x + first * kTileK + c_x * 8;
  const uint32_t w_off = r_w * kWRow + c_w * 16;
  const uint32_t x_off = kWTile + r_x * kXRow + ((c_x ^ (r_x & 7)) << 4);

  auto load_stage = [&](int i) {
    const uint32_t dst = base + (i % S) * C::kStage;
    const int k0 = (first + i) * kTileK;
#pragma unroll
    for (int p = 0; p < kTileK / kWStride; ++p) {
      const bool in = k0 + r_w + p * kWStride < Kp;
      cp_async16_l2_256(dst + w_off + p * kWStride * kWRow,
                        in ? q_src + (size_t)(i * kTileK + p * kWStride) * Np
                           : q,
                        in);
    }
#pragma unroll
    for (int p = 0; p < (C::kRows + kXStride - 1) / kXStride; ++p) {
      const int r = r_x + p * kXStride;
      if (C::kRows % kXStride == 0 || r < C::kRows) {
        const bool in = m0 + r < M && k0 + c_x * 8 < Kp;
        cp_async16(dst + x_off + p * kXStride * kXRow,
                   in ? x_src + (size_t)(m0 + r) * Kp + i * kTileK : x, in);
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n) load_stage(i);
    cp_async_commit();
  }

  for (int i = 0; i < n; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();  // stage i has landed; stage i - 1's readers are done
    if (i + S - 1 < n) load_stage(i + S - 1);
    cp_async_commit();

    const uint8_t* wt = smem + (i % S) * C::kStage + warp * 32 + g * 4;
    const uint32_t xt = base + (i % S) * C::kStage + kWTile;
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {  // the stage's k16 steps
      const uint8_t* w = wt + (16 * kk + 2 * t) * kWRow;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(w) ^ 0x80808080u;
      const uint32_t w1 =
          *reinterpret_cast<const uint32_t*>(w + kWRow) ^ 0x80808080u;
      const uint32_t w2 =
          *reinterpret_cast<const uint32_t*>(w + 8 * kWRow) ^ 0x80808080u;
      const uint32_t w3 =
          *reinterpret_cast<const uint32_t*>(w + 9 * kWRow) ^ 0x80808080u;
      uint32_t a[2][4];  // [m16 tile][fragment]
      a[0][0] = dequant_pair<0>(w0, w1);
      a[0][1] = dequant_pair<1>(w0, w1);
      a[0][2] = dequant_pair<0>(w2, w3);
      a[0][3] = dequant_pair<1>(w2, w3);
      a[1][0] = dequant_pair<2>(w0, w1);
      a[1][1] = dequant_pair<3>(w0, w1);
      a[1][2] = dequant_pair<2>(w2, w3);
      a[1][3] = dequant_pair<3>(w2, w3);
      // B: tokens of the n-tile, the 16-byte chunks 2kk (k 0-7 of the step)
      // and 2kk + 1 (k 8-15); ldmatrix matrix mi is addressed by lanes
      // 8mi..8mi+7
      const int mi = lane >> 3;
      if constexpr (NT == 1) {
        const int ch = 2 * kk + (mi & 1);
        uint32_t b[2];
        ldmatrix_x2(b, xt + (lane & 7) * kXRow + ((ch ^ (lane & 7)) << 4));
        mma_bf16_16816(acc[0][0], a[0], b[0], b[1]);
        mma_bf16_16816(acc[1][0], a[1], b[0], b[1]);
      } else {
        const int ch = 2 * kk + (mi & 1);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {  // n-tiles j and j + 1
          const int r = 8 * (j + (mi >> 1)) + (lane & 7);
          uint32_t b[4];
          ldmatrix_x4(b, xt + r * kXRow + ((ch ^ (lane & 7)) << 4));
          mma_bf16_16816(acc[0][j], a[0], b[0], b[1]);
          mma_bf16_16816(acc[1][j], a[1], b[0], b[1]);
          mma_bf16_16816(acc[0][j + 1], a[0], b[2], b[3]);
          mma_bf16_16816(acc[1][j + 1], a[1], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // thread (g, t) holds tokens 8j + 2t + h, columns col..col + 3
  const int col = n0 + warp * 32 + g * 4;
  const float4 sc = *reinterpret_cast<const float4*>(s + col);
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tok = m0 + 8 * j + 2 * t + h;
        if (tok < M)
          store4(out, (size_t)tok * Np + col, acc[0][j][h] * sc.x,
                 acc[0][j][2 + h] * sc.y, acc[1][j][h] * sc.z,
                 acc[1][j][2 + h] * sc.w, out_f32);
      }
    return;
  }

  const size_t plane = (size_t)M * Np;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tok = m0 + 8 * j + 2 * t + h;
      if (tok < M)
        *reinterpret_cast<float4*>(ws + z * plane + (size_t)tok * Np + col) =
            make_float4(acc[0][j][h], acc[0][j][2 + h], acc[1][j][h],
                        acc[1][j][2 + h]);
    }
  __threadfence();  // this block's partials are visible before its count
  __syncthreads();
  const int tile = nt * m_tiles + mt;
  if (tid == 0) last_block = atomicAdd(counters + tile, 1) == splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // the last block of the tile: the partials in split order, then the
  // scale; four n-tiles at a time, so that 32 loads a thread are in flight
  constexpr int JB = NT < 4 ? NT : 4;
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += JB) {
    float4 v[JB][2];
    const float* p[JB][2];
#pragma unroll
    for (int j = 0; j < JB; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tok = min(m0 + 8 * (j0 + j) + 2 * t + h, M - 1);
        p[j][h] = ws + (size_t)tok * Np + col;
        v[j][h] = __ldcg(reinterpret_cast<const float4*>(p[j][h]));
      }
#pragma unroll 4
    for (int zz = 1; zz < splits; ++zz)
#pragma unroll
      for (int j = 0; j < JB; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 u = __ldcg(
              reinterpret_cast<const float4*>(p[j][h] + zz * plane));
          v[j][h].x += u.x;
          v[j][h].y += u.y;
          v[j][h].z += u.z;
          v[j][h].w += u.w;
        }
#pragma unroll
    for (int j = 0; j < JB; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tok = m0 + 8 * (j0 + j) + 2 * t + h;
        if (tok < M)
          store4(out, (size_t)tok * Np + col, v[j][h].x * sc.x,
                 v[j][h].y * sc.y, v[j][h].z * sc.z, v[j][h].w * sc.w,
                 out_f32);
      }
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next call
}

template <int NT>
int launch(int blocks, cudaStream_t st, const __nv_bfloat16* x,
           const int8_t* q, const float* s, void* out, float* ws,
           int* counters, int M, int Kp, int Np, int kc_steps, int splits,
           int m_tiles, int out_f32) {
  static bool smem_set[64] = {};  // per device: the dynamic shared memory
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = allow_smem(w8a16_kernel<NT>, W8Cfg<NT>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  w8a16_kernel<NT><<<blocks, kW8Threads, W8Cfg<NT>::kSmem, st>>>(
      x, q, s, out, ws, counters, M, Kp, Np, kc_steps, splits, m_tiles,
      out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (M, Np) = (x (M, Kp) bf16 @ q (Kp, Np) int8) * s (1, Np) f32, one
// launch. mt: tokens a block (8, 16, 32, 64 or 128); kc: K rows a split (a
// multiple of 64); splits: the K splits. With splits > 1, ws is an f32
// workspace of splits * M * Np elements and counters holds
// ceil(M / mt) * Np / 128 zeroed ints (left zeroed). Np must be a multiple
// of 128, Kp of 32, every pointer 16-byte aligned (the Python wrapper checks).
// Launches on `stream` and returns the CUDA error code (0 = success).
extern "C" int w8a16_matmul(const void* x, const void* q, const void* s,
                            void* out, void* ws, void* counters, int M,
                            int Kp, int Np, int mt, int kc, int splits,
                            int out_f32, void* stream) {
  if (M <= 0 || Np % kTileN || Kp % 32 || kc % kTileK || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sf = static_cast<const float*>(s);
  auto* wsf = static_cast<float*>(ws);
  auto* cnt = static_cast<int*>(counters);
  const int m_tiles = (M + mt - 1) / mt;
  const int blocks = m_tiles * (Np / kTileN) * splits;
  const int ks = kc / kTileK;
  switch (mt) {
    case 8:
      return launch<1>(blocks, st, xb, qb, sf, out, wsf, cnt, M, Kp, Np, ks,
                       splits, m_tiles, out_f32);
    case 16:
      return launch<2>(blocks, st, xb, qb, sf, out, wsf, cnt, M, Kp, Np, ks,
                       splits, m_tiles, out_f32);
    case 32:
      return launch<4>(blocks, st, xb, qb, sf, out, wsf, cnt, M, Kp, Np, ks,
                       splits, m_tiles, out_f32);
    case 64:
      return launch<8>(blocks, st, xb, qb, sf, out, wsf, cnt, M, Kp, Np, ks,
                       splits, m_tiles, out_f32);
    case 128:
      return launch<16>(blocks, st, xb, qb, sf, out, wsf, cnt, M, Kp, Np, ks,
                        splits, m_tiles, out_f32);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* w8a16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
