// Ring-attention block update for Hopper (sm_90a): one ring step's
// online-softmax update of the (m, l, acc) f32 carries of a local Q shard
// against a visiting K/V shard,
//
//   m' = max(m, rowmax(s));  p = exp(s - m')
//   l' = l * exp(m - m') + rowsum(p);  acc' = acc * exp(m - m') + p.V
//
// with s = q.k^T * D^-0.5 and, when causal, the mask q_off + r >= k_off + c
// on GLOBAL positions (q_off, k_off: where the two shards start in the full
// sequence).
//
// Replaces the TPU kernel pytorch_distributed_nn_tpu/ops/pallas/
// ring_attention.py `_ring_block_kernel` (launched by `_ring_block_pallas`).
// Same contract, with the TPU's artifacts dropped: the offsets are plain
// kernel arguments (the TPU's SMEM scalars), and m and l are (B * H, Tq) f32
// rows (the TPU broadcasts them over 8 lanes for Mosaic's tiling). The
// carries are updated in place, as the TPU kernel aliases them. Query head h
// reads K/V head h / (H / Hkv): K/V stay grouped, as they ride the ring.
//
// Layout. q, k and v are read in place as (B, T, heads, D) views given by
// three element strides (batch, row, head) with D contiguous, so a shard
// that is a row slice of a larger tensor needs no copy. acc is a contiguous
// (B, Tq, H, D) f32 tensor, the model's layout.
//
// Arithmetic, as the port's flash forward (flash_attention.cu): bf16
// operands on the tensor cores (wgmma) with f32 accumulation; the f32 dot is
// scaled after the product (the TPU kernel scales q before it: one f32
// rounding apart); p is rounded to bf16 for the p.V product; m, l and acc
// stay f32. Masked logits take the finite -1e30.
//
// What bounds it on an H100. At the long-context shapes (Tq = Tk = 8192 or
// 32768, D = 128) a pair does 4 Tq Tk D flops per head (half of it on a
// causal diagonal) for ~12 Tq D bytes: far above the 295 flops per byte
// where the tensor cores, not memory, are the limit. So the kernel is the
// flash forward with carries: the same block of two warpgroups over 128
// query rows and the same K loop (attend_kv_tiles in wgmma_tile.cuh: wgmma,
// 128-key K/V tiles through a cp.async ring, the warpgroups taking turns),
// with the offsets' difference in its mask; the (Tq, Tk) scores never reach
// device memory. The carries are read once into the accumulator layout
// before the loop and written once after it (warp w of a warpgroup holds
// rows 16w + g and 16w + g + 8, g = lane / 4; the f32 acc adds 8 Tq D bytes
// a head, under 2% of a causal pair's time at Tq = 8192). m and l stay in
// their natural-log units; the loop applies the log2 scaling on the fly, so
// a row that no live key moves writes back the bits it read. The K loop ends
// at the last key a row of the block may see, so a fully-future shard costs
// no iteration and leaves its carries untouched.

#include <cmath>

#include "wgmma_tile.cuh"

namespace {

// One block per (b * H + h, 128-row Q tile).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    ring_block_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, float* __restrict__ m_io,
                      float* __restrict__ l_io, float* __restrict__ acc_io,
                      int H, int Hkv, int Tq, int Tk, View vq, View vk,
                      View vv, long long q_off, long long k_off, int causal,
                      float scale) {
  constexpr int BQ = 128;
  extern __shared__ unsigned char smem[];
  const int nq = (Tq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQ;  // longest causal rows first
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);

  // keys this block may see: local key c is live for some row of the block
  // iff k_off + c <= q_off + min(q0 + BQ, Tq) - 1
  int kend = Tk;
  if (causal) {
    const long long lim = q_off + min(q0 + BQ, Tq) - k_off;
    kend = lim < 0 ? 0 : (lim < Tk ? (int)lim : Tk);
  }
  if (kend == 0) return;  // a fully-future shard: the carries stay as they are

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rowA = q0 + wg * 64 + warp * 16 + g, rowB = rowA + 8;

  // the incoming carries, in the accumulator layout; rows past Tq are never
  // stored
  float* mrow = m_io + (long long)bh * Tq;
  float* lrow = l_io + (long long)bh * Tq;
  const long long rowstride = (long long)H * D;
  float* accA = acc_io + ((long long)b * Tq + rowA) * rowstride + h * D;
  float* accB = accA + 8 * rowstride;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    float2 a = make_float2(0.f, 0.f), bb = make_float2(0.f, 0.f);
    if (rowA < Tq) a = *reinterpret_cast<const float2*>(accA + c);
    if (rowB < Tq) bb = *reinterpret_cast<const float2*>(accB + c);
    acc[4 * j] = a.x;
    acc[4 * j + 1] = a.y;
    acc[4 * j + 2] = bb.x;
    acc[4 * j + 3] = bb.y;
  }
  if (rowA < Tq) {
    m[0] = mrow[rowA];
    l[0] = lrow[rowA];
  }
  if (rowB < Tq) {
    m[1] = mrow[rowB];
    l[1] = lrow[rowB];
  }

  // key c is live for row r when c < Tk and, causal, r + diag >= c, with
  // diag the offsets' difference clamped to an int: every diag >= Tk makes
  // every key live, every diag <= -Tq none
  const long long d = q_off - k_off;
  const int diag = d > Tk ? Tk : (d < -(long long)Tq ? -Tq : (int)d);
  auto limit = [&](int row) {
    return causal ? max(0, min(Tk, row + diag + 1)) : Tk;
  };
  attend_kv_tiles<D>(smem, q + b * vq.sb + h * vq.sh, vq.st, q0, Tq,
                     k + b * vk.sb + hk * vk.sh, vk.st,
                     v + b * vv.sb + hk * vv.sh, vv.st, Tk, kend,
                     limit(rowA), limit(rowB), scale, m, l, acc);

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (rowA < Tq)
      *reinterpret_cast<float2*>(accA + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (rowB < Tq)
      *reinterpret_cast<float2*>(accB + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  if (t == 0) {
    if (rowA < Tq) {
      mrow[rowA] = m[0];
      lrow[rowA] = l[0];
    }
    if (rowB < Tq) {
      mrow[rowB] = m[1];
      lrow[rowB] = l[1];
    }
  }
}

template <int D>
int update(const void* q, const void* k, const void* v, void* m, void* l,
           void* acc, int B, int H, int Hkv, int Tq, int Tk,
           const long long* strides, long long q_off, long long k_off,
           int causal, cudaStream_t st) {
  const int bytes = fwd_smem_bytes<D>();
  cudaError_t err = allow_smem(ring_block_kernel<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tq + 127) / 128);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  ring_block_kernel<D><<<grid, kThreads, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(acc), H, Hkv, Tq, Tk,
      view_at(strides, 0), view_at(strides, 1), view_at(strides, 2), q_off,
      k_off, causal, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface. q is a (B, Tq, H, D) view and k, v are (B, Tk, Hkv, D)
// views given by `strides`, three element strides (batch, row, head) per
// tensor in the order q, k, v; m and l are contiguous (B * H, Tq) f32 and
// acc a contiguous (B, Tq, H, D) f32, all three updated in place. bf16
// inputs; D is 64 or 128; H a multiple of Hkv; every row 16-byte aligned
// (the Python wrapper checks all of it). Launches on `stream` and returns
// the CUDA error code (0 = success).
extern "C" int ring_block_update(const void* q, const void* k, const void* v,
                                 void* m, void* l, void* acc, int B, int H,
                                 int Hkv, int Tq, int Tk, int D,
                                 const long long* strides, long long q_off,
                                 long long k_off, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return update<128>(q, k, v, m, l, acc, B, H, Hkv, Tq, Tk, strides, q_off,
                       k_off, causal, st);
  if (D == 64)
    return update<64>(q, k, v, m, l, acc, B, H, Hkv, Tq, Tk, strides, q_off,
                      k_off, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
