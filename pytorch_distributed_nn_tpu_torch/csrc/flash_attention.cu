// Flash attention for Hopper (sm_90a): the forward and the two backward
// passes (dq; dk/dv), bf16 operands on the tensor cores, f32 statistics and
// accumulators.
//
// Replaces the TPU kernels of pytorch_distributed_nn_tpu/ops/pallas/
// flash_attention.py: `_flash_kernel` (launched by `_flash_bhtd`),
// `_bwd_dq_kernel` and `_bwd_dkv_kernel` (both launched by
// `_flash_bwd_pallas`). Same contract: causal or full softmax attention with
// grouped-query K/V (query head h reads K/V head h / (H / Hkv), K/V never
// expanded); the forward returns O and the per-row logsumexp
// lse = m + log(max(l, 1e-30)); the backward replays p = exp(s * scale - lse)
// from it, with ds = p * (dO.V^T - delta) * scale and delta = rowsum(dO * O)
// computed by the caller. Masked logits take the finite -1e30, never -inf,
// so no row produces a NaN. Dead causal tiles are skipped.
//
// Layout. Every tensor is read in place as a (B, T, heads, D) view given by
// three element strides (batch, row, head) with D contiguous: the model's
// projections feed the kernels without a transpose, and O / dq / dk / dv are
// written in the same layout. lse and delta are plain (B * H, T) f32.
//
// Arithmetic. The TPU kernel scales q before the f32 dot; here the
// products run on bf16 operands with f32 accumulation (mma.sync m16n8k16),
// and the f32 dot is scaled afterwards, which differs from scaling first by
// f32 rounding only (scaling the bf16 q first would add a bf16 rounding).
// p (and ds in the backward) are rounded to bf16 for their products, as the
// JAX package's xla path rounds its probabilities; l, m and every
// accumulator stay f32.
//
// What bounds it on an H100. At the long-context shapes (T = 32768, D = 128)
// attention does ~2T^2 D flops per head for ~8TD bytes: far above the 295
// flops per byte where the tensor cores, not memory, are the limit. The
// design keeps the (T, T) scores out of device memory (one (64, 64) tile of
// s lives in registers at a time) and feeds mma.sync from padded shared
// memory tiles (row pitch D + 8 elements: the fragment loads of one warp hit
// 32 distinct banks). One block of 4 warps owns a 64-row tile; each warp
// owns 16 rows. Tiles are loaded synchronously with 16-byte loads; wgmma,
// TMA, cp.async pipelining and warp specialisation are left for later.
// No atomics anywhere: every output element is summed in a fixed order, so
// the gradients are bitwise deterministic.

#include <cmath>

#include "tile_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// Forward: one block per (64-row Q tile, b * H + h); streams the K/V tiles of
// head h / G up to the diagonal (causal) or to T.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int T,
                     View vq, View vk, View vv, View vo, int causal,
                     float scale) {
  constexpr int BQ = 64, BK = 64, LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LD;
  bf16* sV = sK + BK * LD;

  const int nq = (T + BQ - 1) / BQ;
  const int qi = nq - 1 - (int)blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = qi * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rowA = q0 + warp * 16 + g, rowB = rowA + 8;

  const bf16* qb = q + b * vq.sb + h * vq.sh;
  const bf16* kb = k + b * vk.sb + hk * vk.sh;
  const bf16* vb = v + b * vv.sb + hk * vv.sh;

  load_tile<BQ, D>(sQ, qb, vq.st, q0, T);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(sQ, LD, warp * 16, kk * 16, qa[kk]);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int kend = causal ? min(T, q0 + BQ) : T;
  attend_kv_tiles<D>(sK, sV, kb, vb, vk.st, vv.st, kend, T, qa, rowA, rowB,
                     causal, 0, scale, m, l, acc);

  const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  bf16* ob = o + b * vo.sb + h * vo.sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (rowA < T)
      store_pair(ob, rowA * vo.st + c, acc[n][0] * inv0, acc[n][1] * inv0, 0);
    if (rowB < T)
      store_pair(ob, rowB * vo.st + c, acc[n][2] * inv1, acc[n][3] * inv1, 0);
  }
  if (t == 0) {
    float* lb = lse + (long long)bh * T;
    if (rowA < T) lb[rowA] = m[0] + logf(l0);
    if (rowB < T) lb[rowB] = m[1] + logf(l1);
  }
}

// ---------------------------------------------------------------------------
// Backward, dq pass: one block per (64-row Q tile, b * H + h); streams K/V
// tiles, replays p from lse and accumulates dq += ds k in f32.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, void* dq, int H,
                        int Hkv, int T, View vq, View vk, View vv, View vdo,
                        View vdq, int causal, float scale, int out_f32) {
  constexpr int BQ = 64, BK = 64, LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + BQ * LD;  // dO
  bf16* sK = sG + BQ * LD;
  bf16* sV = sK + BK * LD;

  const int nq = (T + BQ - 1) / BQ;
  const int qi = nq - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = qi * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rowA = q0 + warp * 16 + g, rowB = rowA + 8;

  const bf16* kb = k + b * vk.sb + hk * vk.sh;
  const bf16* vb = v + b * vv.sb + hk * vv.sh;
  load_tile<BQ, D>(sQ, q + b * vq.sb + h * vq.sh, vq.st, q0, T);
  load_tile<BQ, D>(sG, dout + b * vdo.sb + h * vdo.sh, vdo.st, q0, T);
  const float* lb = lse + (long long)bh * T;
  const float* db = delta + (long long)bh * T;
  const float lseA = rowA < T ? lb[rowA] : 0.f, lseB = rowB < T ? lb[rowB] : 0.f;
  const float dA = rowA < T ? db[rowA] : 0.f, dB = rowB < T ? db[rowB] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int kend = causal ? min(T, q0 + BQ) : T;
  const int nk = (kend + BK - 1) / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * BK;
    __syncthreads();
    load_tile<BK, D>(sK, kb, vk.st, k0, T);
    load_tile<BK, D>(sV, vb, vv.st, k0, T);
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], ga[4];
      load_a(sQ, LD, warp * 16, kk * 16, qa);
      load_a(sG, LD, warp * 16, kk * 16, ga);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t bb[2];
        load_b_nk(sK, LD, n * 8, kk * 16, bb);
        mma16816(s[n], qa, bb);
        load_b_nk(sV, LD, n * 8, kk * 16, bb);
        mma16816(dp[n], ga, bb);
      }
    }
    // p = exp(s * scale - lse); ds = p * (dp - delta) * scale, in s
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? rowA : rowB;
        const bool live = col < T && (!causal || row >= col);
        const float p = live ? __expf(s[n][e] * scale - (e < 2 ? lseA : lseB))
                             : 0.f;
        s[n][e] = p * (dp[n][e] - (e < 2 ? dA : dB)) * scale;
      }
    }
    // dq += ds k
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bb[2];
        load_b_kn(sK, LD, kk * 16, n * 8, bb);
        mma16816(acc[n], da, bb);
      }
    }
  }

  const long long base = b * vdq.sb + h * vdq.sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (rowA < T)
      store_pair(dq, base + rowA * vdq.st + c, acc[n][0], acc[n][1], out_f32);
    if (rowB < T)
      store_pair(dq, base + rowB * vdq.st + c, acc[n][2], acc[n][3], out_f32);
  }
}

// ---------------------------------------------------------------------------
// Backward, dk/dv pass: one block per (64-row K tile, b * Hkv + hk); walks
// the G query heads of the group and, for each, the Q tiles at or after the
// K tile (causal), accumulating dv += p^T dO and dk += ds^T q in one f32
// accumulator: the group reduction needs no second pass and no atomics.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, void* dk, void* dv,
                         int H, int Hkv, int T, View vq, View vk, View vv,
                         View vdo, View vdk, View vdv, int causal, float scale,
                         int out_f32) {
  constexpr int BK = 64, BQ = 32, LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;
  bf16* sG = sQ + BQ * LD;  // dO
  float* sL = reinterpret_cast<float*>(sG + BQ * LD);  // lse of the Q tile
  float* sD = sL + BQ;                                 // delta of the Q tile

  const int kj = blockIdx.x;  // early K tiles see the most Q tiles: first
  const int bhk = blockIdx.y, b = bhk / Hkv, hk = bhk % Hkv;
  const int G = H / Hkv;
  const int k0 = kj * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int keyA = k0 + warp * 16 + g, keyB = keyA + 8;

  load_tile<BK, D>(sK, k + b * vk.sb + hk * vk.sh, vk.st, k0, T);
  load_tile<BK, D>(sV, v + b * vv.sb + hk * vv.sh, vv.st, k0, T);

  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    adk[n][0] = adk[n][1] = adk[n][2] = adk[n][3] = 0.f;
    adv[n][0] = adv[n][1] = adv[n][2] = adv[n][3] = 0.f;
  }

  const int nq = (T + BQ - 1) / BQ;
  const int qstart = causal ? k0 / BQ : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi, bh = b * H + h;
    const bf16* qb = q + b * vq.sb + h * vq.sh;
    const bf16* gb = dout + b * vdo.sb + h * vdo.sh;
    const float* lb = lse + (long long)bh * T;
    const float* db = delta + (long long)bh * T;
    for (int qt = qstart; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_tile<BQ, D>(sQ, qb, vq.st, q0, T);
      load_tile<BQ, D>(sG, gb, vdo.st, q0, T);
      if (threadIdx.x < BQ) {
        const int r = q0 + threadIdx.x;
        sL[threadIdx.x] = r < T ? lb[r] : 0.f;
        sD[threadIdx.x] = r < T ? db[r] : 0.f;
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v dO^T, rows = this warp's 16 keys
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a(sK, LD, warp * 16, kk * 16, ka);
        load_a(sV, LD, warp * 16, kk * 16, va);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          uint32_t bb[2];
          load_b_nk(sQ, LD, n * 8, kk * 16, bb);
          mma16816(s[n], ka, bb);
          load_b_nk(sG, LD, n * 8, kk * 16, bb);
          mma16816(dp[n], va, bb);
        }
      }
      // p^T into s, ds^T into dp
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * t + (e & 1);  // column within the tile
          const int qrow = q0 + qc;
          const int key = e < 2 ? keyA : keyB;
          const bool live = qrow < T && key < T && (!causal || qrow >= key);
          const float p = live ? __expf(s[n][e] * scale - sL[qc]) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - sD[qc]) * scale;
        }
      }
      // dv += p^T dO; dk += ds^T q (k = the tile's query rows)
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                          pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                          pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                          pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t bb[2];
          load_b_kn(sG, LD, kk * 16, n * 8, bb);
          mma16816(adv[n], pa, bb);
          load_b_kn(sQ, LD, kk * 16, n * 8, bb);
          mma16816(adk[n], da, bb);
        }
      }
    }
  }

  const long long bk = b * vdk.sb + hk * vdk.sh;
  const long long bv = b * vdv.sb + hk * vdv.sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (keyA < T) {
      store_pair(dk, bk + keyA * vdk.st + c, adk[n][0], adk[n][1], out_f32);
      store_pair(dv, bv + keyA * vdv.st + c, adv[n][0], adv[n][1], out_f32);
    }
    if (keyB < T) {
      store_pair(dk, bk + keyB * vdk.st + c, adk[n][2], adk[n][3], out_f32);
      store_pair(dv, bv + keyB * vdv.st + c, adv[n][2], adv[n][3], out_f32);
    }
  }
}


template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int H, int Hkv, int T, const long long* strides, int causal,
        cudaStream_t st) {
  const int bytes = 3 * 64 * (D + kPad) * (int)sizeof(bf16);
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + 63) / 64, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, Hkv, T, view_at(strides, 0),
      view_at(strides, 1), view_at(strides, 2), view_at(strides, 3), causal,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int H,
           int Hkv, int T, const long long* strides, int causal, int out_f32,
           cudaStream_t st) {
  const int bytes = 4 * 64 * (D + kPad) * (int)sizeof(bf16);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + 63) / 64, B * H);
  flash_bwd_dq_kernel<D><<<grid, kThreads, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), dq, H,
      Hkv, T, view_at(strides, 0), view_at(strides, 1), view_at(strides, 2),
      view_at(strides, 3), view_at(strides, 4), causal,
      (float)(1.0 / sqrt((double)D)), out_f32);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int B,
            int H, int Hkv, int T, const long long* strides, int causal,
            int out_f32, cudaStream_t st) {
  const int bytes = (2 * 64 + 2 * 32) * (D + kPad) * (int)sizeof(bf16) +
                    2 * 32 * (int)sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + 63) / 64, B * Hkv);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), dk,
      dv, H, Hkv, T, view_at(strides, 0), view_at(strides, 1),
      view_at(strides, 2), view_at(strides, 3), view_at(strides, 4),
      view_at(strides, 5), causal, (float)(1.0 / sqrt((double)D)), out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface. Tensors are (B, T, heads, D) views given by `strides`,
// three element strides (batch, row, head) per tensor in the order of the
// pointer arguments (q, k, v, then the outputs); lse and delta are
// contiguous (B * H, T) f32. bf16 inputs; D is 64 or 128; H a multiple of
// Hkv; every row 16-byte aligned (the Python wrapper checks all of it).
// Each launches on `stream` and returns the CUDA error code (0 = success).

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int H, int Hkv, int T,
                         int D, const long long* strides, int causal,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return fwd<128>(q, k, v, o, lse, B, H, Hkv, T, strides, causal, st);
  if (D == 64) return fwd<64>(q, k, v, o, lse, B, H, Hkv, T, strides, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int H,
                            int Hkv, int T, int D, const long long* strides,
                            int causal, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return bwd_dq<128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, T, strides,
                       causal, out_f32, st);
  if (D == 64)
    return bwd_dq<64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, T, strides,
                      causal, out_f32, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int H, int Hkv, int T, int D,
                             const long long* strides, int causal,
                             int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return bwd_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, T,
                        strides, causal, out_f32, st);
  if (D == 64)
    return bwd_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, T,
                       strides, causal, out_f32, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
