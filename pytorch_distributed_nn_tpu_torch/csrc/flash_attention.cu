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
// products run on bf16 operands with f32 accumulation, and the f32 dot is
// scaled afterwards, which differs from scaling first by f32 rounding only
// (scaling the bf16 q first would add a bf16 rounding). p (and ds in the
// backward) are rounded to bf16 for their products, as the JAX package's
// xla path rounds its probabilities; l, m and every accumulator stay f32.
//
// What bounds it on an H100. At the long-context shapes (T = 32768, D = 128)
// attention does ~2T^2 D flops per head for ~8TD bytes: far above the 295
// flops per byte where the tensor cores, not memory, are the limit. Every
// kernel keeps the (T, T) scores out of device memory: one tile of s lives
// in registers at a time.
//
// All three kernels are built for Hopper (wgmma_tile.cuh). What held the
// first, mma.sync design back: mma.sync reaches about two thirds of the
// tensor-core peak at best, only wgmma the whole of it; a synchronous tile
// load leaves the tensor cores idle while it waits; and 4 warps a block,
// lock-stepped by a __syncthreads a tile, leave them idle again while every
// warp computes exp (and ds). So:
// - each block runs two warpgroups of 64 rows each on wgmma: the score
//   products (s, and dp in the backward) as m64n128k16 (forward) or
//   m64n64k16 (backward) with both operands in shared memory, then the
//   products that consume them (p V; dq, dk, dv) with the f32 scores packed
//   to bf16 as the register A operand and the other factor read through an
//   MN-major (transposed) descriptor of the same shared tile: no tile is
//   transposed;
// - the streamed tiles come through a ring of cp.async stages into
//   128-byte-swizzled shared memory, tracked by mbarriers instead of
//   __syncthreads, so the next tile's copy is in flight while this one
//   computes and the two warpgroups run out of step;
// - the warpgroups take turns (two named barriers) to issue their products,
//   so one warpgroup's exp overlaps the other's tensor-core work.
// The forward takes 128 query rows a block (Q loaded once) and streams
// 128-key K/V tiles through the K loop it shares with ring_attention.cu
// (attend_kv_tiles): s of tile i and p V of tile i - 1 in one turn. The
// dk/dv pass takes 128 keys a block (K and V loaded once) and streams 64-row
// Q/dO tiles with their lse and delta; the dq pass takes 128 query rows (Q
// and dO loaded once) and streams 64-key K/V tiles. The backward applies the
// mask on every tile, the forward on the tiles that a warp does not see
// whole; rows and keys at or past T get p = 0 from it (the zero-filled
// copies only keep the products finite). Registers bound the design: a dk/dv
// thread holds dk and dv (64 + 64 f32 at D 128) besides s^T and dp^T
// (32 + 32) and the packed p^T and ds^T of the previous tile (16 + 16), so a
// block has 256 threads, one block an SM.
// No atomics anywhere: every output element is summed in a fixed order (the
// dk/dv pass sums the K/V head's query-head group in its own accumulator),
// so the outputs are bitwise deterministic.

#include <cmath>

#include "wgmma_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// Forward: one block per (128-row Q tile, b * H + h); the shared K loop
// (attend_kv_tiles) streams the K/V tiles of head h / G up to the block's
// last row (causal) or to T, then O = acc / l in bf16 and
// lse = m + log(l), l floored at 1e-30.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int T,
                     View vq, View vk, View vv, View vo, int causal,
                     float scale) {
  constexpr int BQ = 128;
  extern __shared__ unsigned char smem[];
  const int nq = (T + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQ;  // longest causal rows first
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rowA = q0 + wg * 64 + warp * 16 + g, rowB = rowA + 8;
  // key c is live for a row when c < its limit: T, or row + 1 (causal)
  const int hiA = causal ? min(T, rowA + 1) : T;
  const int hiB = causal ? min(T, rowB + 1) : T;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int kend = causal ? min(T, q0 + BQ) : T;
  attend_kv_tiles<D>(smem, q + b * vq.sb + h * vq.sh, vq.st, q0, T,
                     k + b * vk.sb + hk * vk.sh, vk.st,
                     v + b * vv.sb + hk * vv.sh, vv.st, T, kend, hiA, hiB,
                     scale, m, l, acc);

  const float lA = fmaxf(l[0], 1e-30f), lB = fmaxf(l[1], 1e-30f);
  const float invA = 1.f / lA, invB = 1.f / lB;
  bf16* ob = o + b * vo.sb + h * vo.sh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (rowA < T)
      store_pair(ob, rowA * vo.st + c, acc[4 * j] * invA,
                 acc[4 * j + 1] * invA, 0);
    if (rowB < T)
      store_pair(ob, rowB * vo.st + c, acc[4 * j + 2] * invB,
                 acc[4 * j + 3] * invB, 0);
  }
  if (t == 0) {
    float* lb = lse + (long long)bh * T;
    if (rowA < T) lb[rowA] = m[0] + logf(lA);
    if (rowB < T) lb[rowB] = m[1] + logf(lB);
  }
}

// ---------------------------------------------------------------------------
// The backward passes: two warpgroups (256 threads) a block, each owning 64
// rows of the block's tile, on wgmma, the streamed tiles passing through the
// ring of wgmma_tile.cuh and the warpgroups taking turns to issue their
// products. In its turn at tile i a warpgroup issues tile i's score
// products and tile i - 1's gradient products (whose A operand, the packed
// p or ds, it made after its last turn; zeros at i = 0), and it waits for
// all of them within the tile: no product is in flight across a branch or
// the loop's back edge, so ptxas keeps the wgmma pipeline. A tile with
// nothing live for a warpgroup (past the diagonal or past T; at T = 32768
// under 1% of the tiles) is computed like any other and masked to p = 0.
// The copy of tile i + 1 is issued at tile i into the stage of tile
// i + 1 - kStages, which both warpgroups released at least a tile earlier.
// ---------------------------------------------------------------------------
constexpr int kStages = 4;  // the backward passes' ring

// ---------------------------------------------------------------------------
// dq pass: one block per (128-row Q tile, b * H + h). Q and dO are loaded
// once; 64-key K/V tiles of head h / G stream up to the diagonal (causal) or
// to T. Per tile and warpgroup: s = q k^T and dp = dO v^T (shared-memory
// wgmma, K-major both), p = 2^(s scale log2e - lse log2e), ds = p (dp -
// delta) scale, then dq += ds k with ds as the register A operand and k as
// an MN-major B operand of the same shared tile.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, void* dq, int H,
                        int Hkv, int T, View vq, View vk, View vv, View vdo,
                        View vdq, int causal, float scale, int out_f32) {
  constexpr int BQ = 128, BK = 64;
  constexpr int kQ = BQ * D * 2, kKV = BK * D * 2;  // tile bytes
  extern __shared__ unsigned char smem[];
  const uint32_t sQ = align1024(smem_u32(smem)), sG = sQ + kQ;  // dO
  const uint32_t sKV = sG + kQ;  // stage s: K at sKV + 2 s kKV, V after it
  const Ring<kStages> ring{sKV + kStages * 2 * kKV};
  ring.init();

  const int nq = (T + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQ;  // longest causal rows first
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int qw0 = q0 + wg * 64;  // the warpgroup's first row
  const int rowA = qw0 + warp * 16 + g, rowB = rowA + 8;

  const bf16* kb = k + b * vk.sb + hk * vk.sh;
  const bf16* vb = v + b * vv.sb + hk * vv.sh;
  const float* lb = lse + (long long)bh * T;
  const float* db = delta + (long long)bh * T;
  const float lA = rowA < T ? lb[rowA] * kLog2e : 0.f;  // lse in log2 units
  const float lB = rowB < T ? lb[rowB] * kLog2e : 0.f;
  const float dA = rowA < T ? db[rowA] : 0.f, dB = rowB < T ? db[rowB] : 0.f;
  const float sl2 = scale * kLog2e;
  // key c is live for a row below T when c < the row's limit: T, or row + 1
  // (causal)
  const int hiA = rowA < T ? (causal ? min(T, rowA + 1) : T) : 0;
  const int hiB = rowB < T ? (causal ? min(T, rowB + 1) : T) : 0;

  const int kend = causal ? min(T, q0 + BQ) : T;
  const int n = (kend + BK - 1) / BK;
  auto stage = [&](int i) { return sKV + (i % kStages) * 2 * kKV; };  // K
  auto issue = [&](int j) {  // this thread's share of K/V tile j
    if (j >= n) return;
    ring.acquire(j);
    load_tile_sw128<BK, D, kThreads>(stage(j), kb, vk.st, j * BK, T);
    load_tile_sw128<BK, D, kThreads>(stage(j) + kKV, vb, vv.st, j * BK,
                                        T);
    ring.commit(j);
  };
  load_tile_sw128<BQ, D, kThreads>(sQ, q + b * vq.sb + h * vq.sh, vq.st,
                                      q0, T);
  load_tile_sw128<BQ, D, kThreads>(sG, dout + b * vdo.sb + h * vdo.sh,
                                      vdo.st, q0, T);
  issue(0);  // Q and dO land with tile 0
  if (wg == 1) turn_end(1);  // warpgroup 0 takes the first turn

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t da[4][4] = {};  // ds of tile i - 1, packed: the turn's A operand

  for (int i = 0; i < n; ++i) {
    issue(i + 1);
    ring.wait(i);
    const int k0 = i * BK;
    const uint32_t sK = stage(i), sV = sK + kKV;

    float s[32], dp[32];
    turn_begin(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor<BQ>(sQ, wg * 64, kk),
                   desc_kmajor<BK>(sK, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor<BQ>(sG, wg * 64, kk),
                   desc_kmajor<BK>(sV, 0, kk), kk);
    wgmma_commit();
    // dq += ds k for tile i - 1 (at i = 0: zeros against tile 0)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, da[kk], desc_mnmajor<BK>(stage(i > 0 ? i - 1 : 0), kk));
    wgmma_commit();
    turn_end(wg);

    wgmma_wait<2>();  // s is in; dp and the dq product may still run
    fence_regs(s);
    // every tile applies the mask (one compare and select an element;
    // measured cheaper than a branch around it): column 8j + 2t + (e & 1)
    // of the tile is live below the row's limit
    const int cA = hiA - k0 - 2 * t, cB = hiB - k0 - 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[4 * j + e] * sl2 - (e < 2 ? lA : lB));
        s[4 * j + e] = 8 * j + (e & 1) < (e < 2 ? cA : cB) ? p : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    fence_regs(acc);
    fence_regs(da);
    // ds, packed: the A fragment of k step kk is columns [16 kk, 16 kk + 16)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i0 = 8 * kk + 2 * x;
        const float dr = (x & 1) ? dB : dA;
        da[kk][x] = pack_bf16(s[i0] * (dp[i0] - dr) * scale,
                              s[i0 + 1] * (dp[i0 + 1] - dr) * scale);
      }
    }
    if (i > 0) ring.release(i - 1);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, da[kk], desc_mnmajor<BK>(stage(n - 1), kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  if (wg == 0) turn_begin(0);  // warpgroup 1's last turn_end

  const long long base = b * vdq.sb + h * vdq.sh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (rowA < T)
      store_pair(dq, base + rowA * vdq.st + c, acc[4 * j], acc[4 * j + 1],
                 out_f32);
    if (rowB < T)
      store_pair(dq, base + rowB * vdq.st + c, acc[4 * j + 2],
                 acc[4 * j + 3], out_f32);
  }
}

// ---------------------------------------------------------------------------
// dk/dv pass: one block per (128-key tile, b * Hkv + hk). K and V are loaded
// once; the block walks the G query heads of the group and, for each, the
// 64-row Q tiles at or after the K tile (causal), streaming Q, dO, lse and
// delta. Keys are the wgmma M rows: s^T = k q^T and dp^T = v dO^T from
// shared memory, then dv += p^T dO and dk += ds^T q with p^T and ds^T as
// register A operands and dO and q as MN-major B operands. One f32
// accumulator a key for the whole group: no second pass, no atomics.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, void* dk, void* dv,
                         int H, int Hkv, int T, View vq, View vk, View vv,
                         View vdo, View vdk, View vdv, int causal, float scale,
                         int out_f32) {
  constexpr int BK = 128, BQ = 64;
  constexpr int kKV = BK * D * 2, kQ = BQ * D * 2;  // tile bytes
  extern __shared__ unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t sK = align1024(s0), sV = sK + kKV;
  const uint32_t sQG = sV + kKV;  // stage s: Q at sQG + 2 s kQ, dO after it
  // stage s: the Q tile's lse at [2 s BQ, 2 s BQ + BQ), its delta after it
  const uint32_t sLD = sQG + kStages * 2 * kQ;
  const float* lds = reinterpret_cast<const float*>(smem + (sLD - s0));
  const Ring<kStages> ring{sLD + kStages * 2 * BQ * 4};
  ring.init();

  const int bhk = blockIdx.x, b = bhk / Hkv, hk = bhk % Hkv, G = H / Hkv;
  const int k0 = blockIdx.y * BK;  // early K tiles see the most Q tiles: first
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + wg * 64;  // the warpgroup's first key
  const int keyA = kw0 + warp * 16 + g, keyB = keyA + 8;

  const int nq = (T + BQ - 1) / BQ;
  const int qstart = causal ? k0 / BQ : 0, nqt = nq - qstart, n = G * nqt;
  auto stage = [&](int i) { return sQG + (i % kStages) * 2 * kQ; };  // Q
  // the group's first query head, for the copies; head gi of the group is
  // gi head strides on (32-bit strides keep the loop's registers down)
  const bf16* qg = q + b * vq.sb + hk * G * vq.sh;
  const bf16* gg = dout + b * vdo.sb + hk * G * vdo.sh;
  const int qst = (int)vq.st, qsh = (int)vq.sh;
  const int gst = (int)vdo.st, gsh = (int)vdo.sh;
  const float* sg = (threadIdx.x < BQ ? lse : delta) +
                    (long long)(b * H + hk * G) * T;  // lse or delta rows
  auto issue = [&](int j) {  // this thread's share of Q tile j (head j / nqt)
    if (j >= n) return;
    ring.acquire(j);
    const int gi = j / nqt, q0 = (qstart + j % nqt) * BQ;
    load_tile_sw128<BQ, D, kThreads>(stage(j), qg + gi * qsh, qst, q0, T);
    load_tile_sw128<BQ, D, kThreads>(stage(j) + kQ, gg + gi * gsh, gst,
                                        q0, T);
    if (threadIdx.x < 2 * BQ) {
      const int r = q0 + (threadIdx.x & (BQ - 1));
      cp_async4(sLD + ((j % kStages) * 2 * BQ + threadIdx.x) * 4,
                sg + gi * T + (r < T ? r : 0), r < T);
    }
    ring.commit(j);
  };
  load_tile_sw128<BK, D, kThreads>(sK, k + b * vk.sb + hk * vk.sh, vk.st,
                                      k0, T);
  load_tile_sw128<BK, D, kThreads>(sV, v + b * vv.sb + hk * vv.sh, vv.st,
                                      k0, T);
  issue(0);  // K and V land with tile 0
  if (wg == 1) turn_end(1);  // warpgroup 0 takes the first turn

  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
  const float sl2 = scale * kLog2e;
  // query row r is live for a key below T when lo <= r < T; lo is the key
  // (causal) or 0
  const int loA = causal ? keyA : 0, hiA = keyA < T ? T : 0;
  const int loB = causal ? keyB : 0, hiB = keyB < T ? T : 0;
  // p^T and ds^T of tile i - 1, packed: the turn's A operands
  uint32_t pa[4][4] = {}, da[4][4] = {};

  for (int i = 0; i < n; ++i) {
    issue(i + 1);
    ring.wait(i);
    const int q0 = (qstart + i % nqt) * BQ;
    const uint32_t sQ = stage(i), sG = sQ + kQ;
    const uint32_t sQp = stage(i > 0 ? i - 1 : 0);  // zeros against tile 0
    const float* sL = lds + (i % kStages) * 2 * BQ;
    const float* sD = sL + BQ;

    float s[32], dp[32];
    turn_begin(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor<BK>(sK, wg * 64, kk),
                   desc_kmajor<BQ>(sQ, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor<BK>(sV, wg * 64, kk),
                   desc_kmajor<BQ>(sG, 0, kk), kk);
    wgmma_commit();
    // dv += p^T dO and dk += ds^T q for tile i - 1
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(adv, pa[kk], desc_mnmajor<BQ>(sQp + kQ, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(adk, da[kk], desc_mnmajor<BQ>(sQp, kk));
    wgmma_commit();
    turn_end(wg);

    wgmma_wait<2>();  // s^T is in; dp^T and the dv, dk products may run
    fence_regs(s);
    // every tile applies the mask (measured cheaper than a branch around
    // it): query column 8j + 2t + (e & 1) of the tile is live in the key's
    // window [lo, hi)
    const int b0 = q0 + 2 * t;
    const int lA = loA - b0, hA = hiA - b0, lB = loB - b0, hB = hiB - b0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(sL + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + (e & 1);
        const bool live = e < 2 ? c >= lA && c < hA : c >= lB && c < hB;
        const float p =
            ex2(s[4 * j + e] * sl2 - ((e & 1) ? l2.y : l2.x) * kLog2e);
        s[4 * j + e] = live ? p : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    fence_regs(adv);
    fence_regs(adk);
    fence_regs(pa);
    fence_regs(da);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i0 = 8 * kk + 2 * x;
        const float2 d2 = *reinterpret_cast<const float2*>(
            sD + 16 * kk + 8 * (x >> 1) + 2 * t);
        pa[kk][x] = pack_bf16(s[i0], s[i0 + 1]);
        da[kk][x] = pack_bf16(s[i0] * (dp[i0] - d2.x) * scale,
                              s[i0 + 1] * (dp[i0 + 1] - d2.y) * scale);
      }
    }
    if (i > 0) ring.release(i - 1);
  }
  const uint32_t sQp = stage(n - 1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(adv, pa[kk], desc_mnmajor<BQ>(sQp + kQ, kk));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(adk, da[kk], desc_mnmajor<BQ>(sQp, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(adv);
  fence_regs(adk);
  if (wg == 0) turn_begin(0);  // warpgroup 1's last turn_end

  const long long bk = b * vdk.sb + hk * vdk.sh;
  const long long bv = b * vdv.sb + hk * vdv.sh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (keyA < T) {
      store_pair(dk, bk + keyA * vdk.st + c, adk[4 * j], adk[4 * j + 1],
                 out_f32);
      store_pair(dv, bv + keyA * vdv.st + c, adv[4 * j], adv[4 * j + 1],
                 out_f32);
    }
    if (keyB < T) {
      store_pair(dk, bk + keyB * vdk.st + c, adk[4 * j + 2],
                 adk[4 * j + 3], out_f32);
      store_pair(dv, bv + keyB * vdv.st + c, adv[4 * j + 2],
                 adv[4 * j + 3], out_f32);
    }
  }
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int H, int Hkv, int T, const long long* strides, int causal,
        cudaStream_t st) {
  const int bytes = fwd_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (T + 127) / 128);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
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
  // alignment slack, Q and dO, kStages x (K and V), the ring's mbarriers
  const int bytes = 1024 + 2 * 128 * D * 2 + kStages * 2 * 64 * D * 2 +
                    2 * kStages * 8;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (T + 127) / 128);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
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
  // the loop reads q and dO by 32-bit row and head strides
  const long long wide = strides[1] | strides[2] | strides[10] | strides[11];
  if (wide > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // alignment slack, K and V, kStages x (Q, dO, lse and delta), mbarriers
  const int bytes = 1024 + 2 * 128 * D * 2 +
                    kStages * (2 * 64 * D * 2 + 2 * 64 * (int)sizeof(float)) +
                    2 * kStages * 8;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hkv, (T + 127) / 128);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
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
