// BatchNorm statistics for Hopper (sm_90a): per-channel f32 sums over the
// rows of an (M, C) channels-minor matrix.
//
//   forward mode:  s1 = sum_rows a,  s2 = sum_rows a * a
//   backward mode: s1 = sum_rows a,  s2 = sum_rows a * b
//
// Replaces the TPU kernel pytorch_distributed_nn_tpu/ops/pallas/bn_stats.py
// (`_run`, called by `sum_and_sumsq` and `sum_and_dot`). The inputs are bf16
// or f32 (a and b of one type); the sums are f32, as on the TPU.
//
// What bounds it on an H100. Each input element is read once and takes two
// or three f32 operations, so the call is bound by device memory: the 53
// BatchNorms of ResNet-50 at batch 256 read 5.7 GB of bf16 in the forward
// (1.7 ms at 3.35 TB/s) and twice that in the backward. The TPU design (one
// sequential grid carrying a VMEM accumulator, rows folded into the 128
// lanes when C < 128) does not carry over: blocks here run in parallel and
// in no order. The design instead:
//   - a thread owns two adjacent channels and loads them as one bf16x2 (or
//     float2), so the 32 threads of a warp read 64 contiguous channels of a
//     row; a block is 32 x 8 threads, its eight warps on eight rows;
//   - a block walks one stripe of rows, four rows a thread per iteration
//     (independent loads in flight); the four rows are summed in f32 and
//     added to f64 partials in registers;
//   - the block's eight row lanes are summed in shared memory in a fixed
//     order, and the block writes one f64 partial per channel for its
//     stripe;
//   - a second small kernel sums the stripes' partials in f64 in a fixed
//     order and rounds once to f32.
// Why f64 partials: BatchNorm takes the variance and the backward's
// projection from raw moments (sum x*x / m - mean^2; sum dy*x - mean *
// sum dy, the JAX package's formulas), which cancel where a channel's mean
// is large against its spread. A long f32 running sum's last bits then
// reach the gradients; f64 partials keep the sums at one f32 rounding of
// the exact value. The memory-bound pass pays one f64 add per four rows.
// No atomics: the sums, and the BatchNorm gradients built on them, are
// bitwise the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsX = 32;   // channel pairs a block: 64 channels
constexpr int kThreadsY = 8;    // row lanes a block
constexpr int kUnroll = 4;      // rows a thread loads per iteration

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p, bool vec,
                                            bool two) {
  if (vec)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return make_float2(__bfloat162float(p[0]),
                     two ? __bfloat162float(p[1]) : 0.f);
}

__device__ __forceinline__ float2 load_pair(const float* p, bool vec,
                                            bool two) {
  if (vec) return *reinterpret_cast<const float2*>(p);
  return make_float2(p[0], two ? p[1] : 0.f);
}

// One partial sum per (stripe, channel): p1/p2 are (stripes, C) f64.
// vec: C is even and both inputs are aligned to a pair, so every pair is one
// aligned vector load.
template <typename T, bool kDot>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
bn_partial(const T* __restrict__ a, const T* __restrict__ b, int64_t m,
           int c, int64_t rows_per_stripe, bool vec, double* __restrict__ p1,
           double* __restrict__ p2) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = (blockIdx.x * kThreadsX + tx) * 2;
  const bool live = c0 < c;
  const bool two = c0 + 1 < c;
  const int64_t r_begin = (int64_t)blockIdx.y * rows_per_stripe;
  const int64_t r_end =
      r_begin + rows_per_stripe < m ? r_begin + rows_per_stripe : m;
  double s1x = 0.0, s1y = 0.0, s2x = 0.0, s2y = 0.0;
  if (live) {
    int64_t r = r_begin + ty;
    for (; r + (kUnroll - 1) * kThreadsY < r_end; r += kUnroll * kThreadsY) {
      float2 va[kUnroll], vb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t off = (r + u * kThreadsY) * c + c0;
        va[u] = load_pair(a + off, vec, two);
        vb[u] = kDot ? load_pair(b + off, vec, two) : va[u];
      }
      // the four rows summed pairwise in f32, then one f64 add each
      s1x += (va[0].x + va[1].x) + (va[2].x + va[3].x);
      s1y += (va[0].y + va[1].y) + (va[2].y + va[3].y);
      s2x += (va[0].x * vb[0].x + va[1].x * vb[1].x) +
             (va[2].x * vb[2].x + va[3].x * vb[3].x);
      s2y += (va[0].y * vb[0].y + va[1].y * vb[1].y) +
             (va[2].y * vb[2].y + va[3].y * vb[3].y);
    }
    for (; r < r_end; r += kThreadsY) {
      const int64_t off = r * c + c0;
      const float2 va = load_pair(a + off, vec, two);
      const float2 vb = kDot ? load_pair(b + off, vec, two) : va;
      s1x += va.x;
      s1y += va.y;
      s2x += va.x * vb.x;
      s2y += va.y * vb.y;
    }
  }
  __shared__ double sh[4][kThreadsY][kThreadsX];
  sh[0][ty][tx] = s1x;
  sh[1][ty][tx] = s1y;
  sh[2][ty][tx] = s2x;
  sh[3][ty][tx] = s2y;
  __syncthreads();
  if (ty != 0 || !live) return;
  double t[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int y = 0; y < kThreadsY; ++y)
#pragma unroll
    for (int k = 0; k < 4; ++k) t[k] += sh[k][y][tx];
  const int64_t o = (int64_t)blockIdx.y * c + c0;
  p1[o] = t[0];
  p2[o] = t[2];
  if (two) {
    p1[o + 1] = t[1];
    p2[o + 1] = t[3];
  }
}

// out[ch] = sum over stripes of p[stripe][ch] in f64, in a fixed order
// (thread row ty sums stripes ty, ty + 8, ...; then row 0 adds the eight
// row sums), rounded once to f32.
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
bn_finish(const double* __restrict__ p1, const double* __restrict__ p2,
          int stripes, int c, float* __restrict__ out1,
          float* __restrict__ out2) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * kThreadsX + tx;
  double t1 = 0.0, t2 = 0.0;
  if (ch < c) {
    for (int s = ty; s < stripes; s += kThreadsY) {
      t1 += p1[(int64_t)s * c + ch];
      t2 += p2[(int64_t)s * c + ch];
    }
  }
  __shared__ double sh[2][kThreadsY][kThreadsX];
  sh[0][ty][tx] = t1;
  sh[1][ty][tx] = t2;
  __syncthreads();
  if (ty != 0 || ch >= c) return;
  double u1 = 0.0, u2 = 0.0;
#pragma unroll
  for (int y = 0; y < kThreadsY; ++y) {
    u1 += sh[0][y][tx];
    u2 += sh[1][y][tx];
  }
  out1[ch] = static_cast<float>(u1);
  out2[ch] = static_cast<float>(u2);
}

template <typename T>
int launch(const void* a, const void* b, int64_t m, int c, int dot, int vec,
           int stripes, int64_t rows_per_stripe, double* p1, double* p2,
           cudaStream_t st) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((c + 2 * kThreadsX - 1) / (2 * kThreadsX), stripes);
  const T* at = static_cast<const T*>(a);
  if (dot)
    bn_partial<T, true><<<grid, block, 0, st>>>(
        at, static_cast<const T*>(b), m, c, rows_per_stripe, vec != 0, p1,
        p2);
  else
    bn_partial<T, false><<<grid, block, 0, st>>>(
        at, at, m, c, rows_per_stripe, vec != 0, p1, p2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (s1, s2) (C,) f32 of an (M, C) matrix a (and b in the dot mode), dtype 0
// = f32, 1 = bf16. p1/p2 are (stripes, C) f64 workspaces; stripe s covers
// rows [s * rows_per_stripe, (s + 1) * rows_per_stripe). vec != 0 when C is
// even and a, b are aligned to a channel pair (the wrapper checks). Launches
// on `stream` and returns the CUDA error code of the launches (0 = success).
extern "C" int bn_stats(const void* a, const void* b, int dtype, int64_t m,
                        int c, int dot, int vec, int stripes,
                        int64_t rows_per_stripe, void* p1, void* p2,
                        void* out1, void* out2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* p1f = static_cast<double*>(p1);
  double* p2f = static_cast<double*>(p2);
  int rc;
  if (dtype == 0)
    rc = launch<float>(a, b, m, c, dot, vec, stripes, rows_per_stripe, p1f,
                       p2f, st);
  else if (dtype == 1)
    rc = launch<__nv_bfloat16>(a, b, m, c, dot, vec, stripes,
                               rows_per_stripe, p1f, p2f, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((c + kThreadsX - 1) / kThreadsX);
  bn_finish<<<grid, block, 0, st>>>(p1f, p2f, stripes, c,
                                    static_cast<float*>(out1),
                                    static_cast<float*>(out2));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bn_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
