// Stochastic int8 quantization for Hopper (sm_90a):
//   q[i] = clip(floor(x[i] / scale + u[i]), -127, 127),  u[i] in [0, 1).
//
// Replaces the TPU kernel pytorch_distributed_nn_tpu/ops/pallas/quantize.py
// (`_quantize_kernel`, launched by `_quantize_tpu`), the encode step of the
// int8 wire of the bucketed gradient all-reduce (ops/buckets.py).
//
// The random numbers. The TPU kernel draws u from the core's hardware PRNG,
// whose bits exist nowhere else. Here u is a counter-based hash of (seed,
// flat element index): the murmur3 32-bit finaliser (fmix32), keyed by the
// seed, over the index; u is its top 24 bits times 2^-24. Keyed by the
// element's index, not by a block or a thread, the stream does not depend on
// the launch geometry, so the plain PyTorch version (ops/quantize.py) computes
// the same u and the two agree bit for bit. The division is IEEE (__fdiv_rn,
// and the source is built without --use_fast_math), as torch's is.
//
// What bounds it on an H100. Four bytes read and one written an element and
// a few integer operations: device memory bounds it (ResNet-50's 25.6M
// gradient elements, 128 MB, take 38 us at 3.35 TB/s). A grid-stride loop of
// 256-thread blocks, each thread four elements at a time: one 16-byte float4
// load and one 4-byte store; the ragged tail element by element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ int8_t quantize_one(float x, float scale,
                                               uint32_t key, uint64_t i) {
  const uint32_t hi = fmix32(key ^ static_cast<uint32_t>(i >> 32));
  const uint32_t h = fmix32(static_cast<uint32_t>(i) ^ hi);
  const float u = static_cast<float>(h >> 8) * (1.0f / 16777216.0f);
  float v = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(v));
}

__global__ void __launch_bounds__(256)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                uint32_t key, int64_t n, int8_t* __restrict__ out) {
  const float s = *scale;
  const int64_t nvec = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  char4* o4 = reinterpret_cast<char4*>(out);
  for (int64_t v = tid; v < nvec; v += stride) {
    const float4 xv = x4[v];
    const uint64_t i = static_cast<uint64_t>(v) * 4;
    o4[v] = make_char4(quantize_one(xv.x, s, key, i),
                       quantize_one(xv.y, s, key, i + 1),
                       quantize_one(xv.z, s, key, i + 2),
                       quantize_one(xv.w, s, key, i + 3));
  }
  for (int64_t i = nvec * 4 + tid; i < n; i += stride)
    out[i] = quantize_one(x[i], s, key, static_cast<uint64_t>(i));
}

}  // namespace

// out (n,) int8 = stochastic-rounded x (n,) f32 / *scale (a device scalar),
// with u from the hash keyed by `key` (the wrapper derives it from the seed).
// x must be 16-byte aligned and out 4-byte aligned (the wrapper checks).
// Launches on `stream` and returns the CUDA error code (0 = success).
extern "C" int quantize_int8(const void* x, const void* scale, uint32_t key,
                             int64_t n, void* out, int blocks, void* stream) {
  quantize_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale), key, n,
      static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
