// Fused Gumbel-softmax sampler for Hopper (sm_90a), float32.
//
// Replaces: gan_image_captioning_tpu/kernels/gumbel_sample.py, function
// `_kernel` (launched by `fused_gumbel_sample`).  For logits [B, V]:
//   u ~ U[0, 1) per (b, v): Philox keyed by the seed, counter (v, b, step, 0)
//       (philox_uniform in decode_common.cuh, the stream of the sample_resid
//       decode at its step `step`), or read from `u_in`
//   g = -log(-log(u + 1e-10) + 1e-10) ;  x = (logits + g) * temp
//   soft[b] = softmax(x[b]) ;  ids[b] = argmax(x[b])  (first index on ties)
// ids come from x, not from soft, as in the TPU kernel: a soft row can
// round two different x to the same probability.  The sum and the product
// are rounded separately (__fadd_rn, __fmul_rn), as PyTorch's eager
// `(logits + g) * temp` does.
//
// What bounds it on this card.  Bytes: one read of the logits and one write
// of soft, 8 bytes per element (16 with u_in / u_out): at B = 64 and
// V = 11008 that is 5.6 MB, 1.7 us at 3.35 TB/s.  The operations (Philox's
// ten rounds, two logs and an exp per element, about 60 in all) come to
// 42 M, 0.6 us at 67 TFLOP/s.
//
// What this design does about it.  It is the simple version: one block of
// 256 threads per row; a thread takes the columns v = tid, tid + 256, ...
// (neighbouring threads on neighbouring addresses).  Three passes over the
// row: x into soft (the row's own output serves as scratch, read back by
// the thread that wrote it) with the running max; sum(exp(x - max)); the
// normalised row.  The first index reaching the max is a block-wide
// minimum over the columns whose x equals it: the same first-index rule as
// first_argmax in decode_serve.cu, which combines per-tile maxima.
// At B = 64 only 64 of the 132 SMs have a block; splitting a row over
// several blocks (a second pass for the combine) is later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"

using namespace gic;

namespace {

constexpr int G_NT = 256;
constexpr int G_NW = G_NT / 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Block-wide reductions over G_NT threads; every thread gets the result.
__device__ __forceinline__ float block_max(float x, float* red) {
  x = warp_max(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < G_NW; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < G_NW; ++w) r += red[w];
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_min(int x, int* red) {
  x = warp_min(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  int r = red[0];
#pragma unroll
  for (int w = 1; w < G_NW; ++w) r = min(r, red[w]);
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(G_NT) gumbel_sample_kernel(
    const float* __restrict__ logits, int V, float temp,
    unsigned long long seed, int step, const float* __restrict__ u_in,
    float* __restrict__ u_out, float* __restrict__ soft,
    int32_t* __restrict__ ids) {
  __shared__ float redf[G_NW];
  __shared__ int redi[G_NW];
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t base = (size_t)b * V;
  float* row = soft + base;

  float mx = -INFINITY;
  for (int v = tid; v < V; v += G_NT) {
    const float u = u_in != nullptr ? u_in[base + v]
                                    : philox_uniform(seed, step, b, v);
    if (u_out != nullptr) u_out[base + v] = u;
    const float g = -logf(-logf(u + GUMBEL_EPS) + GUMBEL_EPS);
    const float x = __fmul_rn(__fadd_rn(logits[base + v], g), temp);
    row[v] = x;
    mx = fmaxf(mx, x);
  }
  const float m = block_max(mx, redf);

  int first = INT_MAX;
  float s = 0.f;
  for (int v = tid; v < V; v += G_NT) {
    const float x = row[v];
    if (x == m && v < first) first = v;
    s += expf(x - m);
  }
  first = block_min(first, redi);
  const float total = block_sum(s, redf);
  for (int v = tid; v < V; v += G_NT) row[v] = expf(row[v] - m) / total;
  if (tid == 0) ids[b] = first == INT_MAX ? 0 : first;
}

}  // namespace

extern "C" {

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// logits [B, V] -> soft [B, V], ids [B] on `stream`.  Noise: u_in [B, V]
// when not null, else Philox of (seed, step); the uniforms used go to u_out
// [B, V] when it is not null.  Returns 0 or the CUDA error code of the
// launch; nothing synchronises.
int gic_gumbel_sample(const float* logits, int B, int V, float temp,
                      unsigned long long seed, int step, const float* u_in,
                      float* u_out, float* soft, int32_t* ids, void* stream) {
  if (B < 1 || V < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gumbel_sample_kernel<<<B, G_NT, 0, s>>>(logits, V, temp, seed, step, u_in,
                                          u_out, soft, ids);
  return cudaGetLastError();
}

}  // extern "C"
