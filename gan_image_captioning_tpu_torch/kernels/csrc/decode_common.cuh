// What the decode kernels share: the projection tile geometry (the
// embedding product of sample_embed), the row combine's thread count, and
// the Philox uniforms of the Gumbel noise, which the sample_resid decode
// (decode_serve.cu) and the fused Gumbel sampler (gumbel_sample.cu) draw
// from one stream.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_dot.cuh"

namespace gic {

// Projection tile: P_RT vocabulary rows, P_BT batch rows.
constexpr int P_RT = 64, P_BT = 32, P_TR = 4, P_TB = 2;
constexpr int P_NT = (P_RT / P_TR) * (P_BT / P_TB);  // 256 threads

constexpr int F_NT = 128;  // threads of a row's rescaled sum

constexpr float GUMBEL_EPS = 1e-10f;  // the reference's add_gumbel eps

// Philox4x32-10 (Salmon et al., SC'11), first output word.
__device__ __forceinline__ uint32_t philox_x(uint32_t c0, uint32_t c1,
                                             uint32_t c2, uint32_t c3,
                                             uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// U[0, 1) of (step t, row b, column v) under `seed`: Philox keyed by the
// seed, counter (v, b, t, 0), the top 24 bits of the first word times 2^-24
// (the TPU kernels' construction from 32 random bits).
__device__ __forceinline__ float philox_uniform(uint64_t seed, int t, int b,
                                                int v) {
  const uint32_t bits = philox_x((uint32_t)v, (uint32_t)b, (uint32_t)t, 0u,
                                 (uint32_t)seed, (uint32_t)(seed >> 32));
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

struct ProjRows {
  int v0, V;
  __device__ int operator()(int r) const {
    const int v = v0 + r;
    return v < V ? v : -1;
  }
};

}  // namespace gic
