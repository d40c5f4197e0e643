// The quantized serve decode's (decode_qserve.cu) building blocks: the
// tile geometry, the LSTM cell update of one gate tile, the per-tile
// softmax statistics of one projection tile, the per-row combine of those
// statistics, and the host-side handling of the (h, c, x) state, fresh or
// carried in from an earlier chunk.  The dense persistent decode
// (decode_serve.cu) repeats their arithmetic in the same order, which
// keeps the two bit-equal on dequantized weights.  Also the Philox
// uniforms of the Gumbel noise, which the sample_resid decode and the
// fused Gumbel sampler (gumbel_sample.cu) draw from one stream.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_dot.cuh"

namespace gic {

// LSTM layer tile: JT hidden units -> 4*JT gate rows, L_BT batch rows.
constexpr int JT = 4;
constexpr int L_RT = 4 * JT, L_BT = 32, L_TR = 2, L_TB = 2;
constexpr int L_NT = (L_RT / L_TR) * (L_BT / L_TB);  // 128 threads

// Projection tile: P_RT vocabulary rows, P_BT batch rows.
constexpr int P_RT = 64, P_BT = 32, P_TR = 4, P_TB = 2;
constexpr int P_NT = (P_RT / P_TR) * (P_BT / P_TB);  // 256 threads

constexpr int F_NT = 128;  // finalize threads per row

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

// Gate row of local row r = g*JT + u: rows j, H+j, 2H+j, 3H+j of the
// torch-layout [4H, K] weights (columns of a [K, 4H] one) for hidden unit
// j = j0 + u; -1 past H.
struct LstmRows {
  int j0, H;
  __device__ int operator()(int r) const {
    const int j = j0 + r % JT;
    return j < H ? (r / JT) * H + j : -1;
  }
};

struct ProjRows {
  int v0, V;
  __device__ int operator()(int r) const {
    const int v = v0 + r;
    return v < V ? v : -1;
  }
};

// The cell update of one LSTM tile (hidden units [j0, j0+JT), batch rows
// [b0, b0+L_BT)) from its gate pre-activations Gs (without bias).  c is
// updated in place; h goes to h_next (the other ping-pong half) because
// other blocks still read the old h.  hs_out / cs_out [B, H] and
// gates_out [B, 4H] (residuals) are written when not null.
__device__ __forceinline__ void lstm_cell_tile(
    const float (*Gs)[L_BT + 1], const float* __restrict__ bias, int j0,
    int b0, int B, int H, float* __restrict__ c, float* __restrict__ h_next,
    float* __restrict__ hs_out, float* __restrict__ cs_out,
    float* __restrict__ gates_out) {
  for (int e = threadIdx.x; e < JT * L_BT; e += L_NT) {
    const int u = e % JT, bl = e / JT, j = j0 + u, b = b0 + bl;
    if (j >= H || b >= B) continue;
    const float pi = Gs[0 * JT + u][bl] + bias[0 * H + j];
    const float pf = Gs[1 * JT + u][bl] + bias[1 * H + j];
    const float pg = Gs[2 * JT + u][bl] + bias[2 * H + j];
    const float po = Gs[3 * JT + u][bl] + bias[3 * H + j];
    const float gi = sigmoidf(pi), gf = sigmoidf(pf);
    const float gg = tanhf(pg), go = sigmoidf(po);
    const size_t o = (size_t)b * H + j;
    const float cn = gf * c[o] + gi * gg;
    const float hn = go * tanhf(cn);
    c[o] = cn;
    h_next[o] = hn;
    if (gates_out != nullptr) {
      float* g = gates_out + (size_t)b * 4 * H + j;
      g[0] = pi;
      g[H] = pf;
      g[2 * H] = pg;
      g[3 * H] = po;
      hs_out[o] = hn;
      cs_out[o] = cn;
    }
  }
}

// Per batch row of one projection tile (logits Ls [P_BT][P_RT + 1], bias
// added): the tile's max, first argmax and sum(exp(l - max)).
__device__ __forceinline__ void proj_tile_stats(
    const float (*Ls)[P_RT + 1], int v0, int V, int b0, int B,
    float* __restrict__ pmax, int* __restrict__ pidx,
    float* __restrict__ psum, int ntile) {
  const int tid = threadIdx.x;
  if (tid < P_BT && b0 + tid < B) {
    const int bl = tid, b = b0 + tid;
    const int n = min(P_RT, V - v0);
    float m = -INFINITY;
    int arg = -1;
    for (int r = 0; r < n; ++r) {
      const float l = Ls[bl][r];
      if (l > m) {  // strict: the first maximum wins
        m = l;
        arg = v0 + r;
      }
    }
    float s = 0.f;
    for (int r = 0; r < n; ++r) s += expf(Ls[bl][r] - m);
    const size_t o = (size_t)b * ntile + blockIdx.x;
    pmax[o] = m;
    pidx[o] = arg;
    psum[o] = s;
  }
}

// Block-wide first-index argmax over the row's tiles: the global max of
// pmax and the lowest tile that reaches it.  Returns the tile (-1 if none).
__device__ __forceinline__ int block_first_argmax(
    const float* __restrict__ pmax, int ntile, float* sm, int* si) {
  const int tid = threadIdx.x;
  float m = -INFINITY;
  int best = -1;
  for (int i = tid; i < ntile; i += F_NT) {  // ascending i: first max kept
    const float v = pmax[i];
    if (v > m) {
      m = v;
      best = i;
    }
  }
  sm[tid] = m;
  si[tid] = best;
  __syncthreads();
  for (int s = F_NT / 2; s > 0; s >>= 1) {
    if (tid < s) {
      const float m2 = sm[tid + s];
      const int i2 = si[tid + s];
      const float m1 = sm[tid];
      const int i1 = si[tid];
      if (i2 >= 0 && (i1 < 0 || m2 > m1 || (m2 == m1 && i2 < i1))) {
        sm[tid] = m2;
        si[tid] = i2;
      }
    }
    __syncthreads();
  }
  best = si[0];
  __syncthreads();
  return best;
}

// Block-wide sum over the row's tiles of psum * exp(pmax - m).
__device__ __forceinline__ float block_rescaled_sum(
    const float* __restrict__ pmax, const float* __restrict__ psum,
    int ntile, float m, float* sm) {
  const int tid = threadIdx.x;
  float acc = 0.f;
  for (int i = tid; i < ntile; i += F_NT) acc += psum[i] * expf(pmax[i] - m);
  sm[tid] = acc;
  __syncthreads();
  for (int s = F_NT / 2; s > 0; s >>= 1) {
    if (tid < s) sm[tid] += sm[tid + s];
    __syncthreads();
  }
  const float total = sm[0];
  __syncthreads();
  return total;
}

// The decode's starting state: x = x0 (else feats), the h half that step 0
// reads = h0 (else 0), c = c0 (else 0).  h0 / c0 [nl, B, H] and x0 [B, E]
// are the state carried out of an earlier chunk, or null.
inline cudaError_t init_state(const float* feats, const float* h0,
                              const float* c0, const float* x0, int B, int E,
                              int H, int nl, float* x, float* h, float* c,
                              cudaStream_t s) {
  const size_t state = sizeof(float) * nl * B * H;
  cudaError_t err = cudaMemcpyAsync(x, x0 != nullptr ? x0 : feats,
                                    sizeof(float) * B * E,
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return err;
  err = h0 != nullptr
            ? cudaMemcpyAsync(h, h0, state, cudaMemcpyDeviceToDevice, s)
            : cudaMemsetAsync(h, 0, state, s);
  if (err != cudaSuccess) return err;
  return c0 != nullptr
             ? cudaMemcpyAsync(c, c0, state, cudaMemcpyDeviceToDevice, s)
             : cudaMemsetAsync(c, 0, state, s);
}

// The h half that step t reads (t % 2) and the one it writes ((t+1) % 2).
inline const float* h_read(const float* h, int nl, int B, int H, int t) {
  return h + (size_t)(t % 2) * nl * B * H;
}
inline float* h_write(float* h, int nl, int B, int H, int t) {
  return h + (size_t)((t + 1) % 2) * nl * B * H;
}

// h_top of step t: the top layer in the half written in that step.
inline const float* top_h(const float* h, int nl, int B, int H, int t) {
  return h + (size_t)((t + 1) % 2) * nl * B * H + (size_t)(nl - 1) * B * H;
}

// The state after the last step T-1, for a later chunk to resume from:
// hT = the half that step wrote (T % 2), cT = c, xT = x (finalize left
// embed[last id] there).  Each output is skipped when null.
inline cudaError_t emit_state(const float* h, const float* c, const float* x,
                              int B, int E, int H, int nl, int T, float* hT,
                              float* cT, float* xT, cudaStream_t s) {
  const size_t state = sizeof(float) * nl * B * H;
  cudaError_t err = cudaSuccess;
  if (hT != nullptr)
    err = cudaMemcpyAsync(hT, h + (size_t)(T % 2) * nl * B * H, state,
                          cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess && cT != nullptr)
    err = cudaMemcpyAsync(cT, c, state, cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess && xT != nullptr)
    err = cudaMemcpyAsync(xT, x, sizeof(float) * B * E,
                          cudaMemcpyDeviceToDevice, s);
  return err;
}

}  // namespace gic
