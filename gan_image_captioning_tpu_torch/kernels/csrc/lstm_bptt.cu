// LSTM backward recurrences for Hopper (sm_90a), float32: the stacked
// chain of the decode backward and the single-layer reverse loop of the
// teacher-forced pass.
//
// gic_lstm_bptt_chain replaces gan_image_captioning_tpu/kernels/
// lstm_bptt.py, function `_chain_kernel` (launched by `lstm_bptt_chain`).
// For t = T-1 .. 0 and,
// inside each step, l = NL-1 .. 0 (the upper layer first, because it feeds
// the lower one in the same step):
//   dh = dh_carry[l] + (l == NL-1 ? d_hs[t] : dx_upper)
//   i, f, g, o = act(gates[t, l]) ;  tc = tanh(cs[t, l])
//   do = dh*tc*o*(1-o) ;  dc = dc_carry[l] + dh*o*(1-tc^2)
//   di = dc*g*i*(1-i) ;  df = dc*c_prev*f*(1-f) ;  dg = dc*i*(1-g^2)
//   d_pre[t, l] = [di | df | dg | do]   (c_prev = cs[t-1, l], 0 at t = 0)
//   dc_carry[l] = dc*f ;  dh_carry[l] = d_pre[t, l] @ w_hhs[l]^T
//   dx_upper = d_pre[t, l] @ w_ihs_upper[l-1]^T          (l > 0)
// with w_hhs [NL, H, 4H] and w_ihs_upper [NL-1, H, 4H] the transposed
// torch-layout weights, as the TPU kernel takes them.
//
// What bounds it on this card.  At the training width (H = 512, NL = 2,
// T = 36, B = 64) the products are T*(2*NL-1) of [B, 4H] x [4H, H]:
// 14.5 GFLOP, 0.22 ms at float32's 67 TFLOP/s; the bytes (gates, c,
// d_hs and d_pre once, each weight once: about 102 MB) take 0.03 ms.  The
// recurrence is sequential, so per-launch latency adds up as in the decode.
//
// What this design does about it.  It is the simple version: the reverse
// time loop runs on the host inside one C call on the caller's stream,
// with 2 launches per step and layer:
//   * gate_grad_kernel: one thread per (b, j) computes the four gate
//     gradients of hidden unit j and updates the dc carry in place;
//   * carry_kernel: the register-tiled product (tile_dot.cuh) of d_pre[t, l]
//     with w_hhs[l] (blockIdx.z = 0, into dh_carry[l]) and, for l > 0, with
//     w_ihs_upper[l-1] (blockIdx.z = 1, into dx_upper) in the same launch.
// The carries live in device buffers the wrapper allocates.  Weights stay
// in L2 between steps when they fit (12.6 MB here).  Fusing the gate
// gradients into the products' load phase, or one persistent kernel for
// the whole recurrence, is later work.
//
// gic_bptt_reverse replaces the same file's `_kernel` (launched by
// `lstm_bptt_reverse`; caller `models/lstm.py:_layer_seq_bwd`): one layer's
// reverse loop, the chain's step with NL = 1, no inter-layer input and the
// cell state entering each step read from c_prev [T, B, H] (so a non-zero
// initial state works); the carries start at zero and leave as (dh0, dc0).
// At the training width (H = 512, T = 36, B = 64) its T products of
// [B, 4H] x [4H, H] are 4.8 GFLOP, 0.072 ms at 67 TFLOP/s, against about
// 56 MB of bytes (0.017 ms): bound by operations.  It runs the same two
// kernels per step as the chain, so the same per-launch latency adds up.

#include <cuda_runtime.h>
#include <math.h>

#include "tile_dot.cuh"

namespace {

using gic::KT;
using gic::sigmoidf;
using gic::tile_dot;

constexpr int G_NT = 256;  // gate-gradient threads per block

// Product tile: C_RT hidden units (rows of the [H, 4H] weight) x C_BT rows.
constexpr int C_RT = 16, C_BT = 32, C_TR = 2, C_TB = 2;
constexpr int C_NT = (C_RT / C_TR) * (C_BT / C_TB);  // 128 threads

struct PlainRows {
  int r0, n;
  __device__ int operator()(int r) const {
    const int R = r0 + r;
    return R < n ? R : -1;
  }
};

__global__ void __launch_bounds__(G_NT) gate_grad_kernel(
    const float* __restrict__ gates, const float* __restrict__ c_t,
    const float* __restrict__ c_prev, const float* __restrict__ dh_in,
    const float* __restrict__ dh_carry, float* __restrict__ dc_carry,
    float* __restrict__ d_pre, int B, int H) {
  const int e = blockIdx.x * G_NT + threadIdx.x;
  if (e >= B * H) return;
  const int b = e / H, j = e % H;
  const float* g = gates + (size_t)b * 4 * H + j;
  const float ig = sigmoidf(g[0]), fg = sigmoidf(g[H]);
  const float gg = tanhf(g[2 * H]), og = sigmoidf(g[3 * H]);
  const float dh = dh_carry[e] + dh_in[e];
  const float tc = tanhf(c_t[e]);
  const float d_o = dh * tc * og * (1.f - og);
  const float dc = dc_carry[e] + dh * og * (1.f - tc * tc);
  const float cp = c_prev != nullptr ? c_prev[e] : 0.f;
  float* dp = d_pre + (size_t)b * 4 * H + j;
  dp[0] = dc * gg * ig * (1.f - ig);
  dp[H] = dc * cp * fg * (1.f - fg);
  dp[2 * H] = dc * ig * (1.f - gg * gg);
  dp[3 * H] = d_o;
  dc_carry[e] = dc * fg;
}

// out_z[b, j] = sum_k d_pre[b, k] * w_z[j, k] with w_z [H, 4H]:
// z = 0 -> (w_hh, dh_carry), z = 1 -> (w_ih_upper, dx_upper).
__global__ void __launch_bounds__(C_NT) carry_kernel(
    const float* __restrict__ d_pre, const float* __restrict__ w_hh,
    const float* __restrict__ w_ih_upper, float* __restrict__ dh_out,
    float* __restrict__ dx_out, int B, int H) {
  __shared__ float Ws[C_RT][KT + 1];
  __shared__ float Xs[C_BT][KT + 1];
  constexpr int NR = C_RT / C_TR, NB = C_BT / C_TB;
  const int r0 = blockIdx.x * C_RT, b0 = blockIdx.y * C_BT;
  const int tid = threadIdx.x, tr = tid % NR, tb = tid / NR;
  const float* w = blockIdx.z == 0 ? w_hh : w_ih_upper;
  float* out = blockIdx.z == 0 ? dh_out : dx_out;

  float acc[C_TR][C_TB];
  tile_dot<C_RT, C_BT, C_TR, C_TB>(PlainRows{r0, H}, w, nullptr, d_pre,
                                   nullptr, 4 * H, 0, b0, B, acc, Ws, Xs);
#pragma unroll
  for (int i = 0; i < C_TR; ++i) {
    const int j = r0 + tr + i * NR;
#pragma unroll
    for (int k = 0; k < C_TB; ++k) {
      const int b = b0 + tb + k * NB;
      if (j < H && b < B) out[(size_t)b * H + j] = acc[i][k];
    }
  }
}

}  // namespace

extern "C" {

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The whole reverse recurrence on `stream`.  Inputs: w_hhs [NL, H, 4H],
// w_ihs_upper [NL-1, H, 4H] (unused when NL = 1), d_hs [T, B, H],
// gates [T, NL, B, 4H], cs [T, NL, B, H].  Scratch: dh_carry, dc_carry
// [NL, B, H], dx_upper [B, H].  Output: d_pre [T, NL, B, 4H].  Returns 0 or
// the first CUDA error code; nothing synchronises.
int gic_lstm_bptt_chain(const float* w_hhs, const float* w_ihs_upper,
                        const float* d_hs, const float* gates,
                        const float* cs, int T, int NL, int B, int H,
                        float* dh_carry, float* dc_carry, float* dx_upper,
                        float* d_pre, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t state = (size_t)B * H, w_size = (size_t)H * 4 * H;
  cudaError_t err = cudaMemsetAsync(dh_carry, 0, sizeof(float) * NL * state, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(dc_carry, 0, sizeof(float) * NL * state, s);
  if (err != cudaSuccess) return err;

  const int g_blocks = (int)((state + G_NT - 1) / G_NT);
  for (int t = T - 1; t >= 0; --t) {
    for (int l = NL - 1; l >= 0; --l) {
      const size_t tl = (size_t)t * NL + l;
      const float* dh_in = l == NL - 1 ? d_hs + (size_t)t * state : dx_upper;
      const float* c_prev = t > 0 ? cs + (tl - NL) * state : nullptr;
      float* dp = d_pre + tl * 4 * state;
      gate_grad_kernel<<<g_blocks, G_NT, 0, s>>>(
          gates + tl * 4 * state, cs + tl * state, c_prev, dh_in,
          dh_carry + l * state, dc_carry + l * state, dp, B, H);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      const dim3 grid((H + C_RT - 1) / C_RT, (B + C_BT - 1) / C_BT,
                      l > 0 ? 2 : 1);
      carry_kernel<<<grid, C_NT, 0, s>>>(
          dp, w_hhs + l * w_size,
          l > 0 ? w_ihs_upper + (l - 1) * w_size : nullptr,
          dh_carry + l * state, dx_upper, B, H);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return 0;
}

// One layer's reverse recurrence on `stream`.  Inputs: w_hh [H, 4H] (the
// transposed torch-layout recurrent weight), d_hs [T, B, H], gates
// [T, B, 4H], c_prev and cs [T, B, H] (the cell state entering and
// leaving each step).  Outputs: d_pre [T, B, 4H]; dh and dc [B, H], the
// carries, which leave as dh0 and dc0.  Returns 0 or the first CUDA error
// code; nothing synchronises.
int gic_bptt_reverse(const float* w_hh, const float* d_hs, const float* gates,
                     const float* c_prev, const float* cs, int T, int B, int H,
                     float* dh, float* dc, float* d_pre, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t state = (size_t)B * H;
  cudaError_t err = cudaMemsetAsync(dh, 0, sizeof(float) * state, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(dc, 0, sizeof(float) * state, s);
  if (err != cudaSuccess) return err;

  const int g_blocks = (int)((state + G_NT - 1) / G_NT);
  const dim3 grid((H + C_RT - 1) / C_RT, (B + C_BT - 1) / C_BT, 1);
  for (int t = T - 1; t >= 0; --t) {
    float* dp = d_pre + (size_t)t * 4 * state;
    gate_grad_kernel<<<g_blocks, G_NT, 0, s>>>(
        gates + (size_t)t * 4 * state, cs + (size_t)t * state,
        c_prev + (size_t)t * state, d_hs + (size_t)t * state, dh, dc, dp, B,
        H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    carry_kernel<<<grid, C_NT, 0, s>>>(dp, w_hh, nullptr, dh, nullptr, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return 0;
}

}  // extern "C"
