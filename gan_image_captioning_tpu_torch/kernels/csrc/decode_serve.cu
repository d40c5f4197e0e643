// Stacked-LSTM free-running decode for Hopper (sm_90a), float32: the greedy
// serve mode and the Gumbel-softmax sample mode with BPTT residuals.
//
// Replaces: gan_image_captioning_tpu/kernels/decode_sample.py, function
// `_kernel` in modes "serve", "greedy", "pretrain", "sample", "sample_resid"
// and "sample_embed" (launched by `decode_sample`).  Per step t of T, for a
// batch of B rows:
//   gates_l = [x | h_l] @ [w_ih_l | w_hh_l]^T + (b_ih_l + b_hh_l)  (i, f, g, o)
//   c_l = f*c_l + i*g ;  h_l = o*tanh(c_l) ;  x = h_l            (per layer)
//   logits = h_top @ w_proj^T + b_proj
// serve:
//   ids[b, t] = argmax(logits)             (first index on ties)
//   lps[b, t] = -log(sum(exp(logits - max)))
// sample_resid:
//   u ~ U[0, 1) per (t, b, v): Philox4x32-10 keyed by the seed, counter
//       (v, b, t, 0), top 24 bits of the first word times 2^-24 (the TPU
//       kernel's construction from 32 random bits); or read from `u_in`
//   g = -log(-log(u + 1e-10) + 1e-10) ;  s = logits + g
//   ids[b, t] = argmax(s)                  (unscaled, first index on ties)
//   soft[t, b] = softmax(temp * s)
//   hs/cs[t, l], gates[t, l] = h_l, c_l and the pre-activation gates (both
//   biases) of every layer: the residuals of the manual backward
// pretrain: ids as serve, and logits[t, b] instead of lps
// sample:   ids as sample_resid (the same s), and noise[t, b] = g instead
//   of soft and the residuals
// sample_embed: sample_resid, then emb[t, b] = soft[t, b] @ wd^T with the
//   discriminator's embedding wd [Ed, V], one product over all T*B rows
//   after the time loop (nothing feeds emb back into the recurrence)
// and in every mode  x = embed[ids[:, t]]  is the next step's input.
// serve with carried state (the `init_state` variant, which the continuous
// engine's chunks and the adaptive decode run): the decode starts from a
// given (h0, c0, x0) instead of (0, 0, features) and hands back the state
// after its last step, (hT, cT, xT), xT = embed[last ids].
//
// What bounds it on this card.  At the training width (E = H = 512, two
// layers, V = 11008, T = 36, B = 64) one decode does 2*B*T*(2*4H*(E+H) +
// V*H) = 45.3 GFLOP; without tensor cores (float32, 67 TFLOP/s) that is
// 0.68 ms, against 0.06 ms for the bytes (39 MB of weights read once, the
// 101 MB soft sample and 57 MB of residuals written once).  But the steps
// are sequential, each needs every weight again, and each step is a chain
// of small launches, so per-launch latency adds up.
//
// What this design does about it.  It is the simple version: the time loop
// runs on the host inside one C call on the caller's stream, with nl + 2
// launches per step:
//   * lstm_layer_kernel: a block owns 4 hidden units (16 gate rows, read in
//     place from the torch-layout weights) and 32 batch rows; it computes
//     the gate tile as a register-tiled product over K = In + H in K tiles
//     of 32 (shared memory stays at 8 KB whatever B is), then updates c in
//     place (float32) and writes h into the other half of a ping-pong
//     buffer, because every block reads the old h of all units.  In sample
//     mode it also writes the residuals; with null residual pointers it is
//     the serve kernel unchanged.
//   * proj_kernel (serve) / proj_sample_kernel: a block owns 64 vocabulary
//     rows and 32 batch rows and emits per (row, tile) the statistics its
//     finalize needs: the tile's max, first argmax and sum(exp(l - max))
//     of the logits (serve); the max and first argmax of s, and the max
//     and sum(exp(z - max)) of z = temp * s, with z stored into soft (sample).
//   * finalize_kernel / sample_finalize_kernel: one block per row combines
//     the tiles (global max, lowest tile then lowest lane on ties), writes
//     ids (and lps), normalises the row of soft across all tiles (sample)
//     and gathers embed[id] into x.  The TPU kernel's one-hot matrix
//     product is a TPU artefact; the gather gives the same values.
// The carried state costs a device-to-device copy of (h, c, x) in and
// out of the scratch buffers, nothing in the step loop: a chain of chunks
// runs the same launches, on the same values, as one full decode.
// Weights are re-read every step (from L2 when they stay there).  Keeping
// them on chip across steps (one persistent kernel with a grid barrier),
// wgmma and bf16 are later work.  decode_common.cuh holds what this file
// shares with the quantized serve decode (decode_qserve.cu).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "tile_dot.cuh"

using namespace gic;

namespace {

// One layer of one step: gates for hidden units [j0, j0+JT) and batch rows
// [b0, b0+L_BT), then the cell update.  c is updated in place; h goes to
// h_next (the other ping-pong half) because other blocks still read h_prev.
// hs_out / cs_out [B, H] and gates_out [B, 4H] (this step's and layer's
// residual slices) are written when not null.
__global__ void __launch_bounds__(L_NT) lstm_layer_kernel(
    const float* __restrict__ w_ih, const float* __restrict__ w_hh,
    const float* __restrict__ bias, const float* __restrict__ x, int In,
    const float* __restrict__ h_prev, float* __restrict__ h_next,
    float* __restrict__ c, int B, int H, float* __restrict__ hs_out,
    float* __restrict__ cs_out, float* __restrict__ gates_out) {
  __shared__ float Ws[L_RT][KT + 1];
  __shared__ float Xs[L_BT][KT + 1];
  __shared__ float Gs[L_RT][L_BT + 1];
  constexpr int NR = L_RT / L_TR, NB = L_BT / L_TB;
  const int j0 = blockIdx.x * JT, b0 = blockIdx.y * L_BT;
  const int tid = threadIdx.x, tr = tid % NR, tb = tid / NR;

  float acc[L_TR][L_TB];
  tile_dot<L_RT, L_BT, L_TR, L_TB>(LstmRows{j0, H}, w_ih, w_hh, x, h_prev,
                                   In, H, b0, B, acc, Ws, Xs);
#pragma unroll
  for (int i = 0; i < L_TR; ++i)
#pragma unroll
    for (int j = 0; j < L_TB; ++j) Gs[tr + i * NR][tb + j * NB] = acc[i][j];
  __syncthreads();
  lstm_cell_tile(Gs, bias, j0, b0, B, H, c, h_next, hs_out, cs_out,
                 gates_out);
}

// Vocabulary projection of one (64-row vocabulary tile, 32-row batch tile)
// with the tile's softmax statistics: max, first argmax, sum(exp(l - max)).
__global__ void __launch_bounds__(P_NT) proj_kernel(
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ h, int H, int V, int B,
    float* __restrict__ pmax, int* __restrict__ pidx,
    float* __restrict__ psum, int ntile, float* __restrict__ logits_t) {
  __shared__ float Ws[P_RT][KT + 1];
  __shared__ float Xs[P_BT][KT + 1];
  __shared__ float Ls[P_BT][P_RT + 1];
  constexpr int NR = P_RT / P_TR, NB = P_BT / P_TB;
  const int v0 = blockIdx.x * P_RT, b0 = blockIdx.y * P_BT;
  const int tid = threadIdx.x, tr = tid % NR, tb = tid / NR;

  float acc[P_TR][P_TB];
  tile_dot<P_RT, P_BT, P_TR, P_TB>(ProjRows{v0, V}, w, nullptr, h, nullptr,
                                   H, 0, b0, B, acc, Ws, Xs);
#pragma unroll
  for (int i = 0; i < P_TR; ++i) {
    const int r = tr + i * NR, v = v0 + r;
    const float bv = v < V ? bias[v] : 0.f;
#pragma unroll
    for (int j = 0; j < P_TB; ++j) Ls[tb + j * NB][r] = acc[i][j] + bv;
  }
  __syncthreads();
  if (logits_t != nullptr) {  // pretrain: this step's logits [B, V]
    const int n = min(P_RT, V - v0);
    for (int e = tid; e < P_BT * P_RT; e += P_NT) {
      const int bl = e / P_RT, r = e % P_RT, b = b0 + bl;
      if (b < B && r < n) logits_t[(size_t)b * V + v0 + r] = Ls[bl][r];
    }
  }
  proj_tile_stats(Ls, v0, V, b0, B, pmax, pidx, psum, ntile);
}

// Sample-mode projection tile: s = logits + g with the Gumbel noise of
// step t; per (row, tile) the max and first argmax of s and, when soft_t
// is not null, the max and sum(exp(z - max)) of z = temp * s.  z goes into
// soft_t [B, V] (this step's slice), which sample_finalize_kernel
// normalises.  g_t [B, V] (this step's slice of the noise) receives g when
// it is not null (mode sample, which passes no soft_t).
__global__ void __launch_bounds__(P_NT) proj_sample_kernel(
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ h, int H, int V, int B, float temp,
    unsigned long long seed, int t, const float* __restrict__ u_in,
    float* __restrict__ u_out, float* __restrict__ soft_t,
    float* __restrict__ psmax, int* __restrict__ psidx,
    float* __restrict__ pzmax, float* __restrict__ pzsum, int ntile,
    float* __restrict__ g_t) {
  __shared__ float Ws[P_RT][KT + 1];
  __shared__ float Xs[P_BT][KT + 1];
  __shared__ float Ls[P_BT][P_RT + 1];
  constexpr int NR = P_RT / P_TR, NB = P_BT / P_TB;
  const int v0 = blockIdx.x * P_RT, b0 = blockIdx.y * P_BT;
  const int tid = threadIdx.x, tr = tid % NR, tb = tid / NR;

  float acc[P_TR][P_TB];
  tile_dot<P_RT, P_BT, P_TR, P_TB>(ProjRows{v0, V}, w, nullptr, h, nullptr,
                                   H, 0, b0, B, acc, Ws, Xs);
#pragma unroll
  for (int i = 0; i < P_TR; ++i) {
    const int r = tr + i * NR, v = v0 + r;
    const float bv = v < V ? bias[v] : 0.f;
#pragma unroll
    for (int j = 0; j < P_TB; ++j) {
      const int b = b0 + tb + j * NB;
      float s = 0.f;
      if (v < V && b < B) {
        const size_t o = ((size_t)t * B + b) * V + v;
        const float u = u_in != nullptr ? u_in[o] : philox_uniform(seed, t, b, v);
        if (u_out != nullptr) u_out[o] = u;
        const float g = -logf(-logf(u + GUMBEL_EPS) + GUMBEL_EPS);
        if (g_t != nullptr) g_t[(size_t)b * V + v] = g;
        s = (acc[i][j] + bv) + g;
      }
      Ls[tb + j * NB][r] = s;
    }
  }
  __syncthreads();

  const int n = min(P_RT, V - v0);
  // z = temp * s into soft_t, coalesced along the vocabulary.  z is
  // rounded once (__fmul_rn: no contraction into the subtractions below),
  // so the statistics and the normalising pass see the same z.
  if (soft_t != nullptr) {
    for (int e = tid; e < P_BT * P_RT; e += P_NT) {
      const int bl = e / P_RT, r = e % P_RT, b = b0 + bl;
      if (b < B && r < n)
        soft_t[(size_t)b * V + v0 + r] = __fmul_rn(temp, Ls[bl][r]);
    }
  }
  if (tid < P_BT && b0 + tid < B) {
    const int bl = tid, b = b0 + tid;
    float sm = -INFINITY, zm = -INFINITY;
    int arg = -1;
    for (int r = 0; r < n; ++r) {
      const float s = Ls[bl][r];
      if (s > sm) {  // strict: the first maximum wins
        sm = s;
        arg = v0 + r;
      }
      zm = fmaxf(zm, __fmul_rn(temp, s));
    }
    const size_t o = (size_t)b * ntile + blockIdx.x;
    psmax[o] = sm;
    psidx[o] = arg;
    if (soft_t != nullptr) {
      float zs = 0.f;
      for (int r = 0; r < n; ++r)
        zs += expf(__fmul_rn(temp, Ls[bl][r]) - zm);
      pzmax[o] = zm;
      pzsum[o] = zs;
    }
  }
}

// One block per batch row: combine the vocabulary tiles, emit ids (and
// lps, when not null) for step t, and gather the chosen embedding row as
// the next input.
__global__ void __launch_bounds__(F_NT) finalize_kernel(
    const float* __restrict__ pmax, const int* __restrict__ pidx,
    const float* __restrict__ psum, int ntile,
    const float* __restrict__ embed, int E, float* __restrict__ x,
    int32_t* __restrict__ ids, float* __restrict__ lps, int t, int T) {
  __shared__ float sm[F_NT];
  __shared__ int si[F_NT];
  __shared__ int s_id;
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t base = (size_t)b * ntile;

  const int best = block_first_argmax(pmax + base, ntile, sm, si);
  const float m = best >= 0 ? pmax[base + best] : 0.f;
  const float total = block_rescaled_sum(pmax + base, psum + base, ntile, m,
                                         sm);
  if (tid == 0) {
    const int id = best >= 0 ? pidx[base + best] : 0;
    ids[(size_t)b * T + t] = id;
    if (lps != nullptr) lps[(size_t)b * T + t] = -logf(total);
    s_id = id;
  }
  __syncthreads();
  const float* row = embed + (size_t)s_id * E;
  for (int e = tid; e < E; e += F_NT) x[(size_t)b * E + e] = row[e];
}

// Sample mode, one block per batch row: the first argmax of s over all
// tiles -> ids[b, t] and the next input embed[id]; then, when soft_t is not
// null, soft_t[b] (z on entry) becomes exp(z - M) / sum(exp(z - M)) with M
// the row max of z.
__global__ void __launch_bounds__(F_NT) sample_finalize_kernel(
    const float* __restrict__ psmax, const int* __restrict__ psidx,
    const float* __restrict__ pzmax, const float* __restrict__ pzsum,
    int ntile, const float* __restrict__ embed, int E, int V,
    float* __restrict__ x, int32_t* __restrict__ ids,
    float* __restrict__ soft_t, int t, int T) {
  __shared__ float sm[F_NT];
  __shared__ int si[F_NT];
  __shared__ int s_id;
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t base = (size_t)b * ntile;

  const int best = block_first_argmax(psmax + base, ntile, sm, si);
  if (tid == 0) {
    const int id = best >= 0 ? psidx[base + best] : 0;
    ids[(size_t)b * T + t] = id;
    s_id = id;
  }
  if (soft_t == nullptr) {  // mode sample: no soft sample (uniform branch)
    __syncthreads();
    const float* row = embed + (size_t)s_id * E;
    for (int e = tid; e < E; e += F_NT) x[(size_t)b * E + e] = row[e];
    return;
  }
  // the max of z: the max of the tile maxima (no tie rule needed)
  float m = -INFINITY;
  for (int i = tid; i < ntile; i += F_NT) m = fmaxf(m, pzmax[base + i]);
  sm[tid] = m;
  __syncthreads();
  for (int s = F_NT / 2; s > 0; s >>= 1) {
    if (tid < s) sm[tid] = fmaxf(sm[tid], sm[tid + s]);
    __syncthreads();
  }
  m = sm[0];
  __syncthreads();
  const float total = block_rescaled_sum(pzmax + base, pzsum + base, ntile,
                                         m, sm);
  float* row_soft = soft_t + (size_t)b * V;
  for (int v = tid; v < V; v += F_NT)
    row_soft[v] = expf(row_soft[v] - m) / total;
  const float* row = embed + (size_t)s_id * E;
  for (int e = tid; e < E; e += F_NT) x[(size_t)b * E + e] = row[e];
}

// Mode sample_embed, after the time loop: emb [R, Ed] = soft [R, V] @
// wd^T for the R = T*B rows of the soft sample, wd [Ed, V] the
// discriminator's embedding (torch layout).  A block owns 64 embedding
// columns and 32 soft rows: the projection's tile, with wd in the place
// of the projection weight and the soft rows in the place of h.
__global__ void __launch_bounds__(P_NT) embed_kernel(
    const float* __restrict__ wd, const float* __restrict__ soft, int V,
    int Ed, int R, float* __restrict__ emb) {
  __shared__ float Ws[P_RT][KT + 1];
  __shared__ float Xs[P_BT][KT + 1];
  constexpr int NR = P_RT / P_TR, NB = P_BT / P_TB;
  const int e0 = blockIdx.x * P_RT, r0 = blockIdx.y * P_BT;
  const int tid = threadIdx.x, tr = tid % NR, tb = tid / NR;

  float acc[P_TR][P_TB];
  tile_dot<P_RT, P_BT, P_TR, P_TB>(ProjRows{e0, Ed}, wd, nullptr, soft,
                                   nullptr, V, 0, r0, R, acc, Ws, Xs);
#pragma unroll
  for (int i = 0; i < P_TR; ++i) {
    const int e = e0 + tr + i * NR;
#pragma unroll
    for (int j = 0; j < P_TB; ++j) {
      const int r = r0 + tb + j * NB;
      if (e < Ed && r < R) emb[(size_t)r * Ed + e] = acc[i][j];
    }
  }
}

struct Residuals {
  float* hs;     // [T, nl, B, H]
  float* cs;     // [T, nl, B, H]
  float* gates;  // [T, nl, B, 4H]
};

// The stacked LSTM of step t (nl launches); residuals when res != null.
cudaError_t lstm_step(const void* const* layer_ptrs, int nl, int B, int E,
                      int H, int t, const float* x, float* h, float* c,
                      const Residuals* res, cudaStream_t s) {
  const size_t layer_state = (size_t)B * H;
  const dim3 grid((H + JT - 1) / JT, (B + L_BT - 1) / L_BT);
  const float* hp = h_read(h, nl, B, H, t);
  float* hn = h_write(h, nl, B, H, t);
  for (int l = 0; l < nl; ++l) {
    const float* w_ih = static_cast<const float*>(layer_ptrs[3 * l]);
    const float* w_hh = static_cast<const float*>(layer_ptrs[3 * l + 1]);
    const float* bias = static_cast<const float*>(layer_ptrs[3 * l + 2]);
    const float* in = l == 0 ? x : hn + (size_t)(l - 1) * layer_state;
    float *hs = nullptr, *cs = nullptr, *gates = nullptr;
    if (res != nullptr) {
      const size_t tl = (size_t)t * nl + l;
      hs = res->hs + tl * layer_state;
      cs = res->cs + tl * layer_state;
      gates = res->gates + tl * 4 * layer_state;
    }
    lstm_layer_kernel<<<grid, L_NT, 0, s>>>(
        w_ih, w_hh, bias, in, l == 0 ? E : H, hp + l * layer_state,
        hn + l * layer_state, c + l * layer_state, B, H, hs, cs, gates);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The Gumbel decode's time loop (modes sample_resid, sample_embed and,
// with soft == null and res == null, sample): per step the stacked LSTM,
// proj_sample_kernel and sample_finalize_kernel.  noise [T, B, V] receives
// g when not null.
cudaError_t sample_loop(const float* feats, const float* embed,
                        const float* w_proj, const float* b_proj,
                        const void* const* layer_ptrs, int B, int E, int H,
                        int V, int nl, int T, float temp,
                        unsigned long long seed, const float* u_in,
                        float* u_out, float* x, float* h, float* c,
                        float* psmax, int* psidx, float* pzmax, float* pzsum,
                        int32_t* ids, float* soft, const Residuals* res,
                        float* noise, cudaStream_t s) {
  const int ntile = (V + P_RT - 1) / P_RT;
  cudaError_t err = init_state(feats, nullptr, nullptr, nullptr, B, E, H, nl,
                               x, h, c, s);
  if (err != cudaSuccess) return err;

  const dim3 proj_grid(ntile, (B + P_BT - 1) / P_BT);
  for (int t = 0; t < T; ++t) {
    err = lstm_step(layer_ptrs, nl, B, E, H, t, x, h, c, res, s);
    if (err != cudaSuccess) return err;
    const size_t step = (size_t)t * B * V;
    float* soft_t = soft != nullptr ? soft + step : nullptr;
    float* g_t = noise != nullptr ? noise + step : nullptr;
    proj_sample_kernel<<<proj_grid, P_NT, 0, s>>>(
        w_proj, b_proj, top_h(h, nl, B, H, t), H, V, B, temp, seed, t, u_in,
        u_out, soft_t, psmax, psidx, pzmax, pzsum, ntile, g_t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sample_finalize_kernel<<<B, F_NT, 0, s>>>(psmax, psidx, pzmax, pzsum,
                                              ntile, embed, E, V, x, ids,
                                              soft_t, t, T);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The greedy time loop (modes serve, greedy and pretrain): per step the
// stacked LSTM, proj_kernel and finalize_kernel; lps [B, T] and logits
// [T, B, V] are written when not null.
cudaError_t greedy_loop(const float* embed, const float* w_proj,
                        const float* b_proj, const void* const* layer_ptrs,
                        int B, int E, int H, int V, int nl, int T, float* x,
                        float* h, float* c, float* pmax, int* pidx,
                        float* psum, int32_t* ids, float* lps, float* logits,
                        cudaStream_t s) {
  const int ntile = (V + P_RT - 1) / P_RT;
  const dim3 proj_grid(ntile, (B + P_BT - 1) / P_BT);
  for (int t = 0; t < T; ++t) {
    cudaError_t err = lstm_step(layer_ptrs, nl, B, E, H, t, x, h, c, nullptr,
                                s);
    if (err != cudaSuccess) return err;
    float* logits_t = logits != nullptr ? logits + (size_t)t * B * V
                                        : nullptr;
    proj_kernel<<<proj_grid, P_NT, 0, s>>>(w_proj, b_proj,
                                           top_h(h, nl, B, H, t), H, V, B,
                                           pmax, pidx, psum, ntile,
                                           logits_t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    finalize_kernel<<<B, F_NT, 0, s>>>(pmax, pidx, psum, ntile, embed, E, x,
                                       ids, lps, t, T);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Vocabulary rows per projection tile: the wrapper sizes the per-tile
// scratch ([B, ceil(V / tile)] per statistic) with it.
int gic_proj_tile(void) { return P_RT; }

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The whole T-step greedy decode on `stream`.  layer_ptrs holds 3*nl
// device pointers: w_ih [4H, In], w_hh [4H, H], bias = b_ih + b_hh [4H] per
// layer.  Carried state (each pointer may be null): h0, c0 [nl, B, H] and
// x0 [B, E] in place of h = c = 0 and x = feats; hT, cT [nl, B, H] and
// xT [B, E] receive the state after the last step.  Scratch: x [B, E],
// h [2, nl, B, H], c [nl, B, H], pmax/pidx/psum [B, ntile].  Outputs:
// ids, lps [B, T].  Returns 0 or the first CUDA error code; nothing
// synchronises.
int gic_decode_serve(const float* feats, const float* embed,
                     const float* w_proj, const float* b_proj,
                     const void* const* layer_ptrs, int B, int E, int H,
                     int V, int nl, int T, const float* h0, const float* c0,
                     const float* x0, float* x, float* h, float* c,
                     float* pmax, int* pidx, float* psum, int32_t* ids,
                     float* lps, float* hT, float* cT, float* xT,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = init_state(feats, h0, c0, x0, B, E, H, nl, x, h, c, s);
  if (err != cudaSuccess) return err;
  err = greedy_loop(embed, w_proj, b_proj, layer_ptrs, B, E, H, V, nl, T, x,
                    h, c, pmax, pidx, psum, ids, lps, nullptr, s);
  if (err != cudaSuccess) return err;
  return emit_state(h, c, x, B, E, H, nl, T, hT, cT, xT, s);
}

// Mode pretrain: the greedy decode from (0, 0, feats) with the logits
// [T, B, V] of every step and no log-probabilities.  Scratch as
// gic_decode_serve.  Outputs: ids [B, T], logits [T, B, V].
int gic_decode_pretrain(const float* feats, const float* embed,
                        const float* w_proj, const float* b_proj,
                        const void* const* layer_ptrs, int B, int E, int H,
                        int V, int nl, int T, float* x, float* h, float* c,
                        float* pmax, int* pidx, float* psum, int32_t* ids,
                        float* logits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = init_state(feats, nullptr, nullptr, nullptr, B, E, H, nl,
                               x, h, c, s);
  if (err != cudaSuccess) return err;
  return greedy_loop(embed, w_proj, b_proj, layer_ptrs, B, E, H, V, nl, T, x,
                     h, c, pmax, pidx, psum, ids, nullptr, logits, s);
}

// The whole T-step Gumbel-softmax sample with BPTT residuals on `stream`.
// Weights and x/h/c scratch as gic_decode_serve; per-tile scratch
// psmax/psidx/pzmax/pzsum [B, ntile].  Noise: u_in [T, B, V] when not null,
// else Philox keyed by `seed`; the uniforms used are copied to u_out
// [T, B, V] when it is not null.  Outputs: ids [B, T], soft [T, B, V],
// hs/cs [T, nl, B, H], gates [T, nl, B, 4H].
int gic_decode_sample_resid(
    const float* feats, const float* embed, const float* w_proj,
    const float* b_proj, const void* const* layer_ptrs, int B, int E, int H,
    int V, int nl, int T, float temp, unsigned long long seed,
    const float* u_in, float* u_out, float* x, float* h, float* c,
    float* psmax, int* psidx, float* pzmax, float* pzsum, int32_t* ids,
    float* soft, float* hs, float* cs, float* gates, void* stream) {
  const Residuals res{hs, cs, gates};
  return sample_loop(feats, embed, w_proj, b_proj, layer_ptrs, B, E, H, V,
                     nl, T, temp, seed, u_in, u_out, x, h, c, psmax, psidx,
                     pzmax, pzsum, ids, soft, &res, nullptr,
                     static_cast<cudaStream_t>(stream));
}

// Mode sample: the Gumbel-max decode, ids = argmax(logits + g) per step,
// and the noise g [T, B, V]; no soft sample, no residuals.  Noise source
// and scratch as gic_decode_sample_resid (no pzmax / pzsum).
int gic_decode_sample(const float* feats, const float* embed,
                      const float* w_proj, const float* b_proj,
                      const void* const* layer_ptrs, int B, int E, int H,
                      int V, int nl, int T, unsigned long long seed,
                      const float* u_in, float* x, float* h, float* c,
                      float* psmax, int* psidx, int32_t* ids, float* noise,
                      void* stream) {
  return sample_loop(feats, embed, w_proj, b_proj, layer_ptrs, B, E, H, V,
                     nl, T, 1.f, seed, u_in, nullptr, x, h, c, psmax, psidx,
                     nullptr, nullptr, ids, nullptr, nullptr, noise,
                     static_cast<cudaStream_t>(stream));
}

// Mode sample_embed: gic_decode_sample_resid, then emb [T*B, Ed] = soft
// @ wd^T with wd [Ed, V] (one launch over all rows).
int gic_decode_sample_embed(
    const float* feats, const float* embed, const float* w_proj,
    const float* b_proj, const void* const* layer_ptrs, int B, int E, int H,
    int V, int nl, int T, float temp, unsigned long long seed,
    const float* u_in, const float* wd, int Ed, float* x, float* h, float* c,
    float* psmax, int* psidx, float* pzmax, float* pzsum, int32_t* ids,
    float* soft, float* hs, float* cs, float* gates, float* emb,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Residuals res{hs, cs, gates};
  cudaError_t err = sample_loop(feats, embed, w_proj, b_proj, layer_ptrs, B,
                                E, H, V, nl, T, temp, seed, u_in, nullptr, x,
                                h, c, psmax, psidx, pzmax, pzsum, ids, soft,
                                &res, nullptr, s);
  if (err != cudaSuccess) return err;
  const int R = T * B;
  const dim3 grid((Ed + P_RT - 1) / P_RT, (R + P_BT - 1) / P_BT);
  embed_kernel<<<grid, P_NT, 0, s>>>(wd, soft, V, Ed, R, emb);
  return cudaGetLastError();
}

}  // extern "C"
