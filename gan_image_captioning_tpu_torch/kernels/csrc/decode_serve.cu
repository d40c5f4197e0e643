// Greedy serve-mode LSTM decode for Hopper (sm_90a), float32.
//
// Replaces: gan_image_captioning_tpu/kernels/decode_sample.py, function
// `_kernel` in modes "serve" and "greedy" (launched by `decode_sample`).
// Per step t of T, for a batch of B rows:
//   gates_l = [x | h_l] @ [w_ih_l | w_hh_l]^T + (b_ih_l + b_hh_l)  (i, f, g, o)
//   c_l = f*c_l + i*g ;  h_l = o*tanh(c_l) ;  x = h_l            (per layer)
//   logits = h_top @ w_proj^T + b_proj
//   ids[b, t] = argmax(logits)             (first index on ties)
//   lps[b, t] = -log(sum(exp(logits - max)))
//   x = embed[ids[:, t]]                   (next step's input)
//
// What bounds it on this card.  At the serving width (E = H = 512, two
// layers, V = 11008, T = 36) one decode does 2*B*T*(2*4H*(E+H) + V*H)
// float operations, 5.66 GFLOP at B = 8, and reads about 39 MB of weights
// once (16.8 MB of LSTM weights, 22.5 MB of projection).  Without tensor
// cores (float32) the operations bound it: 5.66 GFLOP at 67 TFLOP/s is
// about 0.08 ms, against 0.012 ms for the bytes at 3.35 TB/s.  But the
// steps are sequential and each needs every weight again, so a design that
// streams the weights once per step moves 36 * 39 MB = 1.4 GB, about
// 0.42 ms from device memory unless the 50 MB L2 keeps them; and each step
// is a chain of small launches, so launch latency adds up at small B.
//
// What this design does about it.  It is the simple version: the time loop
// runs on the host inside one C call (gic_decode_serve) on the caller's
// stream, with nl + 2 launches per step:
//   * lstm_layer_kernel: a block owns 4 hidden units (16 gate rows, read in
//     place from the torch-layout weights) and 32 batch rows; it computes
//     the gate tile as a register-tiled product over K = In + H in K tiles
//     of 32 (shared memory stays at 8 KB whatever B is), prefetching the
//     next tile into registers, then updates c in place (float32) and
//     writes h into the other half of a ping-pong buffer, because every
//     block reads the old h of all units.
//   * proj_kernel: a block owns 64 vocabulary rows and 32 batch rows; it
//     emits per (row, tile) the tile's max, its first argmax and
//     sum(exp(l - tile max)).
//   * finalize_kernel: one block per row combines the tiles into the
//     global max and first index (lowest tile, then lowest lane), writes
//     ids and lps, and gathers embed[id] into x.  The TPU kernel's one-hot
//     matrix product is a TPU artefact; the gather gives the same values.
// Weights are re-read every step (from L2 when they stay there).  Keeping
// them on chip across steps (one persistent kernel with a grid barrier),
// wgmma and bf16 are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KT = 32;  // depth of one K tile

// LSTM layer tile: JT hidden units -> 4*JT gate rows, L_BT batch rows.
constexpr int JT = 4;
constexpr int L_RT = 4 * JT, L_BT = 32, L_TR = 2, L_TB = 2;
constexpr int L_NT = (L_RT / L_TR) * (L_BT / L_TB);  // 128 threads

// Projection tile: P_RT vocabulary rows, P_BT batch rows.
constexpr int P_RT = 64, P_BT = 32, P_TR = 4, P_TB = 2;
constexpr int P_NT = (P_RT / P_TR) * (P_BT / P_TB);  // 256 threads

constexpr int F_NT = 128;  // finalize threads per row

// Gate row of local row r = g*JT + u: rows j, H+j, 2H+j, 3H+j of the
// torch-layout [4H, K] weights for hidden unit j = j0 + u; -1 past H.
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

// acc[i][j] = sum_k W(row(tr + i*NR))[k] * X(b0 + tb + j*NB)[k], where
// W(R)[k] = k < K0 ? w0[R*K0 + k] : w1[R*K1 + k - K0] and X likewise from
// x0 [B, K0] and x1 [B, K1].  Rows past the edge and batch rows >= B read
// zeros.  One K tile of W and X lives in shared memory; the next one is
// loaded into registers while the current one is consumed.
template <int RT, int BT, int TR, int TB, class Rows>
__device__ __forceinline__ void tile_dot(
    Rows rows, const float* __restrict__ w0, const float* __restrict__ w1,
    const float* __restrict__ x0, const float* __restrict__ x1, int K0,
    int K1, int b0, int B, float (&acc)[TR][TB], float (*Ws)[KT + 1],
    float (*Xs)[KT + 1]) {
  constexpr int NR = RT / TR, NB = BT / TB, NT = NR * NB;
  constexpr int WPT = RT * KT / NT, XPT = BT * KT / NT;
  static_assert(RT * KT % NT == 0 && BT * KT % NT == 0, "tile split");
  const int tid = threadIdx.x, tr = tid % NR, tb = tid / NR;
  const int K = K0 + K1;
  float wreg[WPT], xreg[XPT];

  auto load = [&](int k0) {
#pragma unroll
    for (int n = 0; n < WPT; ++n) {
      const int e = tid + n * NT, r = e / KT, k = k0 + e % KT;
      const int R = rows(r);
      float v = 0.f;
      if (R >= 0 && k < K)
        v = k < K0 ? w0[(size_t)R * K0 + k] : w1[(size_t)R * K1 + (k - K0)];
      wreg[n] = v;
    }
#pragma unroll
    for (int n = 0; n < XPT; ++n) {
      const int e = tid + n * NT, b = b0 + e / KT, k = k0 + e % KT;
      float v = 0.f;
      if (b < B && k < K)
        v = k < K0 ? x0[(size_t)b * K0 + k] : x1[(size_t)b * K1 + (k - K0)];
      xreg[n] = v;
    }
  };

#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TB; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += KT) {
#pragma unroll
    for (int n = 0; n < WPT; ++n) {
      const int e = tid + n * NT;
      Ws[e / KT][e % KT] = wreg[n];
    }
#pragma unroll
    for (int n = 0; n < XPT; ++n) {
      const int e = tid + n * NT;
      Xs[e / KT][e % KT] = xreg[n];
    }
    __syncthreads();
    if (k0 + KT < K) load(k0 + KT);
#pragma unroll 8
    for (int kk = 0; kk < KT; ++kk) {
      float wv[TR], xv[TB];
#pragma unroll
      for (int i = 0; i < TR; ++i) wv[i] = Ws[tr + i * NR][kk];
#pragma unroll
      for (int j = 0; j < TB; ++j) xv[j] = Xs[tb + j * NB][kk];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TB; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

// One layer of one step: gates for hidden units [j0, j0+JT) and batch rows
// [b0, b0+L_BT), then the cell update.  c is updated in place; h goes to
// h_next (the other ping-pong half) because other blocks still read h_prev.
__global__ void __launch_bounds__(L_NT) lstm_layer_kernel(
    const float* __restrict__ w_ih, const float* __restrict__ w_hh,
    const float* __restrict__ bias, const float* __restrict__ x, int In,
    const float* __restrict__ h_prev, float* __restrict__ h_next,
    float* __restrict__ c, int B, int H) {
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

  for (int e = tid; e < JT * L_BT; e += L_NT) {
    const int u = e % JT, bl = e / JT, j = j0 + u, b = b0 + bl;
    if (j >= H || b >= B) continue;
    const float gi = sigmoidf(Gs[0 * JT + u][bl] + bias[0 * H + j]);
    const float gf = sigmoidf(Gs[1 * JT + u][bl] + bias[1 * H + j]);
    const float gg = tanhf(Gs[2 * JT + u][bl] + bias[2 * H + j]);
    const float go = sigmoidf(Gs[3 * JT + u][bl] + bias[3 * H + j]);
    const size_t o = (size_t)b * H + j;
    const float cn = gf * c[o] + gi * gg;
    c[o] = cn;
    h_next[o] = go * tanhf(cn);
  }
}

// Vocabulary projection of one (64-row vocabulary tile, 32-row batch tile)
// with the tile's softmax statistics: max, first argmax, sum(exp(l - max)).
__global__ void __launch_bounds__(P_NT) proj_kernel(
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ h, int H, int V, int B,
    float* __restrict__ pmax, int* __restrict__ pidx,
    float* __restrict__ psum, int ntile) {
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

// One block per batch row: combine the vocabulary tiles, emit ids/lps for
// step t, and gather the chosen embedding row as the next input.
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

  float m = -INFINITY;
  int best = -1;
  for (int i = tid; i < ntile; i += F_NT) {  // ascending i: first max kept
    const float v = pmax[base + i];
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
  m = sm[0];
  best = si[0];
  __syncthreads();

  float acc = 0.f;
  for (int i = tid; i < ntile; i += F_NT)
    acc += psum[base + i] * expf(pmax[base + i] - m);
  sm[tid] = acc;
  __syncthreads();
  for (int s = F_NT / 2; s > 0; s >>= 1) {
    if (tid < s) sm[tid] += sm[tid + s];
    __syncthreads();
  }
  if (tid == 0) {
    const int id = best >= 0 ? pidx[base + best] : 0;
    ids[(size_t)b * T + t] = id;
    lps[(size_t)b * T + t] = -logf(sm[0]);
    s_id = id;
  }
  __syncthreads();
  const float* row = embed + (size_t)s_id * E;
  for (int e = tid; e < E; e += F_NT) x[(size_t)b * E + e] = row[e];
}

}  // namespace

extern "C" {

// Vocabulary rows per projection tile: the wrapper sizes the per-tile
// scratch (pmax/pidx/psum [B, ceil(V / tile)]) with it.
int gic_proj_tile(void) { return P_RT; }

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The whole T-step decode on `stream`.  layer_ptrs holds 3*nl device
// pointers: w_ih [4H, In], w_hh [4H, H], bias = b_ih + b_hh [4H] per layer.
// Scratch: x [B, E], h [2, nl, B, H], c [nl, B, H], pmax/pidx/psum
// [B, ntile].  Outputs: ids, lps [B, T].  Returns 0 or the first CUDA
// error code; nothing synchronises.
int gic_decode_serve(const float* feats, const float* embed,
                     const float* w_proj, const float* b_proj,
                     const void* const* layer_ptrs, int B, int E, int H,
                     int V, int nl, int T, float* x, float* h, float* c,
                     float* pmax, int* pidx, float* psum, int32_t* ids,
                     float* lps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntile = (V + P_RT - 1) / P_RT;
  const size_t layer_state = (size_t)B * H;
  cudaError_t err;

  err = cudaMemcpyAsync(x, feats, sizeof(float) * B * E,
                        cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(h, 0, sizeof(float) * 2 * nl * layer_state, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(c, 0, sizeof(float) * nl * layer_state, s);
  if (err != cudaSuccess) return err;

  const dim3 lstm_grid((H + JT - 1) / JT, (B + L_BT - 1) / L_BT);
  const dim3 proj_grid(ntile, (B + P_BT - 1) / P_BT);
  for (int t = 0; t < T; ++t) {
    const float* hp = h + (size_t)(t % 2) * nl * layer_state;
    float* hn = h + (size_t)((t + 1) % 2) * nl * layer_state;
    for (int l = 0; l < nl; ++l) {
      const float* w_ih = static_cast<const float*>(layer_ptrs[3 * l]);
      const float* w_hh = static_cast<const float*>(layer_ptrs[3 * l + 1]);
      const float* bias = static_cast<const float*>(layer_ptrs[3 * l + 2]);
      const float* in = l == 0 ? x : hn + (size_t)(l - 1) * layer_state;
      lstm_layer_kernel<<<lstm_grid, L_NT, 0, s>>>(
          w_ih, w_hh, bias, in, l == 0 ? E : H, hp + l * layer_state,
          hn + l * layer_state, c + l * layer_state, B, H);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    proj_kernel<<<proj_grid, P_NT, 0, s>>>(
        w_proj, b_proj, hn + (size_t)(nl - 1) * layer_state, H, V, B, pmax,
        pidx, psum, ntile);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    finalize_kernel<<<B, F_NT, 0, s>>>(pmax, pidx, psum, ntile, embed, E, x,
                                       ids, lps, t, T);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return 0;
}

}  // extern "C"
