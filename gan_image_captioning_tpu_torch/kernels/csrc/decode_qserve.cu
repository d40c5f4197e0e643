// Greedy serve decode on weight-only quantized weights, for Hopper
// (sm_90a): int8, or int4 packed two per byte, with float32 per-output-
// channel scales; with or without carried (h, c, x) state.
//
// Replaces: gan_image_captioning_tpu/kernels/decode_sample.py, function
// `_qserve_kernel` (launched by `decode_sample_q_serve`).  Weights in the
// layout of ops/quantize.py:quantize_lstm_decoder:
//   per layer  Wq [In+H, 4H] (the fused [x | h] gate matrix), scale [4H],
//              bias b [4H] (b_ih + b_hh, float32)
//   projection Pq [H, V] (pre-transposed), scale [V], bias [V]
//   embedding  Eq [V, E], scale [E]
// bits = 4: each payload packed along its first axis, R packed rows: byte
// row r holds row r in its low nibble and row r + R in its high nibble
// (nibbles sign-extended, values in [-7, 7]).  The embedding of an odd
// vocabulary has one zero pad row, never selected.  Per step t:
//   gates_l = [x | h_l] @ deq(Wq_l) + b_l ;  c_l, h_l as the dense decode
//   logits  = h_top @ deq(Pq) + bias ;  ids[b, t] = first argmax
//   lps[b, t] = -log(sum(exp(logits - max))) ;  x = deq(Eq)[ids[:, t]]
// with deq(Q)[k, n] = float(Q[k, n]) * scale[n].
//
// What differs from the TPU kernel.  The TPU kernel dequantizes every
// weight once into VMEM (many MB of fast memory).  At config3 width the
// dequantized float32 weights are 39 MB (62 MB with the embedding), more
// than all of the H100's shared memory (about 30 MB over 132 SMs).  So
// the weights stay int8 / packed int4 in device memory and each block
// dequantizes the K tile it loads: one int8 load (or one byte, two
// nibbles) per element, a convert and one multiply by the column's scale,
// and the float goes to shared memory for the register-tiled FMA loop of
// tile_dot.cuh.  int8 or int4 is then the only weight traffic.
//
// Where the scale is applied.  Per element, at the load: float(q) * s is
// rounded once, as dequantize() rounds it, and the product then runs the
// dense kernel's K order (tile_dot_cols: tile_dot's tiles and per-thread
// FMA chain).  So this kernel gives, bit for bit, what the dense serve kernel
// (decode_serve.cu) gives on the dequantized weights; against the plain
// PyTorch version (dequantize, then the dense plain decode) it differs by
// the order of float32 sums: logprobs within 1e-4 (chip_smoke.py).
//
// What bounds it on this card.  The same operations as the dense decode
// (2*B*T*((E+H)*4H + 2H*4H + H*V) = 5.7 GFLOP at B = 8, T = 36: 0.085 ms
// at 67 TFLOP/s float32) over a quarter (int8) or an eighth (int4) of its
// weight bytes; in practice, as in the dense decode, the latency of nl + 2
// launches per step, each waiting on its K loop.
//
// The host loop is decode_serve.cu's: per step one qlstm_layer_kernel per
// layer (a block owns 4 hidden units, i.e. 16 gate columns, and 32 batch
// rows), one qproj_kernel (64 vocabulary columns x 32 batch rows, with the
// tile's max / first argmax / sum(exp)), one qfinalize_kernel per row
// (combine the tiles, ids / lps, x = deq(Eq)[id]).  Loads along a [K, N]
// weight are coalesced over the columns (tile_dot_cols).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "tile_dot.cuh"

using namespace gic;

namespace {

// Element (k, n) of a quantized [K, N] weight with per-column scales:
// int8, or packed int4 with R packed rows.
template <int BITS>
__device__ __forceinline__ float dequant(const int8_t* __restrict__ q,
                                         const float* __restrict__ scale,
                                         int R, int N, int k, int n) {
  int v;
  if (BITS == 8) {
    v = q[(size_t)k * N + n];
  } else if (k < R) {
    v = ((q[(size_t)k * N + n] & 0x0F) ^ 8) - 8;  // low nibble, signed
  } else {
    v = q[(size_t)(k - R) * N + n] >> 4;  // high nibble (arithmetic shift)
  }
  return (float)v * scale[n];
}

// One layer of one step against the quantized fused weight [In+H, 4H]:
// gates for hidden units [j0, j0+JT) and batch rows [b0, b0+L_BT), then
// the cell update (c in place, h into the other ping-pong half).
template <int BITS>
__global__ void __launch_bounds__(L_NT) qlstm_layer_kernel(
    const int8_t* __restrict__ wq, const float* __restrict__ wscale,
    const float* __restrict__ bias, int R, const float* __restrict__ x,
    int In, const float* __restrict__ h_prev, float* __restrict__ h_next,
    float* __restrict__ c, int B, int H) {
  __shared__ float Ws[L_RT][KT + 1];
  __shared__ float Xs[L_BT][KT + 1];
  __shared__ float Gs[L_RT][L_BT + 1];
  constexpr int NR = L_RT / L_TR, NB = L_BT / L_TB;
  const int j0 = blockIdx.x * JT, b0 = blockIdx.y * L_BT;
  const int tid = threadIdx.x, tr = tid % NR, tb = tid / NR;
  const LstmRows cols{j0, H};
  const int N = 4 * H;
  auto w_at = [&](int r, int k) {
    const int n = cols(r);
    return n < 0 ? 0.f : dequant<BITS>(wq, wscale, R, N, k, n);
  };

  float acc[L_TR][L_TB];
  tile_dot_cols<L_RT, L_BT, L_TR, L_TB>(w_at, x, h_prev, In, H, b0, B, acc,
                                       Ws, Xs);
#pragma unroll
  for (int i = 0; i < L_TR; ++i)
#pragma unroll
    for (int j = 0; j < L_TB; ++j) Gs[tr + i * NR][tb + j * NB] = acc[i][j];
  __syncthreads();
  lstm_cell_tile(Gs, bias, j0, b0, B, H, c, h_next, nullptr, nullptr,
                 nullptr);
}

// Vocabulary projection of one (64-column, 32-row batch) tile against the
// quantized [H, V] weight, with the tile's softmax statistics.
template <int BITS>
__global__ void __launch_bounds__(P_NT) qproj_kernel(
    const int8_t* __restrict__ wq, const float* __restrict__ wscale, int R,
    const float* __restrict__ bias, const float* __restrict__ h, int H,
    int V, int B, float* __restrict__ pmax, int* __restrict__ pidx,
    float* __restrict__ psum, int ntile) {
  __shared__ float Ws[P_RT][KT + 1];
  __shared__ float Xs[P_BT][KT + 1];
  __shared__ float Ls[P_BT][P_RT + 1];
  constexpr int NR = P_RT / P_TR, NB = P_BT / P_TB;
  const int v0 = blockIdx.x * P_RT, b0 = blockIdx.y * P_BT;
  const int tid = threadIdx.x, tr = tid % NR, tb = tid / NR;
  const ProjRows cols{v0, V};
  auto w_at = [&](int r, int k) {
    const int n = cols(r);
    return n < 0 ? 0.f : dequant<BITS>(wq, wscale, R, V, k, n);
  };

  float acc[P_TR][P_TB];
  tile_dot_cols<P_RT, P_BT, P_TR, P_TB>(w_at, h, nullptr, H, 0, b0, B, acc,
                                       Ws, Xs);
#pragma unroll
  for (int i = 0; i < P_TR; ++i) {
    const int r = tr + i * NR, v = v0 + r;
    const float bv = v < V ? bias[v] : 0.f;
#pragma unroll
    for (int j = 0; j < P_TB; ++j) Ls[tb + j * NB][r] = acc[i][j] + bv;
  }
  __syncthreads();
  proj_tile_stats(Ls, v0, V, b0, B, pmax, pidx, psum, ntile);
}

// One block per batch row: combine the vocabulary tiles, emit ids/lps for
// step t, and write the dequantized embedding row of the id into x.
template <int BITS>
__global__ void __launch_bounds__(F_NT) qfinalize_kernel(
    const float* __restrict__ pmax, const int* __restrict__ pidx,
    const float* __restrict__ psum, int ntile, const int8_t* __restrict__ eq,
    const float* __restrict__ escale, int R, int E, float* __restrict__ x,
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
    lps[(size_t)b * T + t] = -logf(total);
    s_id = id;
  }
  __syncthreads();
  for (int e = tid; e < E; e += F_NT)
    x[(size_t)b * E + e] = dequant<BITS>(eq, escale, R, E, s_id, e);
}

template <int BITS>
cudaError_t qserve(const float* feats, const void* const* layer_ptrs,
                   const int8_t* pq, const float* ps, const float* pb,
                   const int8_t* eq, const float* es, int B, int E, int H,
                   int V, int R_emb, int nl, int T, const float* h0,
                   const float* c0, const float* x0, float* x, float* h,
                   float* c, float* pmax, int* pidx, float* psum,
                   int32_t* ids, float* lps, float* hT, float* cT, float* xT,
                   cudaStream_t s) {
  const int ntile = (V + P_RT - 1) / P_RT;
  const size_t layer_state = (size_t)B * H;
  cudaError_t err = init_state(feats, h0, c0, x0, B, E, H, nl, x, h, c, s);
  if (err != cudaSuccess) return err;

  const dim3 lstm_grid((H + JT - 1) / JT, (B + L_BT - 1) / L_BT);
  const dim3 proj_grid(ntile, (B + P_BT - 1) / P_BT);
  for (int t = 0; t < T; ++t) {
    const float* hp = h_read(h, nl, B, H, t);
    float* hn = h_write(h, nl, B, H, t);
    for (int l = 0; l < nl; ++l) {
      const int In = l == 0 ? E : H;
      const int8_t* wq = static_cast<const int8_t*>(layer_ptrs[3 * l]);
      const float* wscale = static_cast<const float*>(layer_ptrs[3 * l + 1]);
      const float* bias = static_cast<const float*>(layer_ptrs[3 * l + 2]);
      const float* in = l == 0 ? x : hn + (size_t)(l - 1) * layer_state;
      qlstm_layer_kernel<BITS><<<lstm_grid, L_NT, 0, s>>>(
          wq, wscale, bias, (In + H) / 2, in, In, hp + l * layer_state,
          hn + l * layer_state, c + l * layer_state, B, H);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    qproj_kernel<BITS><<<proj_grid, P_NT, 0, s>>>(
        pq, ps, H / 2, pb, top_h(h, nl, B, H, t), H, V, B, pmax, pidx, psum,
        ntile);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    qfinalize_kernel<BITS><<<B, F_NT, 0, s>>>(pmax, pidx, psum, ntile, eq, es,
                                              R_emb, E, x, ids, lps, t, T);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return emit_state(h, c, x, B, E, H, nl, T, hT, cT, xT, s);
}

}  // namespace

extern "C" {

// Vocabulary columns per projection tile (the per-tile scratch is
// [B, ceil(V / tile)] per statistic).
int gic_proj_tile(void) { return P_RT; }

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The whole T-step quantized greedy decode on `stream`.  layer_ptrs holds
// 3*nl device pointers per layer: Wq (int8 [In+H, 4H], or packed
// [(In+H)/2, 4H]), its scale [4H] and the bias [4H].  pq / ps / pb: the
// projection [H, V] (packed [H/2, V]), its scale [V] and bias [V]; eq / es:
// the embedding (int8 [V, E], or packed [R_emb, E]) and its scale [E].
// bits: 8 or 4.  State, scratch and outputs as gic_decode_serve (carried
// state pointers may each be null).  Returns 0 or the first CUDA error
// code (cudaErrorInvalidValue for bits other than 4 and 8).
int gic_decode_qserve(const float* feats, const void* const* layer_ptrs,
                      const int8_t* pq, const float* ps, const float* pb,
                      const int8_t* eq, const float* es, int bits, int B,
                      int E, int H, int V, int R_emb, int nl, int T,
                      const float* h0, const float* c0, const float* x0,
                      float* x, float* h, float* c, float* pmax, int* pidx,
                      float* psum, int32_t* ids, float* lps, float* hT,
                      float* cT, float* xT, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    return qserve<8>(feats, layer_ptrs, pq, ps, pb, eq, es, B, E, H, V, R_emb,
                     nl, T, h0, c0, x0, x, h, c, pmax, pidx, psum, ids, lps,
                     hT, cT, xT, s);
  if (bits == 4)
    return qserve<4>(feats, layer_ptrs, pq, ps, pb, eq, es, B, E, H, V, R_emb,
                     nl, T, h0, c0, x0, x, h, c, pmax, pidx, psum, ids, lps,
                     hT, cT, xT, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
