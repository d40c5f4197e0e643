// Discriminator conv bank + bias + ReLU + max over time, and its backward,
// one block per batch row, for Hopper (sm_90a), float32.
//
// Replaces: gan_image_captioning_tpu/kernels/disc_conv.py, functions
// `_fwd_kernel` and `_bwd_kernel` (the engine `pallas` forward and
// backward; `hybrid` pairs the backward with a plain forward), launched per
// bank by `_bank_call` over a grid of batch rows.  For batch row b, time
// row t, representation r, tap k = j*eds + e of a bank of n filters of f
// taps (w [n, f*eds], a row slice of w_all with row stride ldw) and
// lv = L - f + 1 valid positions over the L real time rows:
//   forward:  z[t, r, n] = relu(bias[n] + sum_k emb[b, t+j, r*eds+e] w[n, k])
//             pooled[b, r, n] = max_t z, idx[b, r, n] = first argmax,
//             with the max starting at -1 and updated on a strict >, so an
//             all-zero column gets idx 0, as the TPU kernel does
//   backward, from the raw pooled gradient dpool:
//             dp[r, n] = pooled[b, r, n] > 0 ? dpool[b, r, n] : 0
//             db_part[b, n]   = sum_r dp[r, n]
//             dw_part[b, k, n] = sum_r emb[b, idx[r,n]+j, r*eds+e] dp[r, n]
//             d_emb[b, t, r*eds+e] += sum over n with 0 <= t-idx[r,n] < f
//                                     of w[n, (t-idx)*eds+e] dp[r, n]
//   The per-row dW and db leave as partials that the caller sums, as the
//   JAX caller sums the TPU kernel's (`_vjp_bwd`).
//
// What bounds it on this card.  The forward is the same function as the
// `mxu` forward (csrc/disc_conv.cu): at the training width (B = 64,
// R = 64, eds = 1, L = 36, banks 3/4/5 x 300) 0.97 GFLOP per pass, 0.0145
// ms at 67 TFLOP/s, bound by operations.  The backward needs only the one
// time row idx of each (r, n): bound by bytes (emb, idx, pooled and dpool
// read once, d_emb and the per-row dW partials written once).
//
// What this design does about it.  It is the simple version, tiled as the
// TPU kernel's grid is: by batch row.
//   * conv_rows_fwd: one block per (batch row, tile of RF_NB filters); the
//     row's L real time rows [L, R*eds] and the tile's taps sit in shared
//     memory; one thread per (r, n) keeps the running max and argmax, the
//     filter index fastest so a warp reads neighbouring taps.
//   * conv_rows_bwd: one block per batch row, which owns that row's d_emb,
//     dW and db partials: no atomics, a fixed sum order.  It walks the
//     filters in chunks of RB_NB: the chunk's masked dp and idx [R, RB_NB]
//     and taps go to shared memory; one thread per (tap, filter) sums dW,
//     one per filter db, and one per (t, r, e) of the row adds the chunk's
//     taps into a d_emb accumulator in shared memory, written at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RF_NB = 64, RF_NT = 256;
constexpr int RB_NB = 32, RB_NT = 256;

__global__ void __launch_bounds__(RF_NT) conv_rows_fwd_kernel(
    const float* __restrict__ emb, const float* __restrict__ w, int ldw,
    const float* __restrict__ bias, int Lp, int R, int eds, int f, int L,
    int n, float* __restrict__ pooled, int ldp, int32_t* __restrict__ idx) {
  extern __shared__ float smem[];
  const int E = R * eds, taps = f * eds;
  float* xs = smem;               // [L][E]: row b's real time rows
  float* ws = smem + L * E;       // [taps][RF_NB]
  const int b = blockIdx.x, n0 = blockIdx.y * RF_NB, tid = threadIdx.x;

  const float* row = emb + (size_t)b * Lp * E;
  for (int e = tid; e < L * E; e += RF_NT) xs[e] = row[e];
  for (int e = tid; e < taps * RF_NB; e += RF_NT) {
    const int nl = e % RF_NB, k = e / RF_NB, nn = n0 + nl;
    ws[e] = nn < n ? w[(size_t)nn * ldw + k] : 0.f;
  }
  __syncthreads();

  const int lv = L - f + 1;
  for (int e = tid; e < R * RF_NB; e += RF_NT) {
    const int nl = e % RF_NB, r = e / RF_NB, nn = n0 + nl;
    if (nn >= n) continue;
    const float bv = bias[nn];
    const float* x = xs + r * eds;
    float m = -1.f;
    int best = 0;
    for (int t = 0; t < lv; ++t) {
      float acc = bv;
      for (int j = 0; j < f; ++j)
        for (int q = 0; q < eds; ++q)
          acc = fmaf(x[(t + j) * E + q], ws[(j * eds + q) * RF_NB + nl], acc);
      const float z = fmaxf(acc, 0.f);
      if (z > m) {  // strict: the first maximum wins
        m = z;
        best = t;
      }
    }
    pooled[((size_t)b * R + r) * ldp + nn] = m;
    idx[((size_t)b * R + r) * n + nn] = best;
  }
}

__global__ void __launch_bounds__(RB_NT) conv_rows_bwd_kernel(
    const float* __restrict__ emb, const float* __restrict__ w, int ldw,
    const float* __restrict__ pooled, const float* __restrict__ dpool,
    int ldp, const int32_t* __restrict__ idx, int Lp, int R, int eds, int f,
    int L, int n, float* __restrict__ d_emb, float* __restrict__ dw_part,
    float* __restrict__ db_part) {
  extern __shared__ float smem[];
  constexpr int CLD = RB_NB + 1;  // odd stride: a warp's r differ
  const int E = R * eds, taps = f * eds, b = blockIdx.x, tid = threadIdx.x;
  float* xs = smem;                 // [L][E]: row b's real time rows
  float* acc = xs + L * E;          // [L][E]: d_emb accumulator
  float* ws = acc + L * E;          // [taps][RB_NB]
  float* ds = ws + taps * RB_NB;    // [R][CLD] masked dpool
  int* is = reinterpret_cast<int*>(ds + R * CLD);  // [R][CLD] idx

  const float* row = emb + (size_t)b * Lp * E;
  for (int e = tid; e < L * E; e += RB_NT) {
    xs[e] = row[e];
    acc[e] = 0.f;
  }
  float* dwp = dw_part + (size_t)b * taps * n;
  float* dbp = db_part + (size_t)b * n;
  for (int n0 = 0; n0 < n; n0 += RB_NB) {
    const int nb = min(RB_NB, n - n0);
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < taps * RB_NB; e += RB_NT) {
      const int nl = e % RB_NB, k = e / RB_NB;
      ws[e] = nl < nb ? w[(size_t)(n0 + nl) * ldw + k] : 0.f;
    }
    for (int e = tid; e < R * RB_NB; e += RB_NT) {
      const int nl = e % RB_NB, r = e / RB_NB;
      float d = 0.f;
      int t = 0;
      if (nl < nb) {
        const size_t o = ((size_t)b * R + r) * ldp + n0 + nl;
        d = pooled[o] > 0.f ? dpool[o] : 0.f;  // the ReLU mask
        t = idx[((size_t)b * R + r) * n + n0 + nl];
      }
      ds[r * CLD + nl] = d;
      is[r * CLD + nl] = t;
    }
    __syncthreads();

    for (int e = tid; e < nb; e += RB_NT) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s += ds[r * CLD + e];
      dbp[n0 + e] = s;
    }
    for (int e = tid; e < taps * nb; e += RB_NT) {
      const int nl = e % nb, k = e / nb, j = k / eds, q = k % eds;
      float s = 0.f;
      for (int r = 0; r < R; ++r)
        s = fmaf(xs[(is[r * CLD + nl] + j) * E + r * eds + q],
                 ds[r * CLD + nl], s);
      dwp[(size_t)k * n + n0 + nl] = s;
    }
    for (int e = tid; e < L * E; e += RB_NT) {
      const int t = e / E, c = e % E, r = c / eds, q = c % eds;
      float s = acc[e];
      for (int nl = 0; nl < nb; ++nl) {
        const int j = t - is[r * CLD + nl];
        if (j >= 0 && j < f)
          s = fmaf(ws[(j * eds + q) * RB_NB + nl], ds[r * CLD + nl], s);
      }
      acc[e] = s;
    }
  }
  __syncthreads();
  float* out = d_emb + (size_t)b * Lp * E;
  for (int e = tid; e < L * E; e += RB_NT) out[e] += acc[e];
}

// Dynamic shared memory above 48 KB must be allowed per kernel; above the
// card's 227 KB the attribute call fails and the launch reports it.
cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One bank's forward on `stream`.  emb [Bn, Lp, R*eds]; w, bias this bank's
// rows of w_all [F, ldw] and b_all.  Outputs: pooled (this bank's first
// column of a [Bn, R, ldp] tensor) and idx [Bn, R, n].
int gic_conv_rows_fwd(const float* emb, const float* w, int ldw,
                      const float* bias, int Bn, int Lp, int R, int eds,
                      int f, int L, int n, float* pooled, int ldp,
                      int32_t* idx, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)L * R * eds + (size_t)f * eds * RF_NB);
  cudaError_t err = set_smem((const void*)conv_rows_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Bn, (n + RF_NB - 1) / RF_NB);
  conv_rows_fwd_kernel<<<grid, RF_NT, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      emb, w, ldw, bias, Lp, R, eds, f, L, n, pooled, ldp, idx);
  return cudaGetLastError();
}

// One bank's backward on `stream`: adds this bank's input gradient into
// d_emb [Bn, Lp, R*eds] and writes the per-row partials dw_part
// [Bn, f*eds, n] and db_part [Bn, n].  pooled and dpool: this bank's first
// column of [Bn, R, ldp] tensors; idx [Bn, R, n].
int gic_conv_rows_bwd(const float* emb, const float* w, int ldw,
                      const float* pooled, const float* dpool, int ldp,
                      const int32_t* idx, int Bn, int Lp, int R, int eds,
                      int f, int L, int n, float* d_emb, float* dw_part,
                      float* db_part, void* stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)L * R * eds + (size_t)f * eds * RB_NB +
                       2 * (size_t)R * (RB_NB + 1));
  cudaError_t err = set_smem((const void*)conv_rows_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  conv_rows_bwd_kernel<<<Bn, RB_NT, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      emb, w, ldw, pooled, dpool, ldp, idx, Lp, R, eds, f, L, n, d_emb,
      dw_part, db_part);
  return cudaGetLastError();
}

}  // extern "C"
