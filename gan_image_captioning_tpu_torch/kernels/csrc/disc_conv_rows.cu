// Discriminator conv bank + bias + ReLU + max over time, one block per
// batch row, for Hopper (sm_90a), float32: the forward of the engine
// `pallas`.
//
// Replaces: gan_image_captioning_tpu/kernels/disc_conv.py, function
// `_fwd_kernel` (the engine `pallas` forward), launched per bank by
// `_bank_call` over a grid of batch rows.  For batch row b, time row t,
// representation r, tap k = j*eds + e of a bank of n filters of f taps
// (w [n, f*eds], a row slice of w_all with row stride ldw) and
// lv = L - f + 1 valid positions over the L real time rows:
//   z[t, r, n] = relu(bias[n] + sum_k emb[b, t+j, r*eds+e] w[n, k])
//   pooled[b, r, n] = max_t z, idx[b, r, n] = first argmax,
//   with the max starting at -1 and updated on a strict >, so an all-zero
//   column gets idx 0, as the TPU kernel does.
// The engine's backward (`_bwd_kernel`: the raw pooled gradient masked by
// pooled > 0, db its masked sum, dW and d_emb at the argmax rows) is
// disc_conv.cu's conv_bwd_kernel with the mask in the launch
// (gic_conv_bwd, mask = 1): one launch for every bank of a pass, tiled by
// column rather than by batch row (which gave 64 blocks on 132 SMs), and
// one fixed-order reduction of the dW and db partials.
//
// What bounds it on this card.  The same function as the `mxu` forward
// (disc_conv.cu): at the training width (B = 64, R = 64, eds = 1, L = 36,
// banks 3/4/5 x 300) 0.97 GFLOP per pass, 0.0145 ms at 67 TFLOP/s, bound
// by operations.
//
// What this design does about it: the simple version, tiled as the TPU
// kernel's grid is, by batch row: one block per (batch row, tile of RF_NB
// filters); the row's L real time rows [L, R*eds] and the tile's taps sit
// in shared memory; one thread per (r, n) keeps the running max and
// argmax, the filter index fastest so a warp reads neighbouring taps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RF_NB = 64, RF_NT = 256;

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

}  // extern "C"
