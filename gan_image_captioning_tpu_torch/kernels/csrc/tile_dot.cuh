// Register-tiled float32 product shared by the port's CUDA kernels.
//
// tile_dot computes, for one block, an (RT rows) x (BT batch rows) tile of
//   acc[row][b] = sum_k W(row)[k] * X(b)[k]
// with W and X of element type T (float, or bfloat16 widened exactly as it
// is loaded: bf16.cuh's to_f), every product and sum in float32.
// where W(R)[k] = k < K0 ? w0[R*K0 + k] : w1[R*K1 + k - K0] and X(b)[k]
// likewise from x0 [B, K0] and x1 [B, K1] (a row split over two matrices
// is how the LSTM kernel reads [x | h] without a concatenation).  One K
// tile of W and X lives in shared memory; the next one is loaded into
// registers while the current one is consumed.  Rows past the edge and
// batch rows >= B read zeros.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "bf16.cuh"

namespace gic {

constexpr int KT = 32;  // depth of one K tile

template <int RT, int BT, int TR, int TB, class Rows, class T = float>
__device__ __forceinline__ void tile_dot(
    Rows rows, const T* __restrict__ w0, const T* __restrict__ w1,
    const T* __restrict__ x0, const T* __restrict__ x1, int K0,
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
        v = to_f(k < K0 ? w0[(size_t)R * K0 + k]
                        : w1[(size_t)R * K1 + (k - K0)]);
      wreg[n] = v;
    }
#pragma unroll
    for (int n = 0; n < XPT; ++n) {
      const int e = tid + n * NT, b = b0 + e / KT, k = k0 + e % KT;
      float v = 0.f;
      if (b < B && k < K)
        v = to_f(k < K0 ? x0[(size_t)b * K0 + k]
                        : x1[(size_t)b * K1 + (k - K0)]);
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

}  // namespace gic
