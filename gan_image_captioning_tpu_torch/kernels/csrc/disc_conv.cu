// Discriminator conv bank + bias + ReLU + max over time, and its backward,
// for Hopper (sm_90a), float32.
//
// Replaces: gan_image_captioning_tpu/kernels/disc_conv.py, functions
// `_mxu_fwd_kernel` and `_mxu_bwd_dx_kernel` (launched per bank by
// `conv_relu_maxpool_mxu` through `_mxu_bank_call`).  A column q = (b, r)
// is one sequence b seen through representation r: its rows are
// x_q[t*eds + e] = emb_pad[b, t, r*eds + e] for the L real time rows (the
// maxf-1 rows of zero time padding are never read).  For one bank of n
// filters of f taps (w [n, f*eds], a row slice of w_all with row stride
// ldw):
//   forward:  z[q, n, t] = relu(sum_k x_q[t*eds + k] * w[n, k] + bias[n])
//             pooled[q, n] = max_t z, idx[q, n] = first argmax (t < lv)
//             with m starting at -1 and a strict >, so an all-zero column
//             gets idx 0, as the TPU kernel does
//   backward, from dpm[q, n] = d_pooled masked by pooled > 0 (computed
//   outside, with db):
//             d_emb row t*eds + k of column q  += w[n, k] * dpm[q, n]
//                                                 for t = idx[q, n]
//             dW[k, n] = sum_q x_q[idx[q, n]*eds + k] * dpm[q, n]
//   dW leaves as one partial per block, summed outside.
//
// What bounds it on this card.  At the training width (B = 64, R = 64,
// eds = 1, L = 36, banks 3/4/5 x 300) the forward does 0.97 GFLOP per
// pass (0.014 ms at 67 TFLOP/s) and moves 29.5 MB (0.009 ms): bound by
// operations.  The backward needs only the one time row idx[q, n] of each
// (q, n), so it is bound by bytes: idx and dpm read once (29.5 MB).  The
// TPU kernel's loop over every t with a mask, and its XT transpose of the
// input, are TPU artefacts and are not carried over.
//
// What this design does about it.  It is the simple version.
//   * conv_fwd_kernel: a block owns 32 columns and 64 filters; the
//     columns' real rows and the filters' taps sit in shared memory; one
//     thread per (q, n) output keeps the running max and argmax over t.
//   * conv_bwd_kernel: a block owns 16 columns; their idx and dpm rows,
//     input rows and the bank's taps sit in shared memory.  One thread per
//     (column, input row) sums w * dpm over the filters whose argmax puts
//     a tap on that row, and adds it to d_emb: a block owns its columns,
//     so no atomics are needed and the sum order is fixed.  One thread per
//     (tap, filter) sums the block's dW partial.
//
// conv_bwd_dxs_kernel replaces the same file's `_mxu_bwd_kernel`, the DXS
// variant of the MXU backward (the JAX package's GIC_MXU_DX=0).  It writes
// the same dW partials and, instead of d_emb, the per-step tap gradients
//   DXS[t, q, k] = sum_n [idx[q, n] == t] * dpm[q, n] * w[n, k]
// [lv, Q, f*eds], which the caller overlap-adds into d_emb with f shifted
// adds, as `_mxu_vjp_bwd` does.  DXS is f times the input's bytes (about
// 6.5 MB over the three banks at the training width), so it is bound by
// bytes.  Design: a block owns BW_QB columns, loaded as conv_bwd_kernel
// loads them (load_bwd_tiles); one thread per (column, tap) walks the
// filters once and adds each into the row idx of a [BW_QB, lv, taps]
// accumulator in shared
// memory (it owns its slots: no atomics); the block then writes its DXS
// slice, zeros included, with neighbouring threads on neighbouring taps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FW_QB = 32, FW_NB = 64, FW_NT = 256;
constexpr int BW_QB = 16, BW_NT = 256;  // both backward kernels

__host__ __device__ inline int odd(int v) { return v | 1; }

__global__ void __launch_bounds__(FW_NT) conv_fwd_kernel(
    const float* __restrict__ emb, const float* __restrict__ w, int ldw,
    const float* __restrict__ bias, int Q, int Lp, int R, int eds, int f,
    int L, int n, float* __restrict__ pooled, int ldp,
    int32_t* __restrict__ idx) {
  extern __shared__ float smem[];
  const int rows = L * eds, xld = odd(rows), taps = f * eds;
  float* xs = smem;                    // [FW_QB][xld]
  float* ws = smem + FW_QB * xld;      // [taps][FW_NB]
  const int q0 = blockIdx.x * FW_QB, n0 = blockIdx.y * FW_NB;
  const int tid = threadIdx.x, E = R * eds;

  for (int e = tid; e < FW_QB * rows; e += FW_NT) {
    const int qi = e % FW_QB, p = e / FW_QB, q = q0 + qi;
    float v = 0.f;
    if (q < Q) {
      const int b = q / R, r = q % R, t = p / eds, k = p % eds;
      v = emb[((size_t)b * Lp + t) * E + r * eds + k];
    }
    xs[qi * xld + p] = v;
  }
  for (int e = tid; e < taps * FW_NB; e += FW_NT) {
    const int nl = e % FW_NB, k = e / FW_NB, nn = n0 + nl;
    ws[k * FW_NB + nl] = nn < n ? w[(size_t)nn * ldw + k] : 0.f;
  }
  __syncthreads();

  const int lv = L - f + 1;
  for (int e = tid; e < FW_QB * FW_NB; e += FW_NT) {
    const int nl = e % FW_NB, qi = e / FW_NB, q = q0 + qi, nn = n0 + nl;
    if (q >= Q || nn >= n) continue;
    const float bv = bias[nn];
    const float* x = xs + qi * xld;
    float m = -1.f;
    int best = 0;
    for (int t = 0; t < lv; ++t) {
      float acc = 0.f;
      for (int k = 0; k < taps; ++k)
        acc = fmaf(x[t * eds + k], ws[k * FW_NB + nl], acc);
      const float z = fmaxf(acc + bv, 0.f);
      if (z > m) {  // strict: the first maximum wins
        m = z;
        best = t;
      }
    }
    pooled[(size_t)q * ldp + nn] = m;
    idx[(size_t)q * n + nn] = best;
  }
}

// The backward block's shared tiles, for columns [q0, q0 + BW_QB): the
// columns' input rows xs [BW_QB][xld], the bank's taps ws [taps][n], the
// masked pooled gradient ds and argmax rows is [BW_QB][nld].
struct BwdTiles {
  float* xs;
  float* ws;
  float* ds;
  int* is;
  int rows, xld, taps, n, nld, eds;
};

__device__ __forceinline__ BwdTiles load_bwd_tiles(
    float* smem, const float* __restrict__ emb, const float* __restrict__ w,
    int ldw, const int32_t* __restrict__ idx, const float* __restrict__ dpm,
    int Q, int Lp, int R, int eds, int f, int L, int n, int q0) {
  BwdTiles s;
  s.rows = L * eds, s.xld = odd(s.rows), s.taps = f * eds, s.n = n;
  s.nld = odd(n), s.eds = eds;
  s.xs = smem;
  s.ws = s.xs + BW_QB * s.xld;
  s.ds = s.ws + s.taps * n;
  s.is = reinterpret_cast<int*>(s.ds + BW_QB * s.nld);
  const int tid = threadIdx.x, E = R * eds;
  for (int e = tid; e < BW_QB * s.rows; e += BW_NT) {
    const int qi = e % BW_QB, p = e / BW_QB, q = q0 + qi;
    float v = 0.f;
    if (q < Q) {
      const int b = q / R, r = q % R, t = p / eds, k = p % eds;
      v = emb[((size_t)b * Lp + t) * E + r * eds + k];
    }
    s.xs[qi * s.xld + p] = v;
  }
  for (int e = tid; e < s.taps * n; e += BW_NT) {
    const int nn = e % n, k = e / n;
    s.ws[k * n + nn] = w[(size_t)nn * ldw + k];
  }
  for (int e = tid; e < BW_QB * n; e += BW_NT) {
    const int nn = e % n, qi = e / n, q = q0 + qi;
    const bool in = q < Q;
    s.ds[qi * s.nld + nn] = in ? dpm[(size_t)q * n + nn] : 0.f;
    s.is[qi * s.nld + nn] = in ? idx[(size_t)q * n + nn] : 0;
  }
  return s;
}

// The block's dW partial [taps, n]: one thread per (tap, filter) sums the
// block's columns at their argmax rows.
__device__ __forceinline__ void dw_partial(const BwdTiles& s,
                                           float* __restrict__ part) {
  for (int e = threadIdx.x; e < s.taps * s.n; e += BW_NT) {
    const int nn = e % s.n, k = e / s.n;
    float acc = 0.f;
    for (int qi = 0; qi < BW_QB; ++qi)
      acc = fmaf(s.xs[qi * s.xld + s.is[qi * s.nld + nn] * s.eds + k],
                 s.ds[qi * s.nld + nn], acc);
    part[(size_t)k * s.n + nn] = acc;
  }
}

__global__ void __launch_bounds__(BW_NT) conv_bwd_kernel(
    const float* __restrict__ emb, const float* __restrict__ w, int ldw,
    const int32_t* __restrict__ idx, const float* __restrict__ dpm, int Q,
    int Lp, int R, int eds, int f, int L, int n, float* __restrict__ d_emb,
    float* __restrict__ dw_part) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * BW_QB, tid = threadIdx.x, E = R * eds;
  const BwdTiles s = load_bwd_tiles(smem, emb, w, ldw, idx, dpm, Q, Lp, R,
                                    eds, f, L, n, q0);
  __syncthreads();

  // input rows: d_emb[b, p / eds, r*eds + p % eds] += sum over filters
  for (int e = tid; e < BW_QB * s.rows; e += BW_NT) {
    const int qi = e % BW_QB, p = e / BW_QB, q = q0 + qi;
    if (q >= Q) continue;
    float acc = 0.f;
    for (int nn = 0; nn < n; ++nn) {
      const int k = p - s.is[qi * s.nld + nn] * eds;
      if (k >= 0 && k < s.taps)
        acc = fmaf(s.ws[k * n + nn], s.ds[qi * s.nld + nn], acc);
    }
    const int b = q / R, r = q % R, t = p / eds, k = p % eds;
    d_emb[((size_t)b * Lp + t) * E + r * eds + k] += acc;
  }
  dw_partial(s, dw_part + (size_t)blockIdx.x * s.taps * n);
}

__global__ void __launch_bounds__(BW_NT) conv_bwd_dxs_kernel(
    const float* __restrict__ emb, const float* __restrict__ w, int ldw,
    const int32_t* __restrict__ idx, const float* __restrict__ dpm, int Q,
    int Lp, int R, int eds, int f, int L, int n, float* __restrict__ dxs,
    float* __restrict__ dw_part) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * BW_QB, tid = threadIdx.x, lv = L - f + 1;
  const BwdTiles s = load_bwd_tiles(smem, emb, w, ldw, idx, dpm, Q, Lp, R,
                                    eds, f, L, n, q0);
  const int taps = s.taps;
  float* acc = reinterpret_cast<float*>(s.is + BW_QB * s.nld);  // [BW_QB][lv][taps]
  for (int e = tid; e < BW_QB * lv * taps; e += BW_NT) acc[e] = 0.f;
  __syncthreads();

  // per-step tap gradients: each (column, tap) adds every filter into the
  // filter's argmax step
  for (int e = tid; e < BW_QB * taps; e += BW_NT) {
    const int k = e % taps, qi = e / taps;
    float* a = acc + (size_t)qi * lv * taps + k;
    for (int nn = 0; nn < n; ++nn) {
      const float d = s.ds[qi * s.nld + nn];
      if (d != 0.f) {
        const int t = s.is[qi * s.nld + nn];
        a[t * taps] = fmaf(s.ws[k * n + nn], d, a[t * taps]);
      }
    }
  }
  dw_partial(s, dw_part + (size_t)blockIdx.x * taps * n);
  __syncthreads();
  const int cols = min(BW_QB, Q - q0);
  for (int e = tid; e < lv * cols * taps; e += BW_NT) {
    const int k = e % taps, qi = (e / taps) % cols, t = e / (taps * cols);
    dxs[((size_t)t * Q + q0 + qi) * taps + k] =
        acc[((size_t)qi * lv + t) * taps + k];
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

size_t fwd_smem(int L, int eds, int f) {
  return sizeof(float) * ((size_t)FW_QB * odd(L * eds) + (size_t)f * eds * FW_NB);
}

size_t bwd_smem(int L, int eds, int f, int n) {
  return sizeof(float) * ((size_t)BW_QB * odd(L * eds) + (size_t)f * eds * n +
                          2 * (size_t)BW_QB * odd(n));
}

size_t dxs_smem(int L, int eds, int f, int n) {
  return bwd_smem(L, eds, f, n) +
         sizeof(float) * (size_t)BW_QB * (L - f + 1) * f * eds;
}

}  // namespace

extern "C" {

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of either backward: the leading dimension of dw_part.
int gic_conv_bwd_blocks(int Q) { return (Q + BW_QB - 1) / BW_QB; }

// One bank's forward on `stream`.  emb [Bn, Lp, R*eds]; w, bias this
// bank's rows of w_all [F, ldw] and b_all; Q = Bn*R.  Outputs: pooled
// (this bank's first column of a [Q, ldp] matrix) and idx [Q, n].
int gic_conv_fwd(const float* emb, const float* w, int ldw,
                 const float* bias, int Bn, int Lp, int R, int eds, int f,
                 int L, int n, float* pooled, int ldp, int32_t* idx,
                 void* stream) {
  const int Q = Bn * R;
  const size_t smem = fwd_smem(L, eds, f);
  cudaError_t err = set_smem((const void*)conv_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + FW_QB - 1) / FW_QB, (n + FW_NB - 1) / FW_NB);
  conv_fwd_kernel<<<grid, FW_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      emb, w, ldw, bias, Q, Lp, R, eds, f, L, n, pooled, ldp, idx);
  return cudaGetLastError();
}

// One bank's backward on `stream`: adds this bank's input gradient into
// d_emb [Bn, Lp, R*eds] and writes dw_part [gic_conv_bwd_blocks(Q), f*eds,
// n].  idx, dpm [Q, n].
int gic_conv_bwd(const float* emb, const float* w, int ldw,
                 const int32_t* idx, const float* dpm, int Bn, int Lp, int R,
                 int eds, int f, int L, int n, float* d_emb, float* dw_part,
                 void* stream) {
  const int Q = Bn * R;
  const size_t smem = bwd_smem(L, eds, f, n);
  cudaError_t err = set_smem((const void*)conv_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  conv_bwd_kernel<<<gic_conv_bwd_blocks(Q), BW_NT, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      emb, w, ldw, idx, dpm, Q, Lp, R, eds, f, L, n, d_emb, dw_part);
  return cudaGetLastError();
}

// One bank's DXS backward on `stream`: writes dxs [lv, Bn*R, f*eds] (every
// entry) and dw_part [gic_conv_bwd_blocks(Q), f*eds, n].  idx, dpm [Q, n].
int gic_conv_bwd_dxs(const float* emb, const float* w, int ldw,
                     const int32_t* idx, const float* dpm, int Bn, int Lp,
                     int R, int eds, int f, int L, int n, float* dxs,
                     float* dw_part, void* stream) {
  const int Q = Bn * R;
  const size_t smem = dxs_smem(L, eds, f, n);
  cudaError_t err = set_smem((const void*)conv_bwd_dxs_kernel, smem);
  if (err != cudaSuccess) return err;
  conv_bwd_dxs_kernel<<<gic_conv_bwd_blocks(Q), BW_NT, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      emb, w, ldw, idx, dpm, Q, Lp, R, eds, f, L, n, dxs, dw_part);
  return cudaGetLastError();
}

}  // extern "C"
