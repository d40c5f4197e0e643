// Blocked (flash) self-attention for Hopper (sm_90a), float32: the forward
// with its logsumexp, and the two backward kernels that recompute the
// probabilities from it.
//
// Replaces: gan_image_captioning_tpu/kernels/flash_attention.py, functions
// `_fwd_kernel`, `_dq_kernel` and `_dkv_kernel` (launched by
// `flash_attention` through `_forward` / `_backward`).  For q, k, v
// [B, T, H, D] (the JAX package's bqhd layout, read in place: no transpose)
// and per batch row a key length len_b = min(lengths[b], T) (T without
// lengths), key j is valid for query row i when j < len_b, and j <= i when
// causal.  With s_ij = (q_i . k_j) / sqrt(D) over the valid keys:
//   forward: m_i = max_j s_ij, l_i = sum_j exp(s_ij - m_i),
//            out_i = sum_j exp(s_ij - m_i) v_j / max(l_i, 1e-30),
//            lse_i = m_i + log(max(l_i, 1e-30))      (a row with no valid
//            key gives out 0 and lse about -1e30, as the TPU kernel's
//            finite -1e30 fill does)
//   dQ:      p_ij = exp(s_ij - lse_i), dp_ij = dO_i . v_j,
//            dq_i = sum_j p_ij (dp_ij - delta_i) k_j / sqrt(D)
//   dK, dV:  dv_j = sum_i p_ij dO_i, dk_j = sum_i p_ij (dp_ij - delta_i) q_i
//            / sqrt(D)
// with delta_i = dO_i . out_i computed by the wrapper (one PyTorch
// reduction, as the JAX package leaves it to XLA).  lse and delta are
// [B, T, H] float32.  Rows i >= T are neither read nor written: the ragged
// edge is masked here, where the TPU wrapper pads T to a block multiple.
//
// What bounds it on this card.  At the transformer GAN's shapes (T = 36-37,
// D = 16-32, B*H = 512-2048) a pass does a few hundred MFLOP and moves a
// few MB: about 1-3 us either way at 67 TFLOP/s float32 and 3.35 TB/s.
// Launch latency and the serial key loop bound it, not either rate.
//
// What this design does about it.  It is the simple version: float32 FMA,
// no tensor cores.  A block of 128 threads owns one (b, h) and a tile of
// rows (query rows forward and for dQ, key rows for dK/dV, so no two blocks
// write the same row and no atomics are needed: the TPU design's
// determinism).  A row is split over tpr = next power of two >= D / 8
// threads that hold 8 of its D columns each in registers (D <= 256, a
// multiple of 8); a dot product is their partial sums combined with tpr-wide
// shuffles.  The other operand streams through shared memory in tiles of
// 4096 floats (16 KB), read as broadcasts.  The forward keeps the running
// max, normaliser and accumulator per row and rescales once per 4 keys.
// When causal, the forward and dQ stop at the tile's last row and dK/dV
// start at the tile's first key row.  wgmma (TF32 or bf16), TMA and larger
// tiles are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;             // threads per block
constexpr int DS = 8;               // columns of D per thread
constexpr int TILE = 4096;          // floats per shared-memory operand tile
constexpr int MAX_ROWS = TILE / DS; // rows of a tile at the smallest D
constexpr int KC = 4;               // keys (or queries) per batch of shuffles
constexpr float NEG = -1e30f;       // the TPU kernel's finite mask fill

__device__ __forceinline__ float group_sum(float x, int tpr) {
  for (int off = tpr >> 1; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// What every kernel derives from its block and thread index.
struct RowMap {
  int b, h, tpr, r, d0, row, len;
  bool own;  // the thread's 8 columns lie inside D
  size_t rs; // floats between two time rows of one (b, h)
  size_t head; // offset of (b, t = 0, h, d = 0)

  __device__ RowMap(const int* lengths, int T, int H, int D, int tpr_) {
    const int bh = blockIdx.x;
    b = bh / H;
    h = bh % H;
    tpr = tpr_;
    r = threadIdx.x / tpr;
    d0 = (threadIdx.x % tpr) * DS;
    own = d0 < D;
    row = blockIdx.y * (NT / tpr) + r;
    len = lengths != nullptr ? min(max(lengths[b], 0), T) : T;
    rs = (size_t)H * D;
    head = ((size_t)b * T * H + h) * D;
  }
  __device__ size_t vec(int t, int T, int H) const {  // lse / delta index
    return ((size_t)b * T + t) * H + h;
  }
};

__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         const RowMap& m, int t, int T,
                                         float (&dst)[DS]) {
#pragma unroll
  for (int i = 0; i < DS; ++i)
    dst[i] = (m.own && t < T) ? src[m.head + t * m.rs + m.d0 + i] : 0.f;
}

// Rows [t0, t0 + n) of one (b, h) of `src` into a [n, D] shared tile.
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          const RowMap& m, int t0, int n,
                                          int D, float* tile) {
  for (int e = threadIdx.x; e < n * D; e += NT) {
    const int j = e / D, d = e % D;
    tile[e] = src[m.head + (size_t)(t0 + j) * m.rs + d];
  }
}

__device__ __forceinline__ float dot_part(const float (&a)[DS],
                                          const float* b) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < DS; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ lengths,
    float* __restrict__ out, float* __restrict__ lse, int T, int H, int D,
    int tpr, int causal, float scale) {
  __shared__ __align__(16) float Ks[TILE];
  __shared__ __align__(16) float Vs[TILE];
  const RowMap m(lengths, T, H, D, tpr);
  const int q0 = blockIdx.y * (NT / tpr);
  float qr[DS], acc[DS];
  load_row(q, m, m.row, T, qr);
#pragma unroll
  for (int i = 0; i < DS; ++i) acc[i] = 0.f;
  float mx = NEG, l = 0.f;

  const int kv_end = causal ? min(m.len, q0 + NT / tpr) : m.len;
  const int bk = TILE / D;
  for (int k0 = 0; k0 < kv_end; k0 += bk) {
    const int nk = min(bk, kv_end - k0);
    __syncthreads();
    load_tile(k, m, k0, nk, D, Ks);
    load_tile(v, m, k0, nk, D, Vs);
    __syncthreads();
    for (int jj = 0; jj < nk; jj += KC) {
      float s[KC];
      float m_new = mx;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int j = k0 + jj + c;
        const bool in = jj + c < nk;
        const float part = (m.own && in) ? dot_part(qr, Ks + (jj + c) * D + m.d0)
                                         : 0.f;
        const float dot = group_sum(part, tpr);
        const bool valid = in && (!causal || j <= m.row);
        s[c] = valid ? dot * scale : NEG;
        m_new = fmaxf(m_new, s[c]);
      }
      const float corr = expf(mx - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < DS; ++i) acc[i] *= corr;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int j = k0 + jj + c;
        const bool valid = jj + c < nk && (!causal || j <= m.row);
        const float p = valid ? expf(s[c] - m_new) : 0.f;
        l += p;
        if (valid && m.own) {
          const float* vr = Vs + (jj + c) * D + m.d0;
#pragma unroll
          for (int i = 0; i < DS; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
        }
      }
      mx = m_new;
    }
  }
  if (m.row < T) {
    const float l_safe = fmaxf(l, 1e-30f);
    if (m.own) {
#pragma unroll
      for (int i = 0; i < DS; ++i)
        out[m.head + m.row * m.rs + m.d0 + i] = acc[i] / l_safe;
    }
    if (m.d0 == 0) lse[m.vec(m.row, T, H)] = mx + logf(l_safe);
  }
}

__global__ void __launch_bounds__(NT) flash_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ lengths, float* __restrict__ dq, int T, int H,
    int D, int tpr, int causal, float scale) {
  __shared__ __align__(16) float Ks[TILE];
  __shared__ __align__(16) float Vs[TILE];
  const RowMap m(lengths, T, H, D, tpr);
  const int q0 = blockIdx.y * (NT / tpr);
  float qr[DS], dor[DS], acc[DS];
  load_row(q, m, m.row, T, qr);
  load_row(dout, m, m.row, T, dor);
#pragma unroll
  for (int i = 0; i < DS; ++i) acc[i] = 0.f;
  const float lse_r = m.row < T ? lse[m.vec(m.row, T, H)] : 0.f;
  const float dl_r = m.row < T ? delta[m.vec(m.row, T, H)] : 0.f;

  const int kv_end = causal ? min(m.len, q0 + NT / tpr) : m.len;
  const int bk = TILE / D;
  for (int k0 = 0; k0 < kv_end; k0 += bk) {
    const int nk = min(bk, kv_end - k0);
    __syncthreads();
    load_tile(k, m, k0, nk, D, Ks);
    load_tile(v, m, k0, nk, D, Vs);
    __syncthreads();
    for (int jj = 0; jj < nk; jj += KC) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int j = k0 + jj + c;
        const bool in = jj + c < nk;
        const bool use = m.own && in;
        const float* kr = Ks + (jj + c) * D + m.d0;
        const float s = group_sum(use ? dot_part(qr, kr) : 0.f, tpr);
        const float dp = group_sum(
            use ? dot_part(dor, Vs + (jj + c) * D + m.d0) : 0.f, tpr);
        const bool valid = in && (!causal || j <= m.row);
        const float p = valid ? expf(s * scale - lse_r) : 0.f;
        const float ds = p * (dp - dl_r);
        if (valid && m.own) {
#pragma unroll
          for (int i = 0; i < DS; ++i) acc[i] = fmaf(ds, kr[i], acc[i]);
        }
      }
    }
  }
  if (m.row < T && m.own) {
#pragma unroll
    for (int i = 0; i < DS; ++i)
      dq[m.head + m.row * m.rs + m.d0 + i] = acc[i] * scale;
  }
}

__global__ void __launch_bounds__(NT) flash_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ lengths, float* __restrict__ dk,
    float* __restrict__ dv, int T, int H, int D, int tpr, int causal,
    float scale) {
  __shared__ __align__(16) float Qs[TILE];
  __shared__ __align__(16) float Os[TILE];  // dO rows
  __shared__ float Ls[MAX_ROWS];
  __shared__ float Dl[MAX_ROWS];
  const RowMap m(lengths, T, H, D, tpr);  // m.row is this thread's key row
  const int j0 = blockIdx.y * (NT / tpr);
  const int col = m.row;
  float kr[DS], vr[DS], dka[DS], dva[DS];
  load_row(k, m, col, T, kr);
  load_row(v, m, col, T, vr);
#pragma unroll
  for (int i = 0; i < DS; ++i) dka[i] = dva[i] = 0.f;
  const bool col_ok = col < m.len;

  const int bq = TILE / D;
  for (int i0 = causal ? j0 : 0; i0 < T; i0 += bq) {
    const int nq = min(bq, T - i0);
    __syncthreads();
    load_tile(q, m, i0, nq, D, Qs);
    load_tile(dout, m, i0, nq, D, Os);
    for (int e = threadIdx.x; e < nq; e += NT) {
      Ls[e] = lse[m.vec(i0 + e, T, H)];
      Dl[e] = delta[m.vec(i0 + e, T, H)];
    }
    __syncthreads();
    for (int ii = 0; ii < nq; ii += KC) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int i = i0 + ii + c;
        const bool in = ii + c < nq;
        const bool use = m.own && in;
        const float* qi = Qs + (ii + c) * D + m.d0;
        const float* oi = Os + (ii + c) * D + m.d0;
        const float s = group_sum(use ? dot_part(kr, qi) : 0.f, tpr);
        const float dp = group_sum(use ? dot_part(vr, oi) : 0.f, tpr);
        const bool valid = in && col_ok && (!causal || col <= i);
        const float p = valid ? expf(s * scale - Ls[ii + c]) : 0.f;
        const float ds = valid ? p * (dp - Dl[ii + c]) : 0.f;
        if (valid && m.own) {
#pragma unroll
          for (int d = 0; d < DS; ++d) {
            dva[d] = fmaf(p, oi[d], dva[d]);
            dka[d] = fmaf(ds, qi[d], dka[d]);
          }
        }
      }
    }
  }
  if (col < T && m.own) {
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      dk[m.head + col * m.rs + m.d0 + i] = dka[i] * scale;
      dv[m.head + col * m.rs + m.d0 + i] = dva[i];
    }
  }
}

int threads_per_row(int D) {
  int t = 1;
  while (t * DS < D) t <<= 1;
  return t;
}

bool bad_shape(int B, int T, int H, int D) {
  return B < 1 || T < 1 || H < 1 || D < DS || D % DS != 0 || D > 256;
}

dim3 grid_of(int B, int T, int H, int D) {
  const int rows = NT / threads_per_row(D);
  return dim3(B * H, (T + rows - 1) / rows);
}

}  // namespace

extern "C" {

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v [B, T, H, D] contiguous float32; lengths [B] int32 or null.
// Outputs out [B, T, H, D] and lse [B, T, H].  Each function returns 0 or
// the CUDA error code of its launch; nothing synchronises.
int gic_flash_fwd(const float* q, const float* k, const float* v,
                  const int* lengths, float* out, float* lse, int B, int T,
                  int H, int D, int causal, float scale, void* stream) {
  if (bad_shape(B, T, H, D)) return cudaErrorInvalidValue;
  flash_fwd_kernel<<<grid_of(B, T, H, D), NT, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      q, k, v, lengths, out, lse, T, H, D, threads_per_row(D), causal, scale);
  return cudaGetLastError();
}

// dout [B, T, H, D]; lse, delta [B, T, H] -> dq [B, T, H, D].
int gic_flash_dq(const float* q, const float* k, const float* v,
                 const float* dout, const float* lse, const float* delta,
                 const int* lengths, float* dq, int B, int T, int H, int D,
                 int causal, float scale, void* stream) {
  if (bad_shape(B, T, H, D)) return cudaErrorInvalidValue;
  flash_dq_kernel<<<grid_of(B, T, H, D), NT, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, delta, lengths, dq, T, H, D, threads_per_row(D),
      causal, scale);
  return cudaGetLastError();
}

// -> dk, dv [B, T, H, D].
int gic_flash_dkv(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  const int* lengths, float* dk, float* dv, int B, int T,
                  int H, int D, int causal, float scale, void* stream) {
  if (bad_shape(B, T, H, D)) return cudaErrorInvalidValue;
  flash_dkv_kernel<<<grid_of(B, T, H, D), NT, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, delta, lengths, dk, dv, T, H, D,
      threads_per_row(D), causal, scale);
  return cudaGetLastError();
}

}  // extern "C"
