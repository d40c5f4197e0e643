// Blocked (flash) self-attention for Hopper (sm_90a), float32 and
// bfloat16: the forward with its logsumexp, and the backward that
// recomputes the probabilities from it.
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
// with delta_i = dO_i . out_i (in the fused backward; the tiled route's
// wrapper takes it as one PyTorch reduction, as the JAX package leaves it
// to XLA).  lse and delta are [B, T, H] float32.  Rows i >= T are neither
// read nor written: the ragged edge is masked here, where the TPU wrapper
// pads T to a block multiple.
//
// What bounds it on this card.  At the transformer GAN's shapes (T = 36-37,
// D = 16-32, B*H = 512-2048) a forward moves 4.8-19 MB (q, k, v read once,
// out and lse written once: 1.4-5.7 us at 3.35 TB/s) and does 23-85 M FMAs
// (under half of that time at 67 TFLOP/s): it is bound by bytes, and at
// these sizes by how soon its blocks have their operands on chip.
//
// The forward (flash_fwd_fused_kernel, every call the system makes).  Every
// T the system runs is at most 37, so one head's whole q, k and v fit in
// shared memory and the softmax needs no running rescale.
//   * A block owns G heads of one batch row: the most (a power of two) that
//     keep it within 512 threads and 48 KB, 4 at T = 36 and D = 16, 2 at
//     T = 37 and D = 32.  Their rows of q, k and v are contiguous runs of
//     G*D floats in the bqhd layout; they arrive by 16-byte cp.async, all
//     in flight at once, into head-major tiles whose rows are padded by 4
//     floats, so that the lanes reading neighbouring keys hit distinct
//     banks.
//   * Two threads own one query row of one head, each every other key
//     (j = s, s + 2, ...): the q row and the thread's scores sit in
//     registers, every slot of the block holds a real (row, slice) (only
//     the last warp's tail idles), and a key costs D FMAs on float4
//     broadcasts from shared memory, with no shuffle.
//   * An exact two-pass softmax: the scores and their max (one shuffle
//     joins the two slices), then the exponentials (ex2 of one FMA), their
//     sum and P.V; one exchange of D/2 partial sums leaves each thread D/2
//     columns to write.  Fixed shuffle order, no atomics: two calls give
//     the same bits.
//   * Float32 FMAs, no tensor cores: TF32 would not hold the outputs to
//     2e-6 of the float32 reference, and the operations bound is under
//     half of the bytes bound here.
// What holds it back: in each block the copies, the two passes and the
// stores run one after another.  Timed with parts switched off at the
// rollouts' shape [256, 36, 8, 16] (ms, device_ms, H100 80GB HBM3 at 700
// W; on the two-group form below): a launch of an empty kernel 0.0018,
// the copies alone 0.0056, copies and stores 0.0096, passes and stores
// without the copies 0.0127, all 0.0159.  A thread's stores write 16
// bytes of each 32-byte sector.
// Variants tried, at the rollouts' / the discriminator's [64, 36, 8, 16] /
// the generator's causal [64, 37, 8, 32] shapes (ms, the same card; the
// kept design 0.0155 / 0.0064 / 0.0089):
//   * the keys of a row split over KS = 1, 2, 4 or 8 threads: 0.0197 /
//     0.0076 / 0.0120, 0.0156 / 0.0067 / 0.0091, 0.0188 / 0.0072 / 0.0111,
//     0.0248 / 0.0087 / 0.0143; KS picked for 2^17 threads a launch (2
//     at the rollouts, else 8): 0.0157 / 0.0088 / 0.0143.  More slices
//     cost a reduce-scatter and wider block ranges;
//   * fewer registers for the scores (T <= 40), or registers capped at
//     48 or 64 (spills): 0.0155 / 0.0066 / 0.0092, 0.0155 / 0.0074 /
//     0.0264, 0.0158 / 0.0068 / 0.0128;
//   * v in a second cp.async group, landing during the first pass, and
//     key rows padded past T in place of clamped reads: 0.0160 / 0.0065 /
//     0.0094;
//   * out and lse staged in shared memory and written in whole sectors:
//     0.0218 / 0.0068 / 0.0100 (100 registers, one more barrier);
//   * persistent blocks with the next group's rows double-buffered:
//     0.0168 / 0.0065 / 0.0096;
//   * 1 head a block: 0.0184 / 0.0067 / 0.0088; 2 heads on the two-group
//     form: 0.0152 / 0.0064 / 0.0094.
// A shape the fused kernel does not take (T > FT_TMAX or D > 32) runs the
// tiled forward (flash_fwd_kernel, the first port's design below); the
// choice is made from the shape alone, never after a failure.  The fused
// kernel's 16-byte copies need q, k, v and out 16-byte aligned: the
// wrapper refuses other pointers.
//
// The backward (flash_bwd_fused_kernel, every call the system makes: T <=
// FT_TMAX, D <= 32) replaces both `_dq_kernel` and `_dkv_kernel`, and the
// delta reduction, with one launch.  Its bound is bytes: q, k, v, dO and
// out read once, dq, dk and dv written once and lse read, 8 x 4*B*T*H*D
// bytes + 4*B*T*H, 9.5 MB at the discriminator's [64, 36, 8, 16] (2.84 us
// at 3.35 TB/s) and 19.5 MB at the generator's [64, 37, 8, 32] (5.81 us);
// its five products are 10*D flops a valid (query, key) pair, 106 M and
// 84-115 M, 1.6 us at 67 TFLOP/s.  The design:
//   * A block owns G heads of one batch row, planned from the shape alone
//     by the wrapper's flash_bwd_plan and recomputed here (bwd_geometry):
//     the most (a power of two) within FB_THREADS threads and FB_SMEM
//     bytes, 2 at config4's shapes.  Their rows of q, k, v and dO arrive
//     by 16-byte cp.async, all in flight at once, into head-major tiles
//     padded by 4 floats a row, as in the forward; out is read in place
//     (16-byte loads into registers while the copies land), since only
//     the thread of its row needs it.
//   * Phase 1, two threads a (head, query row), each every other key:
//     delta_i from dO_i and out_i, then per key s, p (masked before the
//     exponential: a row of no valid key has lse about -1e30), dp and ds,
//     with q_i and dO_i in registers and k and v rows as float4
//     broadcasts; p and ds go to shared [G, T, LD] tiles (LD % 4 == 2: a
//     warp's 16 rows and 2 slices write 32 distinct banks), dq_i sums in
//     registers, and one shuffle exchange joins the slices' halves.
//   * Phase 2, after one barrier, two threads a (head, key row), each
//     every other query: dv_j = sum_i p_ij dO_i and dk_j = sum_i ds_ij q_i
//     read P and dS down column j (lanes on neighbouring j, neighbouring
//     words) and dO_i and q_i as float4 broadcasts; a warp's loop spans
//     its rows' query ranges and masks the rest.
//   * Five products where the tiled pair runs seven, each input read from
//     memory once, each output written once by float4.  Float32 FMAs, no
//     tensor cores (TF32 would not hold the gradients to 1e-5 of their
//     largest, and the operations bound is under the bytes bound); fixed
//     sum orders, no atomics, no sum across blocks: two calls give the
//     same bits.
// Timed (ms, device_ms, H100 80GB HBM3 at 700 W; builds of this file
// with other values of the FB_ constants, in one call) at the
// discriminator's [64, 36, 8, 16] / the generator's causal [64, 37, 8, 32]
// / with lengths / the rollouts' [256, 36, 8, 16] shapes: the kept design 0.0101 / 0.0186 /
// 0.0177-0.0178 / 0.0314-0.0320 (the tiled route, delta, dQ and dK/dV,
// 0.0503 / 0.0766 / 0.0654 / 0.1429 by chip_smoke.py's tf_kernels);
// variants, each bit-equal to it but those of other threads a row:
//   * 1 head a block: 0.0103 / 0.0184 / 0.0173 / 0.0368; 4 heads (512
//     threads, so at most 128 registers, and spills): 0.0105 / 0.0207 /
//     0.0193 / 0.0387;
//   * one thread a row, all its keys (2 or 4 heads): 0.0139 / 0.0220 /
//     0.0204 / 0.0389; and 1 head: 0.0150 / 0.0228 / 0.0194 / 0.0443;
//   * four threads a row (1 head): 0.0139 / 0.0231 / 0.0206 / 0.0416;
//     and 2 heads (512 threads, spills): 0.0127 / 0.0232 / 0.0217 /
//     0.0502;
//   * out staged in shared memory beside q, k, v and dO: 0.0105 / 0.0186
//     / 0.0175 / 0.0323;
//   * the slices' join written as a loop over runtime widths: the rows
//     went to local memory (a 256-byte stack frame) and the kept design
//     took 0.0138 / 0.0252 / 0.0238 / 0.0456.
// What holds it back: the copies and the stores alone (both phases'
// loops skipped) take 0.0055 /
// 0.0088 / 0.0088 / 0.0149, about half of the whole, and a block copies,
// computes (two phases, a barrier between) and stores in turn; at B = 64
// the grid is 256 blocks, two a SM, too few to hide one block's copies
// behind another's arithmetic, and a launch alone is 0.0018.  172
// registers a thread at D = 32, 122 at D = 16.
//
// The tiled kernels (the tiled forward, dQ and dK/dV, for T > FT_TMAX or D
// > 32; the backward's delta then is one PyTorch reduction): float32 FMA, no
// tensor cores.  A block of 128 threads owns one (b, h) and a tile of
// rows (query rows forward and for dQ, key rows for dK/dV, so no two blocks
// write the same row and no atomics are needed: the TPU design's
// determinism).  A row is split over tpr = next power of two >= D / 8
// threads that hold 8 of its D columns each in registers (D <= 256, a
// multiple of 8); a dot product is their partial sums combined with tpr-wide
// shuffles.  The other operand streams through shared memory in tiles of
// 4096 floats (16 KB), read as broadcasts.  The tiled forward keeps the
// running max, normaliser and accumulator per row and rescales once per 4
// keys.  When causal, the forward and dQ stop at the tile's last row and
// dK/dV start at the tile's first key row.  What holds them back (measured
// on the forward, which they lose to the fused kernel): at D = 16 a block
// has 64 row slots for 36 rows, K and V arrive by 4-byte loads, and each
// row walks its keys one dependent step (FMAs, shuffles, an exp, a
// rescale) at a time.
//
// bfloat16 (--dtype bfloat16: the JAX kernels on bfloat16 inputs).  Every
// kernel is a template of its element type W, float or __nv_bfloat16
// (csrc/bf16.cuh): q, k, v, out and dO are W, lse and delta float32.  A
// bfloat16 row is widened exactly as it is staged, by 8-byte loads into
// the same float32 shared tiles the float32 kernels fill by cp.async, so
// the launch plans and the shared memory are float32's.  Every score, P,
// product and sum stays float32 and P is not rounded before P.V, as the
// JAX kernels' dot_generals take preferred_element_type=float32; out, dq,
// dk and dv are rounded once (dq and dk after the scale); delta reads the
// stored, rounded out.  No bfloat16 mma: it would round P.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

using gic::bf16;
using gic::ld4w;
using gic::st4w;
using gic::store_as;
using gic::to_f;

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

template <class W>
__device__ __forceinline__ void load_row(const W* __restrict__ src,
                                         const RowMap& m, int t, int T,
                                         float (&dst)[DS]) {
#pragma unroll
  for (int i = 0; i < DS; ++i)
    dst[i] = (m.own && t < T) ? to_f(src[m.head + t * m.rs + m.d0 + i])
                              : 0.f;
}

// Rows [t0, t0 + n) of one (b, h) of `src` into a [n, D] float32 shared
// tile.
template <class W>
__device__ __forceinline__ void load_tile(const W* __restrict__ src,
                                          const RowMap& m, int t0, int n,
                                          int D, float* tile) {
  for (int e = threadIdx.x; e < n * D; e += NT) {
    const int j = e / D, d = e % D;
    tile[e] = to_f(src[m.head + (size_t)(t0 + j) * m.rs + d]);
  }
}

__device__ __forceinline__ float dot_part(const float (&a)[DS],
                                          const float* b) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < DS; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

template <class W>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const W* __restrict__ q, const W* __restrict__ k,
    const W* __restrict__ v, const int* __restrict__ lengths,
    W* __restrict__ out, float* __restrict__ lse, int T, int H, int D,
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
        store_as(out, m.head + m.row * m.rs + m.d0 + i, acc[i] / l_safe);
    }
    if (m.d0 == 0) lse[m.vec(m.row, T, H)] = mx + logf(l_safe);
  }
}

template <class W>
__global__ void __launch_bounds__(NT) flash_dq_kernel(
    const W* __restrict__ q, const W* __restrict__ k,
    const W* __restrict__ v, const W* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ lengths, W* __restrict__ dq, int T, int H,
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
      store_as(dq, m.head + m.row * m.rs + m.d0 + i, acc[i] * scale);
  }
}

template <class W>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(
    const W* __restrict__ q, const W* __restrict__ k,
    const W* __restrict__ v, const W* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ lengths, W* __restrict__ dk,
    W* __restrict__ dv, int T, int H, int D, int tpr, int causal,
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
      store_as(dk, m.head + col * m.rs + m.d0 + i, dka[i] * scale);
      store_as(dv, m.head + col * m.rs + m.d0 + i, dva[i]);
    }
  }
}

// ---- the fused forward: a head's whole q, k and v on chip (T <= FT_TMAX)

constexpr int FT_TMAX = 64;           // time rows the fused forward takes
constexpr int FT_DMAX = 32;           // head dim it takes
constexpr int FT_KS = 2;              // threads a query row (key slices)
constexpr int FT_KPS = FT_TMAX / FT_KS;  // keys a thread scores, at most
constexpr int FT_PAD = 4;             // floats after each staged row
constexpr int FT_THREADS = 512;       // most threads a block
constexpr int FT_SMEM = 48 * 1024;    // most shared-memory bytes a block
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, 2 ulp
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four neighbouring elements of a global row into a float32 shared slot
// (16-byte aligned): float32 by a 16-byte cp.async, bfloat16 by an 8-byte
// load, widened.
__device__ __forceinline__ void stage4(float* dst, const float* src) {
  cp_async16(dst, src);
}
__device__ __forceinline__ void stage4(float* dst, const bf16* src) {
  *reinterpret_cast<float4*>(dst) = gic::ld4_bf16(src);
}

// q . k over DP columns (columns D..DP of both are zero), in two chains.
template <int DP>
__device__ __forceinline__ float dot_row(const float (&qr)[DP],
                                         const float* kr) {
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int c = 0; c < DP; c += 8) {
    const float4 x = ld4(kr + c), y = ld4(kr + c + 4);
    a0 = fmaf(qr[c], x.x, a0);
    a1 = fmaf(qr[c + 4], y.x, a1);
    a0 = fmaf(qr[c + 1], x.y, a0);
    a1 = fmaf(qr[c + 5], y.y, a1);
    a0 = fmaf(qr[c + 2], x.z, a0);
    a1 = fmaf(qr[c + 6], y.z, a1);
    a0 = fmaf(qr[c + 3], x.w, a0);
    a1 = fmaf(qr[c + 7], y.w, a1);
  }
  return a0 + a1;
}

// Grid: B * ceil(H / G) blocks (batch row, group of G heads); block:
// 2*G*T threads rounded up to a warp.  Dynamic shared memory: q, k and v
// tiles of G heads, each T rows of DP + FT_PAD floats.
template <int DP, class W>
__global__ void __launch_bounds__(FT_THREADS) flash_fwd_fused_kernel(
    const W* __restrict__ q, const W* __restrict__ k,
    const W* __restrict__ v, const int* __restrict__ lengths,
    W* __restrict__ out, float* __restrict__ lse, int T, int H, int D,
    int G, int causal, float scale) {
  constexpr int RS = DP + FT_PAD;  // staged row stride
  constexpr int DO = DP / FT_KS;   // columns a thread writes
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) float ft_smem[];
  const int groups = (H + G - 1) / G;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * G;
  const int gh = min(G, H - h0);  // heads of this block
  const int plane = G * T * RS;
  float* const qs = ft_smem;
  float* const ks = qs + plane;
  float* const vs = ks + plane;

  // rows t < T of heads h0 .. h0 + gh - 1, one run of gh*D floats a row
  // (chunk e of the block's rows: time row e / cpr, 16 bytes e % cpr)
  const int cpd = D / 4, cpr = gh * cpd;
  for (int e = threadIdx.x; e < T * cpr; e += blockDim.x) {
    const int t = e / cpr, c = e - t * cpr, g = c / cpd;
    const size_t src = ((size_t)(b * T + t) * H + h0) * D + 4 * c;
    const int dst = (g * T + t) * RS + 4 * (c - g * cpd);
    stage4(qs + dst, q + src);
    stage4(ks + dst, k + src);
    stage4(vs + dst, v + src);
  }
  if (D < DP) {  // pad columns enter every dot product: zero them
    const int ppr = (DP - D) / 4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = threadIdx.x; e < gh * T * ppr; e += blockDim.x) {
      const int row = e / ppr, dst = row * RS + D + 4 * (e - row * ppr);
      *reinterpret_cast<float4*>(qs + dst) = z;
      *reinterpret_cast<float4*>(ks + dst) = z;
      *reinterpret_cast<float4*>(vs + dst) = z;
    }
  }

  // thread -> (row slot r = (head g, query row i), key slice s): keys
  // j = s, s + 2, ...; the two lanes of a row are neighbours.  A dead slot
  // (past gh*T) has no keys but takes part in the shuffles.
  const int s = threadIdx.x % FT_KS, r = threadIdx.x / FT_KS;
  const bool live = r < gh * T;
  const int g = live ? r / T : 0, i = live ? r - g * T : 0;
  const int len = lengths != nullptr ? min(max(lengths[b], 0), T) : T;
  const int nk = !live ? 0 : causal ? min(len, i + 1) : len;  // j < nk
  const int mine = nk > s ? (nk - s + FT_KS - 1) / FT_KS : 0;
  const int nwarp = static_cast<int>(__reduce_max_sync(FULL, mine));
  const float* kh = ks + g * T * RS;
  const float* vh = vs + g * T * RS;

  cp_async_wait_all();
  __syncthreads();
  float sc[FT_KPS];
  float mx = NEG;
  {
    float qr[DP];
    const float* qrow = qs + (g * T + i) * RS;
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      const float4 x = ld4(qrow + c);
      qr[c] = x.x;
      qr[c + 1] = x.y;
      qr[c + 2] = x.z;
      qr[c + 3] = x.w;
    }
#pragma unroll
    for (int n0 = 0; n0 < FT_KPS; n0 += 2) {
      if (n0 >= nwarp) break;
#pragma unroll
      for (int n = n0; n < n0 + 2; ++n) {
        const int j = s + FT_KS * n;  // past T: read row T - 1, masked
        const float d = dot_row<DP>(qr, kh + min(j, T - 1) * RS);
        sc[n] = j < nk ? d * scale : -INFINITY;
        mx = fmaxf(mx, sc[n]);
      }
    }
  }
  mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));

  // exp(s - mx) = 2^(s*log2e - mx*log2e); a masked key (-inf) gives 0
  const float nm = -mx * LOG2E;
  float acc[DP], l = 0.f;
#pragma unroll
  for (int c = 0; c < DP; ++c) acc[c] = 0.f;
#pragma unroll
  for (int n0 = 0; n0 < FT_KPS; n0 += 2) {
    if (n0 >= nwarp) break;
#pragma unroll
    for (int n = n0; n < n0 + 2; ++n) {
      const float p = ex2(fmaf(sc[n], LOG2E, nm));
      const float* vr = vh + min(s + FT_KS * n, T - 1) * RS;
      l += p;
#pragma unroll
      for (int c = 0; c < DP; c += 4) {
        const float4 x = ld4(vr + c);
        acc[c] = fmaf(p, x.x, acc[c]);
        acc[c + 1] = fmaf(p, x.y, acc[c + 1]);
        acc[c + 2] = fmaf(p, x.z, acc[c + 2]);
        acc[c + 3] = fmaf(p, x.w, acc[c + 3]);
      }
    }
  }
  l += __shfl_xor_sync(FULL, l, 1);
  // reduce-scatter of the two partial rows of P.V: slice 0 keeps columns
  // 0 .. DO, slice 1 columns DO .. DP
#pragma unroll
  for (int c = 0; c < DO; ++c) {
    const float give = s ? acc[c] : acc[c + DO];
    const float keep = s ? acc[c + DO] : acc[c];
    acc[c] = keep + __shfl_xor_sync(FULL, give, 1);
  }
  if (!live) return;
  const float l_safe = fmaxf(l, 1e-30f);
  const size_t row = (size_t)(b * T + i) * H + h0 + g;
  W* orow = out + row * D + s * DO;
#pragma unroll
  for (int c = 0; c < DO; c += 4) {  // D is a multiple of 8: whole float4s
    if (s * DO + c < D)
      st4w(orow + c, make_float4(acc[c] / l_safe, acc[c + 1] / l_safe,
                                 acc[c + 2] / l_safe, acc[c + 3] / l_safe));
  }
  if (s == 0) lse[row] = mx + logf(l_safe);
}

// ---- the fused backward: delta, dQ, dK and dV of G heads in one block

// Its geometry (kernels/flash_attention.py:flash_bwd_plan mirrors these):
constexpr int FB_THREADS = 256;       // most threads a block
constexpr int FB_SMEM = 96 * 1024;    // most shared-memory bytes a block
constexpr int FB_KS = 2;              // threads a row (key or query slices)
constexpr int FB_PLANES = 4;          // staged tiles: q, k, v, dO

// The P and dS tiles' row stride: the least LD >= T with LD % 4 == 2, so
// that the 16 rows and 2 key slices of a warp's phase-1 writes fall in 32
// distinct banks.
__host__ __device__ inline int bwd_ld(int T) {
  return T + ((2 - T) % 4 + 4) % 4;
}

// The two slices' partial rows joined by one shuffle exchange: slice s
// keeps its half of the columns, s*DP/2 .., adds its partner's (lane ^ 1)
// and ends with their sum in acc[0 .. DP/2).
template <int DP>
__device__ __forceinline__ void join_slices(float (&acc)[DP], int s) {
  static_assert(FB_KS == 2, "two slices a row");
  constexpr int W = DP / 2;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const float give = s ? acc[c] : acc[c + W];
    const float keep = s ? acc[c + W] : acc[c];
    acc[c] = keep + __shfl_xor_sync(0xffffffffu, give, 1);
  }
}

// A thread's DP / FB_KS columns of one output row, times `mul`, by float4
// (D is a multiple of 8, so a float4 lies wholly inside or past D).
template <int DP, class W>
__device__ __forceinline__ void store_cols(W* dst, const float (&acc)[DP],
                                           int s, int D, float mul) {
  constexpr int DO = DP / FB_KS;
#pragma unroll
  for (int c = 0; c < DO; c += 4) {
    if (s * DO + c < D)
      st4w(dst + s * DO + c, make_float4(acc[c] * mul, acc[c + 1] * mul,
                                         acc[c + 2] * mul, acc[c + 3] * mul));
  }
}

template <int DP>
__device__ __forceinline__ void load_row_smem(float (&r)[DP], const float* p) {
#pragma unroll
  for (int c = 0; c < DP; c += 4) {
    const float4 x = ld4(p + c);
    r[c] = x.x;
    r[c + 1] = x.y;
    r[c + 2] = x.z;
    r[c + 3] = x.w;
  }
}

// acc += a * row, DP columns of a staged row by float4 broadcasts.
template <int DP>
__device__ __forceinline__ void axpy_row(float (&acc)[DP], float a,
                                         const float* row) {
#pragma unroll
  for (int c = 0; c < DP; c += 4) {
    const float4 x = ld4(row + c);
    acc[c] = fmaf(a, x.x, acc[c]);
    acc[c + 1] = fmaf(a, x.y, acc[c + 1]);
    acc[c + 2] = fmaf(a, x.z, acc[c + 2]);
    acc[c + 3] = fmaf(a, x.w, acc[c + 3]);
  }
}

// Grid: B * ceil(H / G) blocks (batch row, group of G heads); block:
// FB_KS*G*T threads rounded up to a warp.  Dynamic shared memory: the q,
// k, v and dO tiles of G heads, T rows of DP + FT_PAD floats each, then
// the P and dS tiles, [G, T, LD].
template <int DP, class W>
__global__ void __launch_bounds__(FB_THREADS) flash_bwd_fused_kernel(
    const W* __restrict__ q, const W* __restrict__ k,
    const W* __restrict__ v, const W* __restrict__ out,
    const W* __restrict__ dout, const float* __restrict__ lse,
    const int* __restrict__ lengths, W* __restrict__ dq,
    W* __restrict__ dk, W* __restrict__ dv, int T, int H, int D,
    int G, int causal, float scale) {
  constexpr int RS = DP + FT_PAD;
  constexpr int KS = FB_KS;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) float fb_smem[];
  const int groups = (H + G - 1) / G;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * G;
  const int gh = min(G, H - h0);  // heads of this block
  const int LD = bwd_ld(T);
  const int plane = G * T * RS;
  float* const qs = fb_smem;
  float* const ks = qs + plane;
  float* const vs = ks + plane;
  float* const os = vs + plane;  // dO
  float* const ps = os + plane;
  float* const dss = ps + G * T * LD;

  // rows t < T of heads h0 .. h0 + gh - 1, one run of gh*D floats a row
  // of each tensor, all in flight at once
  const int cpd = D / 4, cpr = gh * cpd;
  for (int e = threadIdx.x; e < T * cpr; e += blockDim.x) {
    const int t = e / cpr, c = e - t * cpr, g = c / cpd;
    const size_t src = ((size_t)(b * T + t) * H + h0) * D + 4 * c;
    const int dst = (g * T + t) * RS + 4 * (c - g * cpd);
    stage4(qs + dst, q + src);
    stage4(ks + dst, k + src);
    stage4(vs + dst, v + src);
    stage4(os + dst, dout + src);
  }
  if (D < DP) {  // pad columns enter every dot product: zero them
    const int ppr = (DP - D) / 4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = threadIdx.x; e < gh * T * ppr; e += blockDim.x) {
      const int row = e / ppr, dst = row * RS + D + 4 * (e - row * ppr);
      *reinterpret_cast<float4*>(qs + dst) = z;
      *reinterpret_cast<float4*>(ks + dst) = z;
      *reinterpret_cast<float4*>(vs + dst) = z;
      *reinterpret_cast<float4*>(os + dst) = z;
    }
  }

  // thread -> (row slot r = (head g, row i), slice s); phase 1 reads i as
  // a query row and takes keys j = s, s + KS, ...; phase 2 reads it as a
  // key row and takes queries s, s + KS, ...  A dead slot (past gh*T) has
  // no work but takes part in the shuffles.
  const int s = threadIdx.x % KS, r = threadIdx.x / KS;
  const bool live = r < gh * T;
  const int g = live ? r / T : 0, i = live ? r - g * T : 0;
  const int len = lengths != nullptr ? min(max(lengths[b], 0), T) : T;
  const size_t row = (size_t)(b * T + i) * H + h0 + g;
  const float* const kh = ks + g * T * RS;
  const float* const vh = vs + g * T * RS;
  const float* const qh = qs + g * T * RS;
  const float* const oh = os + g * T * RS;
  float* const ph = ps + g * T * LD;
  float* const dsh = dss + g * T * LD;
  const float lse_i = live ? lse[row] : 0.f;

  // phase 1, query row i: delta_i, then for each of its keys s_ij, p_ij
  // (masked before the exponential: a row of no valid key has lse about
  // -1e30), dp_ij and ds_ij, written to P and dS; dq_i accumulated
  {
    float qr[DP], dor[DP], acc[DP];
    float yr[DP];  // out_i, read in place while the copies land
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      const float4 x = live && c < D ? ld4w(out + row * D + c)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
      yr[c] = x.x;
      yr[c + 1] = x.y;
      yr[c + 2] = x.z;
      yr[c + 3] = x.w;
    }
    const int nk = !live ? 0 : causal ? min(len, i + 1) : len;  // j < nk
    const int mine = nk > s ? (nk - s + KS - 1) / KS : 0;
    const int nwarp = static_cast<int>(__reduce_max_sync(FULL, mine));
    cp_async_wait_all();
    __syncthreads();
    load_row_smem<DP>(qr, qh + i * RS);
    load_row_smem<DP>(dor, oh + i * RS);
    float delta = 0.f;
    {
      float a0 = 0.f, a1 = 0.f;  // dot_row's two chains
#pragma unroll
      for (int c = 0; c < DP; c += 8) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a0 = fmaf(dor[c + e], yr[c + e], a0);
          a1 = fmaf(dor[c + 4 + e], yr[c + 4 + e], a1);
        }
      }
      delta = a0 + a1;
    }
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] = 0.f;
#pragma unroll 2
    for (int n = 0; n < nwarp; ++n) {
      const int j = s + KS * n;
      const float* kr = kh + min(j, T - 1) * RS;  // past T: masked
      const float sc = dot_row<DP>(qr, kr) * scale;
      const float dp = dot_row<DP>(dor, vh + min(j, T - 1) * RS);
      const bool valid = j < nk;
      const float p = valid ? ex2((sc - lse_i) * LOG2E) : 0.f;
      const float ds = p * (dp - delta);
      axpy_row<DP>(acc, ds, kr);
      if (valid) {
        ph[i * LD + j] = p;
        dsh[i * LD + j] = ds;
      }
    }
    join_slices<DP>(acc, s);
    if (live) store_cols<DP, W>(dq + row * D, acc, s, D, scale);
  }
  __syncthreads();

  // phase 2, key row j = i: dv_j = sum_i p_ij dO_i and dk_j = sum_i ds_ij
  // q_i over the queries that phase 1 scored against it (the same mask),
  // P and dS read down column j
  {
    const int j = i;
    const int hi = T > s ? (T - s + KS - 1) / KS : 0;
    const int lo0 = causal && j > s ? (j - s + KS - 1) / KS : 0;
    const bool keys = live && j < len;
    const int lo = keys ? lo0 : hi;
    const int wlo = static_cast<int>(__reduce_min_sync(FULL, keys ? lo : 1 << 20));
    const int whi = static_cast<int>(__reduce_max_sync(FULL, keys ? hi : 0));
    float dka[DP], dva[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) dka[c] = dva[c] = 0.f;
#pragma unroll 2
    for (int n = wlo; n < whi; ++n) {
      const int qi = min(s + KS * n, T - 1);
      const bool valid = keys && n >= lo && n < hi;
      const float p = valid ? ph[qi * LD + j] : 0.f;
      const float ds = valid ? dsh[qi * LD + j] : 0.f;
      axpy_row<DP>(dva, p, oh + qi * RS);
      axpy_row<DP>(dka, ds, qh + qi * RS);
    }
    join_slices<DP>(dka, s);
    join_slices<DP>(dva, s);
    if (live) {
      store_cols<DP, W>(dk + row * D, dka, s, D, scale);
      store_cols<DP, W>(dv + row * D, dva, s, D, 1.f);
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

// The fused forward's geometry: G, the most heads (a power of two) that
// keep a block within FT_THREADS threads and FT_SMEM bytes.
struct FusedGeometry {
  int g, threads, smem;
};

bool fused_shape(int T, int D) { return T <= FT_TMAX && D <= FT_DMAX; }

FusedGeometry fused_geometry(int T, int H, int D) {
  const int head = 3 * 4 * T * ((D <= 16 ? 16 : 32) + FT_PAD);
  FusedGeometry f;
  f.g = 1;
  while (2 * f.g <= H && 2 * f.g * FT_KS * T <= FT_THREADS &&
         2 * f.g * head <= FT_SMEM)
    f.g *= 2;
  f.threads = (f.g * FT_KS * T + 31) / 32 * 32;
  f.smem = f.g * head;
  return f;
}

// The fused backward's geometry (flash_bwd_plan in the wrapper): G, the
// most heads (a power of two) that keep a block within FB_THREADS threads
// and FB_SMEM bytes; one head always fits (T <= 64, D <= 32: 78 KB).
FusedGeometry bwd_geometry(int T, int H, int D) {
  const int head =
      4 * (FB_PLANES * T * ((D <= 16 ? 16 : 32) + FT_PAD) + 2 * T * bwd_ld(T));
  FusedGeometry f;
  f.g = 1;
  while (2 * f.g <= H && 2 * f.g * FB_KS * T <= FB_THREADS &&
         2 * f.g * head <= FB_SMEM)
    f.g *= 2;
  f.threads = (f.g * FB_KS * T + 31) / 32 * 32;
  f.smem = f.g * head;
  return f;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Dynamic shared memory above 48 KB must be allowed per kernel.
template <int DP, class W>
cudaError_t launch_bwd(const FusedGeometry& f, int B, const void* q,
                       const void* k, const void* v, const void* out,
                       const void* dout, const float* lse,
                       const int* lengths, void* dq, void* dk, void* dv,
                       int T, int H, int D, int causal, float scale,
                       cudaStream_t st) {
  if (f.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_fused_kernel<DP, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, f.smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B * ((H + f.g - 1) / f.g));
  flash_bwd_fused_kernel<DP, W><<<grid, f.threads, f.smem, st>>>(
      static_cast<const W*>(q), static_cast<const W*>(k),
      static_cast<const W*>(v), static_cast<const W*>(out),
      static_cast<const W*>(dout), lse, lengths, static_cast<W*>(dq),
      static_cast<W*>(dk), static_cast<W*>(dv), T, H, D, f.g, causal, scale);
  return cudaGetLastError();
}

template <class W>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int* lengths, void* out, float* lse, int B,
                       int T, int H, int D, int causal, float scale,
                       cudaStream_t st, int fused) {
  const W* qw = static_cast<const W*>(q);
  const W* kw = static_cast<const W*>(k);
  const W* vw = static_cast<const W*>(v);
  W* ow = static_cast<W*>(out);
  if (fused) {
    const FusedGeometry f = fused_geometry(T, H, D);
    const dim3 grid(B * ((H + f.g - 1) / f.g));
    if (D <= 16)
      flash_fwd_fused_kernel<16, W><<<grid, f.threads, f.smem, st>>>(
          qw, kw, vw, lengths, ow, lse, T, H, D, f.g, causal, scale);
    else
      flash_fwd_fused_kernel<32, W><<<grid, f.threads, f.smem, st>>>(
          qw, kw, vw, lengths, ow, lse, T, H, D, f.g, causal, scale);
    return cudaGetLastError();
  }
  flash_fwd_kernel<W><<<grid_of(B, T, H, D), NT, 0, st>>>(
      qw, kw, vw, lengths, ow, lse, T, H, D, threads_per_row(D), causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v [B, T, H, D] contiguous, float32 or (bf16 = 1) bfloat16; lengths
// [B] int32 or null.  Outputs out [B, T, H, D] in the inputs' type and lse
// [B, T, H] float32.  Each function returns 0 or the CUDA error code of
// its launch; nothing synchronises.  The forward launches the fused kernel
// where T <= FT_TMAX and D <= 32 (q, k, v and out 16-byte aligned), else
// the tiled one, and writes which to *fused (1 or 0).
int gic_flash_fwd(const void* q, const void* k, const void* v,
                  const int* lengths, void* out, float* lse, int B, int T,
                  int H, int D, int causal, float scale, int bf16_,
                  void* stream, int* fused) {
  if (bad_shape(B, T, H, D)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  *fused = fused_shape(T, D);
  return bf16_ ? launch_fwd<bf16>(q, k, v, lengths, out, lse, B, T, H, D,
                                  causal, scale, st, *fused)
               : launch_fwd<float>(q, k, v, lengths, out, lse, B, T, H, D,
                                   causal, scale, st, *fused);
}

// dout [B, T, H, D] in the inputs' type; lse, delta [B, T, H] float32 ->
// dq [B, T, H, D] in the inputs' type.
int gic_flash_dq(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 const int* lengths, void* dq, int B, int T, int H, int D,
                 int causal, float scale, int bf16_, void* stream) {
  if (bad_shape(B, T, H, D)) return cudaErrorInvalidValue;
  const dim3 grid = grid_of(B, T, H, D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_)
    flash_dq_kernel<bf16><<<grid, NT, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, lengths, static_cast<bf16*>(dq), T, H, D, threads_per_row(D),
        causal, scale);
  else
    flash_dq_kernel<float><<<grid, NT, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, lengths, static_cast<float*>(dq), T, H, D, threads_per_row(D),
        causal, scale);
  return cudaGetLastError();
}

// -> dk, dv [B, T, H, D] in the inputs' type.
int gic_flash_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  const int* lengths, void* dk, void* dv, int B, int T,
                  int H, int D, int causal, float scale, int bf16_,
                  void* stream) {
  if (bad_shape(B, T, H, D)) return cudaErrorInvalidValue;
  const dim3 grid = grid_of(B, T, H, D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_)
    flash_dkv_kernel<bf16><<<grid, NT, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, lengths, static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H,
        D, threads_per_row(D), causal, scale);
  else
    flash_dkv_kernel<float><<<grid, NT, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, lengths, static_cast<float*>(dk), static_cast<float*>(dv), T,
        H, D, threads_per_row(D), causal, scale);
  return cudaGetLastError();
}

// The fused backward (T <= FT_TMAX, D <= 32): out, dout [B, T, H, D] and
// lse [B, T, H] as the forward wrote it -> dq, dk, dv [B, T, H, D], delta
// included, in one launch, in the inputs' type.  (G, threads, smem) is the
// caller's plan (flash_bwd_plan); one that differs from bwd_geometry,
// another shape, or a pointer of the eight tensors that is not 16-byte
// aligned gives cudaErrorInvalidValue and launches nothing.
int gic_flash_bwd(const void* q, const void* k, const void* v,
                  const void* out, const void* dout, const float* lse,
                  const int* lengths, void* dq, void* dk, void* dv, int B,
                  int T, int H, int D, int causal, float scale, int G,
                  int threads, int smem, int bf16_, void* stream) {
  if (bad_shape(B, T, H, D) || !fused_shape(T, D)) return cudaErrorInvalidValue;
  const FusedGeometry f = bwd_geometry(T, H, D);
  if (f.g != G || f.threads != threads || f.smem != smem)
    return cudaErrorInvalidValue;
  const void* const ptrs[] = {q, k, v, out, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (!aligned16(p)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_)
    return D <= 16
               ? launch_bwd<16, bf16>(f, B, q, k, v, out, dout, lse, lengths,
                                      dq, dk, dv, T, H, D, causal, scale, st)
               : launch_bwd<32, bf16>(f, B, q, k, v, out, dout, lse, lengths,
                                      dq, dk, dv, T, H, D, causal, scale, st);
  return D <= 16
             ? launch_bwd<16, float>(f, B, q, k, v, out, dout, lse, lengths,
                                     dq, dk, dv, T, H, D, causal, scale, st)
             : launch_bwd<32, float>(f, B, q, k, v, out, dout, lse, lengths,
                                     dq, dk, dv, T, H, D, causal, scale, st);
}

}  // extern "C"
