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
// with delta_i = dO_i . out_i, computed in the backward's launch from the
// stored out (the JAX package leaves it to XLA).  lse and delta are
// [B, T, H] float32.  Rows i >= T are neither
// read nor written: the ragged edge is masked here, where the TPU wrapper
// pads T to a block multiple.
//
// What bounds it on this card.  At the transformer GAN's shapes (T = 36-37,
// D = 16-32, B*H = 512-2048) a forward moves 4.8-19 MB (q, k, v read once,
// out and lse written once: 1.4-5.7 us at 3.35 TB/s) and does 23-85 M FMAs
// (under half of that time at 67 TFLOP/s): it is bound by bytes, and at
// these sizes by how soon its blocks have their operands on chip.
//
// The forward (flash_fwd_fused_kernel, T <= FT_TMAX and D <= 32; the
// column-half kernel below past D = 32).  Every T the system runs is at
// most 37, so one head's whole q, k and v fit in shared memory and the
// softmax needs no running rescale.
//   * A block owns G heads of one batch row, planned from the shape alone
//     by the wrapper (flash_fwd_plan): the most (a power of two) that keep
//     it within 512 threads and 48 KB, 4 at T = 36 and D = 16, 2 at T = 37
//     and D = 32.  Their rows of q, k and v are contiguous runs of
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
// A shape the fused kernels do not take (T > FT_TMAX or D > FC_DP) runs
// the tiled forward (flash_fwd_kernel, the first port's design below); the
// choice is made from the shape alone, never after a failure.  The fused
// kernels' 16-byte copies need q, k, v and out 16-byte aligned: the
// wrapper refuses other pointers.
//
// The plans.  Route, G, threads and bytes of every fused launch are the
// wrapper's (kernels/flash_attention.py: flash_fwd_plan, flash_bwd_plan,
// the only planner); this file chooses nothing: it launches the plan it is
// given once fused_plan_ok finds that its threads cover two a row within
// the kernel's launch bounds and its bytes cover the kernel's layout
// within the 227 KB a block may use, else it returns cudaErrorInvalidValue
// and launches nothing.
//
// The backward (flash_bwd_fused_kernel, T <= FT_TMAX and D <= 32; the
// column-half kernel below past D = 32) replaces both `_dq_kernel` and
// `_dkv_kernel`, and the delta reduction, with one launch.  Its bound is
// bytes: q, k, v, dO and out read once, dq, dk and dv written once and lse
// read, 8 x 4*B*T*H*D bytes + 4*B*T*H, 9.5 MB at the discriminator's [64,
// 36, 8, 16] (2.84 us at 3.35 TB/s) and 19.5 MB at the generator's [64, 37,
// 8, 32] (5.81 us); its five products are 10*D flops a valid (query, key)
// pair, 106 M and 84-115 M, 1.6 us at 67 TFLOP/s.  The design:
//   * A block owns G heads of one batch row, planned from the shape alone by
//     the wrapper's flash_bwd_plan: the most (a power of two) within
//     FB_THREADS threads and 96 KB, 2 at config4's shapes.  Their rows of q,
//     k, v and dO arrive by 16-byte cp.async, all in flight at once, into
//     head-major tiles padded by 4 floats a row, as in the forward; out is
//     read in place (16-byte loads into registers while the copies land),
//     since only the thread of its row needs it.
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
// The column-half kernels (flash_fwd_fused64_kernel and
// flash_bwd_fused64_kernel, 32 < D <= FC_DP = 64: config5's GPT-2-small
// attention, [64, 37, 12, 64]).  The key-slice kernels hold a whole row of
// q, dO and dq in each thread's registers, 3 * DP floats: 172 registers a
// thread at D = 32, past the 255 a thread may have at D = 64.  Here the
// two threads of a row share it by its columns, not its keys.  Same
// bound: bytes (8 x 2*B*T*H*D + 4*B*T*H, 29 MB, 8.7 us at 3.35 TB/s in
// bfloat16; the forward 4 x, 4.4 us), the backward's 10*D flops a valid
// pair 5.2 us at 67 TFLOP/s.
//   * Thread (row, c) holds the row's float4 chunks c, c + 2, ... (32
//     columns; the two lanes of a row load and store neighbouring 16
//     bytes) and takes every key (forward; backward phase 1) or every
//     query (phase 2) in order.  A dot product is its two half sums (two
//     FMA chains each) joined by one shuffle: both lanes hold the same
//     sum, since addition commutes.  Its columns of out, dq, dk and dv are
//     whole sums: no join.
//   * The forward's scores go to shared memory [G, T, T | 1] (lane 0 of a
//     row writes; both read back after __syncwarp), so a thread keeps 32
//     columns of q and of P.V: 71-75 registers.  The backward's (p, ds)
//     pairs go to [G, T, T | 1] float2s, p by lane 0 and ds by lane 1 (an
//     odd row stride: a warp's 16 rows and 2 lanes hit 32 banks), read in
//     phase 2 down column j as one broadcast float2: 168-169 registers,
//     no spills.
//   * Staging as the key-slice kernels stage (stage_heads: float32 tiles
//     of rows of 68 floats; out read in place).
// Copies against arithmetic: a block still copies, computes and stores in
// turn, and the overlap is between blocks.  One head a backward block (96
// threads, 51 KB) keeps 4 blocks on an SM and 768 in the grid at B = 64,
// so one block's copies land while the other three compute; two heads a
// block (160 threads, 102 KB: 2 an SM) was slower.  With so few threads
// for its bytes, the backward's bfloat16 staging keeps four rounds of
// loads in flight (FC_BWD_STAGE_U).  Timed (ms, device_ms, H100 80GB HBM3
// at 700 W, scripts/flash_fused64_variants.py, two runs in one call) at
// [64, 37, 12, 64], causal with lengths / causal alone, bfloat16 (float32):
//   * backward, 1 head a block 0.0389-0.0391 / 0.0451-0.0452 (0.0480-0.0481
//     / 0.0576-0.0577); 2 heads 0.0402-0.0406 / 0.0486-0.0489 (0.0501-0.0502
//     / 0.0610-0.0612); one staging round 0.0495-0.0497 / 0.0589-0.0590;
//     the tiled route (delta, dQ, dK/dV) 0.1677-0.1685 / 0.1867-0.1872
//     (0.1575-0.1577 / 0.1777-0.1781); SDPA's backward alone 0.0466-0.0470
//     / 0.0467-0.0468 (0.1024-0.1027 / 0.1026-0.1027);
//   * forward, 2 heads a block 0.0172-0.0176 / 0.0185 (0.0193-0.0194 /
//     0.0203); 1 head 0.0176-0.0177 / 0.0191-0.0192 (0.0187-0.0195 /
//     0.0204-0.0205); the tiled forward 0.0460-0.0465 / 0.0567-0.0569
//     (0.0480-0.0482 / 0.0601-0.0605); SDPA 0.0515-0.0519 / 0.0508-0.0511
//     (0.0543-0.0546 / 0.0533-0.0536).
// What holds them back: the backward is 4.5x its bound.  A causal warp
// runs as long as its longest row (every lane of a warp loops to the
// warp's last key or first query), and every row reads a key's k and v
// chunks from shared memory again: 16 bytes for 4 FMAs.
//
// The tiled forward (flash_fwd_kernel, for T > FT_TMAX or D > FC_DP: the
// long captions of --max-seq-len 62 and up, whose generator attends over
// max_seq_len + 3 positions): float32 FMA, no tensor cores.  A block of 128
// threads owns one (b, h) and a tile of query rows.  A row is split over
// tpr = next power of two >= D / 8 threads that hold 8 of its D columns
// each in registers (D <= 256, a multiple of 8); a dot product is their
// partial sums combined with tpr-wide shuffles.  K and V stream through
// shared memory in tiles of 4096 floats (16 KB), read as broadcasts.  It
// keeps the running max, normaliser and accumulator per row and rescales
// once per 4 keys; when causal it stops at the tile's last row.  What
// holds it back: at D = 16 a block has 64 row slots for 36 rows, K and V
// arrive by 4-byte loads, and each row walks its keys one dependent step
// (FMAs, shuffles, an exp, a rescale) at a time (ROADMAP queue 2, the next
// kernel item).  The tiled backward (flash_bwd_tiled_kernel, below the
// fused kernels) is one launch of its own design.
//
// bfloat16 (--dtype bfloat16: the JAX kernels on bfloat16 inputs).  Every
// kernel is a template of its element type W, float or __nv_bfloat16
// (csrc/bf16.cuh): q, k, v, out and dO are W, lse and delta float32.  A
// bfloat16 row is widened exactly as it is staged, by 8-byte loads into
// the same float32 shared tiles the float32 kernels fill by cp.async, so
// the launch plans and the shared memory are float32's; in the fused
// kernels (stage_heads) a thread issues four rounds of those loads before
// their widened stores.  Every score, P,
// product and sum stays float32 and P is not rounded before P.V, as the
// JAX kernels' dot_generals take preferred_element_type=float32; out, dq,
// dk and dv are rounded once (dq and dk after the scale); delta reads the
// stored, rounded out.  No bfloat16 mma: it would round P.  The tiled
// backward stages bfloat16 rows as they are (cp.async) and multiplies on
// TF32 tensor cores, where a widened bfloat16 is exact: its float32
// instantiation runs the same terms and exact zeros, so the two agree
// bit for bit once rounded, as the other kernels do.

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

// ---- the fused forward: a head's whole q, k and v on chip (T <= FT_TMAX)

constexpr int FT_TMAX = 64;           // time rows the fused kernels take
constexpr int FT_DMAX = 32;           // head dim of the key-slice kernels
constexpr int FT_KS = 2;              // threads a query row (key slices)
constexpr int FT_KPS = FT_TMAX / FT_KS;  // keys a thread scores, at most
constexpr int FT_PAD = 4;             // floats after each staged row
constexpr int FT_THREADS = 512;       // most threads a block
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

// bfloat16 staging: rounds of 8-byte loads a thread issues before their
// stores.  One where a block has threads enough for its bytes; four for
// the column-half backward (one head, 96 threads, four planes of 64
// columns): 0.0389-0.0391 against 0.0495-0.0497 ms with one at config5's
// [64, 37, 12, 64], where four rounds cost the other fused kernels up to
// 4 % (the rollouts' [256, 36, 8, 16] backward 0.0230-0.0232 against
// 0.0222-0.0223; scripts/flash_fused64_variants.py --set, H100 at 700 W).
constexpr int STAGE_U = 1;
constexpr int FC_BWD_STAGE_U = 4;

// Rows t < T of heads h0 .. h0 + gh - 1 of NP tensors into their float32
// tiles (head-major, rows of DP + FT_PAD floats), columns D .. DP zeroed.
// float32 arrives by 16-byte cp.async, all in flight at once (the caller
// waits); bfloat16 by 8-byte loads, U rounds of them issued before their
// widened stores, so that a thread has U * NP loads in flight.
template <int NP, int DP, int U, class W>
__device__ __forceinline__ void stage_heads(float* const (&dst)[NP],
                                            const W* const (&src)[NP], int b,
                                            int h0, int gh, int T, int H,
                                            int D) {
  constexpr int RS = DP + FT_PAD;
  const int cpd = D / 4, cpr = gh * cpd, n = T * cpr;
  auto offsets = [&](int e, size_t& s, int& d) {
    const int t = e / cpr, c = e - t * cpr, g = c / cpd;
    s = ((size_t)(b * T + t) * H + h0) * D + 4 * c;
    d = (g * T + t) * RS + 4 * (c - g * cpd);
  };
  if constexpr (!gic::is_bf16<W>) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      size_t s;
      int d;
      offsets(e, s, d);
#pragma unroll
      for (int p = 0; p < NP; ++p) cp_async16(dst[p] + d, src[p] + s);
    }
  } else {
    for (int e0 = threadIdx.x; e0 < n; e0 += U * blockDim.x) {
      uint2 buf[U][NP];
      int d[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < n) {
          size_t s;
          offsets(e, s, d[u]);
#pragma unroll
          for (int p = 0; p < NP; ++p)
            buf[u][p] = __ldg(reinterpret_cast<const uint2*>(src[p] + s));
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (e0 + u * static_cast<int>(blockDim.x) < n) {
#pragma unroll
          for (int p = 0; p < NP; ++p)
            *reinterpret_cast<float4*>(dst[p] + d[u]) = make_float4(
                gic::bf16_lo(buf[u][p].x), gic::bf16_hi(buf[u][p].x),
                gic::bf16_lo(buf[u][p].y), gic::bf16_hi(buf[u][p].y));
        }
      }
    }
  }
  if (D < DP) {  // pad columns enter every dot product: zero them
    const int ppr = (DP - D) / 4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = threadIdx.x; e < gh * T * ppr; e += blockDim.x) {
      const int row = e / ppr, d = row * RS + D + 4 * (e - row * ppr);
#pragma unroll
      for (int p = 0; p < NP; ++p) *reinterpret_cast<float4*>(dst[p] + d) = z;
    }
  }
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

  {
    float* const dst[3] = {qs, ks, vs};
    const W* const src[3] = {q, k, v};
    stage_heads<3, DP, STAGE_U, W>(dst, src, b, h0, gh, T, H, D);
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

constexpr int FB_THREADS = 256;       // most threads a block
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

  {
    float* const dst[4] = {qs, ks, vs, os};
    const W* const src[4] = {q, k, v, dout};
    stage_heads<4, DP, STAGE_U, W>(dst, src, b, h0, gh, T, H, D);
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

// ---- the fused kernels at 32 < D <= 64: a row's columns in two halves

constexpr int FC_DP = 64;                 // columns a staged row holds
constexpr int FC_CS = 2;                  // threads a row (column halves)
constexpr int FC_HALF = FC_DP / FC_CS;    // columns a thread holds
constexpr int FC_RS = FC_DP + FT_PAD;     // staged row stride
constexpr int FC_THREADS = 256;           // most threads a block

// Column half c of a row is its float4 chunks c, c + 2, ..., c + 14:
// chunk m of the half holds columns 8m + 4c .. 8m + 4c + 3, so the two
// lanes of a row read and write neighbouring 16 bytes.
__device__ __forceinline__ int half_col(int m, int c) { return 8 * m + 4 * c; }

__device__ __forceinline__ void load_half(float (&r)[FC_HALF],
                                          const float* row, int c) {
#pragma unroll
  for (int m = 0; m < FC_HALF / 4; ++m) {
    const float4 x = ld4(row + half_col(m, c));
    r[4 * m] = x.x;
    r[4 * m + 1] = x.y;
    r[4 * m + 2] = x.z;
    r[4 * m + 3] = x.w;
  }
}

// a . (the thread's half of a staged row) in two chains, chunks of even m
// on one and odd m on the other, then their sum: half of a dot product,
// which one shuffle with the row's other lane completes.
__device__ __forceinline__ float dot_half(const float (&a)[FC_HALF],
                                          const float* row, int c) {
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int m = 0; m < FC_HALF / 4; m += 2) {
    const float4 x = ld4(row + half_col(m, c));
    const float4 y = ld4(row + half_col(m + 1, c));
    a0 = fmaf(a[4 * m], x.x, a0);
    a1 = fmaf(a[4 * m + 4], y.x, a1);
    a0 = fmaf(a[4 * m + 1], x.y, a0);
    a1 = fmaf(a[4 * m + 5], y.y, a1);
    a0 = fmaf(a[4 * m + 2], x.z, a0);
    a1 = fmaf(a[4 * m + 6], y.z, a1);
    a0 = fmaf(a[4 * m + 3], x.w, a0);
    a1 = fmaf(a[4 * m + 7], y.w, a1);
  }
  return a0 + a1;
}

// acc += a * (the thread's half of a staged row)
__device__ __forceinline__ void axpy_half(float (&acc)[FC_HALF], float a,
                                          const float* row, int c) {
#pragma unroll
  for (int m = 0; m < FC_HALF / 4; ++m) {
    const float4 x = ld4(row + half_col(m, c));
    acc[4 * m] = fmaf(a, x.x, acc[4 * m]);
    acc[4 * m + 1] = fmaf(a, x.y, acc[4 * m + 1]);
    acc[4 * m + 2] = fmaf(a, x.z, acc[4 * m + 2]);
    acc[4 * m + 3] = fmaf(a, x.w, acc[4 * m + 3]);
  }
}

// The thread's half of an output row, times mul, chunk by chunk inside D
// (D is a multiple of 8: both lanes of a row hold D / 8 chunks).
template <class W>
__device__ __forceinline__ void store_half(W* dst, const float (&acc)[FC_HALF],
                                           int c, int D, float mul) {
#pragma unroll
  for (int m = 0; m < FC_HALF / 4; ++m) {
    if (half_col(m, c) < D)
      st4w(dst + half_col(m, c),
           make_float4(acc[4 * m] * mul, acc[4 * m + 1] * mul,
                       acc[4 * m + 2] * mul, acc[4 * m + 3] * mul));
  }
}

// Grid: B * ceil(H / G) blocks (batch row, group of G heads); block:
// FC_CS*G*T threads rounded up to a warp.  Dynamic shared memory: the q,
// k and v tiles of G heads, T rows of FC_RS floats each, then the scores
// [G, T, T | 1].
template <class W>
__global__ void __launch_bounds__(FC_THREADS) flash_fwd_fused64_kernel(
    const W* __restrict__ q, const W* __restrict__ k,
    const W* __restrict__ v, const int* __restrict__ lengths,
    W* __restrict__ out, float* __restrict__ lse, int T, int H, int D,
    int G, int causal, float scale) {
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) float fc_smem[];
  const int groups = (H + G - 1) / G;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * G;
  const int gh = min(G, H - h0);  // heads of this block
  const int LS = T | 1;  // odd: a warp's 16 rows write 16 distinct banks
  const int plane = G * T * FC_RS;
  float* const qs = fc_smem;
  float* const ks = qs + plane;
  float* const vs = ks + plane;
  float* const ss = vs + plane;
  {
    float* const dst[3] = {qs, ks, vs};
    const W* const src[3] = {q, k, v};
    stage_heads<3, FC_DP, STAGE_U, W>(dst, src, b, h0, gh, T, H, D);
  }

  // thread -> (row slot r = (head g, query row i), column half c); both
  // lanes of a row take every key.  A dead slot (past gh*T) has no keys
  // and writes nothing but takes part in the shuffles.
  const int c = threadIdx.x % FC_CS, r = threadIdx.x / FC_CS;
  const bool live = r < gh * T;
  const int g = live ? r / T : 0, i = live ? r - g * T : 0;
  const int len = lengths != nullptr ? min(max(lengths[b], 0), T) : T;
  const int nk = !live ? 0 : causal ? min(len, i + 1) : len;  // j < nk
  const int nwarp = static_cast<int>(__reduce_max_sync(FULL, nk));
  const float* const kh = ks + g * T * FC_RS;
  const float* const vh = vs + g * T * FC_RS;
  float* const srow = ss + (g * T + i) * LS;

  cp_async_wait_all();
  __syncthreads();
  // pass 1: the scores and their max; lane 0 keeps them in shared memory
  float mx = NEG;
  {
    float qr[FC_HALF];
    load_half(qr, qs + (g * T + i) * FC_RS, c);
#pragma unroll 2
    for (int j = 0; j < nwarp; ++j) {
      float d = dot_half(qr, kh + j * FC_RS, c);
      d += __shfl_xor_sync(FULL, d, 1);  // both lanes: the same sum
      const float sc = j < nk ? d * scale : -INFINITY;
      mx = fmaxf(mx, sc);
      if (c == 0 && live) srow[j] = sc;
    }
  }
  __syncwarp();

  // pass 2: exp(s - mx) = 2^(s*log2e - mx*log2e), their sum and P.V on
  // the thread's columns; a masked key (-inf) gives 0
  const float nm = -mx * LOG2E;
  float acc[FC_HALF], l = 0.f;
#pragma unroll
  for (int e = 0; e < FC_HALF; ++e) acc[e] = 0.f;
#pragma unroll 2
  for (int j = 0; j < nwarp; ++j) {
    const float p = ex2(fmaf(srow[j], LOG2E, nm));
    l += p;
    axpy_half(acc, p, vh + j * FC_RS, c);
  }
  if (!live) return;
  const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < FC_HALF; ++e) acc[e] /= l_safe;
  const size_t row = (size_t)(b * T + i) * H + h0 + g;
  store_half<W>(out + row * D, acc, c, D, 1.f);
  if (c == 0) lse[row] = mx + logf(l_safe);
}

// Grid: B * ceil(H / G) blocks; block: FC_CS*G*T threads rounded up to a
// warp.  Dynamic shared memory: the q, k, v and dO tiles of G heads, T rows
// of FC_RS floats each, then the (p, ds) pairs [G, T, T | 1].
template <class W>
__global__ void __launch_bounds__(FC_THREADS) flash_bwd_fused64_kernel(
    const W* __restrict__ q, const W* __restrict__ k,
    const W* __restrict__ v, const W* __restrict__ out,
    const W* __restrict__ dout, const float* __restrict__ lse,
    const int* __restrict__ lengths, W* __restrict__ dq,
    W* __restrict__ dk, W* __restrict__ dv, int T, int H, int D,
    int G, int causal, float scale) {
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) float fc_smem[];
  const int groups = (H + G - 1) / G;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * G;
  const int gh = min(G, H - h0);  // heads of this block
  const int LP = T | 1;  // odd: a warp's 16 rows, 2 lanes each, 32 banks
  const int plane = G * T * FC_RS;
  float* const qs = fc_smem;
  float* const ks = qs + plane;
  float* const vs = ks + plane;
  float* const os = vs + plane;  // dO
  float2* const pds = reinterpret_cast<float2*>(os + plane);
  {
    float* const dst[4] = {qs, ks, vs, os};
    const W* const src[4] = {q, k, v, dout};
    stage_heads<4, FC_DP, FC_BWD_STAGE_U, W>(dst, src, b, h0, gh, T, H, D);
  }

  // thread -> (row slot r = (head g, row i), column half c); phase 1 reads
  // i as a query row and takes every key, phase 2 as a key row and takes
  // every query.  A dead slot (past gh*T) has no work but takes part in
  // the shuffles.
  const int c = threadIdx.x % FC_CS, r = threadIdx.x / FC_CS;
  const bool live = r < gh * T;
  const int g = live ? r / T : 0, i = live ? r - g * T : 0;
  const int len = lengths != nullptr ? min(max(lengths[b], 0), T) : T;
  const size_t row = (size_t)(b * T + i) * H + h0 + g;
  const float* const kh = ks + g * T * FC_RS;
  const float* const vh = vs + g * T * FC_RS;
  const float* const qh = qs + g * T * FC_RS;
  const float* const oh = os + g * T * FC_RS;
  float2* const pdh = pds + g * T * LP;

  // phase 1, query row i: delta_i, then for each key s_ij, p_ij (masked
  // before the exponential: a row of no valid key has lse about -1e30),
  // dp_ij and ds_ij, written as the pair (p, ds) by the row's two lanes;
  // the thread's half of dq_i accumulated
  {
    float yr[FC_HALF];  // out_i's half, read in place while the copies land
#pragma unroll
    for (int m = 0; m < FC_HALF / 4; ++m) {
      const float4 x = live && half_col(m, c) < D
                           ? ld4w(out + row * D + half_col(m, c))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      yr[4 * m] = x.x;
      yr[4 * m + 1] = x.y;
      yr[4 * m + 2] = x.z;
      yr[4 * m + 3] = x.w;
    }
    const float lse_i = live ? lse[row] : 0.f;
    const int nk = !live ? 0 : causal ? min(len, i + 1) : len;  // j < nk
    const int nwarp = static_cast<int>(__reduce_max_sync(FULL, nk));
    cp_async_wait_all();
    __syncthreads();
    float qr[FC_HALF], dor[FC_HALF], acc[FC_HALF];
    load_half(qr, qh + i * FC_RS, c);
    load_half(dor, oh + i * FC_RS, c);
    float delta;
    {
      float a0 = 0.f, a1 = 0.f;  // dot_half's two chains
#pragma unroll
      for (int m = 0; m < FC_HALF / 4; m += 2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a0 = fmaf(dor[4 * m + e], yr[4 * m + e], a0);
          a1 = fmaf(dor[4 * m + 4 + e], yr[4 * m + 4 + e], a1);
        }
      }
      delta = a0 + a1;
    }
    delta += __shfl_xor_sync(FULL, delta, 1);
#pragma unroll
    for (int e = 0; e < FC_HALF; ++e) acc[e] = 0.f;
#pragma unroll 2
    for (int j = 0; j < nwarp; ++j) {
      const float* kr = kh + j * FC_RS;
      float sc = dot_half(qr, kr, c);
      float dp = dot_half(dor, vh + j * FC_RS, c);
      sc += __shfl_xor_sync(FULL, sc, 1);
      dp += __shfl_xor_sync(FULL, dp, 1);
      const bool valid = j < nk;
      const float p = valid ? ex2((sc * scale - lse_i) * LOG2E) : 0.f;
      const float ds = p * (dp - delta);
      axpy_half(acc, ds, kr, c);
      if (valid) reinterpret_cast<float*>(pdh + i * LP + j)[c] = c ? ds : p;
    }
    if (live) store_half<W>(dq + row * D, acc, c, D, scale);
  }
  __syncthreads();

  // phase 2, key row j = i: dv_j = sum_i p_ij dO_i and dk_j = sum_i ds_ij
  // q_i over the queries that phase 1 scored against it (the same mask),
  // ascending; the pairs read down column j
  {
    const int j = i;
    const bool keys = live && j < len;
    const int lo = causal ? j : 0;
    const int wlo = static_cast<int>(__reduce_min_sync(FULL, keys ? lo : T));
    const int whi = static_cast<int>(__reduce_max_sync(FULL, keys ? T : 0));
    float dka[FC_HALF], dva[FC_HALF];
#pragma unroll
    for (int e = 0; e < FC_HALF; ++e) dka[e] = dva[e] = 0.f;
#pragma unroll 2
    for (int qi = wlo; qi < whi; ++qi) {
      const bool valid = keys && qi >= lo;
      const float2 x = valid ? pdh[qi * LP + j] : make_float2(0.f, 0.f);
      axpy_half(dva, x.x, oh + qi * FC_RS, c);
      axpy_half(dka, x.y, qh + qi * FC_RS, c);
    }
    if (live) {
      store_half<W>(dk + row * D, dka, c, D, scale);
      store_half<W>(dv + row * D, dva, c, D, 1.f);
    }
  }
}

// ---- the tiled backward: every shape the fused kernels do not take

// One block of four warps owns one (b, h) and walks its key tiles in
// order, and for each the query tiles that can see them; a step is one
// (query tile, key tile) pair of TB_ROWS x TB_ROWS.  Staged rows are the
// inputs' type W, 16 bytes of pad after each; P and dS float32.
constexpr int TB_ROWS = 32;            // queries of a query tile, keys of a key tile
constexpr int TB_THREADS = 128;        // four warps
constexpr int TB_PLD = TB_ROWS + 4;    // P and dS rows, floats

// The tiled backward's layout at head dim DP (the power of two >= D, at
// least 16) in element type W: staged tiles of q and dO (two buffers
// each), k and v, then P and dS (tiled_smem counts the bytes).  ws (the
// dQ sums, rows of WLD floats, then delta) is per (b, h): in shared memory
// after them, or in scratch.
template <int DP, class W>
struct TiledBwd {
  static constexpr int EPC = 16 / sizeof(W);  // elements a 16-byte copy
  static constexpr int LD = DP + EPC;         // a staged row
  static constexpr int TILE = TB_ROWS * LD;   // elements a staged tile
  static constexpr int WLD = DP + 4;          // a dQ sum row
  static constexpr int NJ = DP / 16;          // n8 tiles of half of D
};

// floats of one (b, h)'s ws: the dQ sums of the padded rows and delta
__host__ __device__ inline size_t tb_ws_floats(int T, int DP) {
  const size_t rows = (size_t)(T + TB_ROWS - 1) / TB_ROWS * TB_ROWS;
  return rows * (DP + 4) + rows;
}

__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// Rows t0 .. t0 + TB_ROWS - 1 of one (b, h) (head: the offset of (b, 0, h,
// 0); rs: elements between two time rows) into a staged tile by 16-byte
// cp.async, zero-filled past T and past D.
template <int DP, class W>
__device__ __forceinline__ void tb_stage(W* dst, const W* src, size_t head,
                                         size_t rs, int t0, int T, int D) {
  using L = TiledBwd<DP, W>;
  constexpr int CPR = DP / L::EPC;
  for (int c = threadIdx.x; c < TB_ROWS * CPR; c += TB_THREADS) {
    const int r = c / CPR, col = c % CPR * L::EPC, t = t0 + r;
    const bool ok = t < T && col < D;
    cp_async16z(dst + r * L::LD + col,
                ok ? src + head + (size_t)t * rs + col : src, ok ? 16 : 0);
  }
}

// x = big + small for 3xTF32 (as csrc/decode_embed_bwd.cu splits it: big
// is x cut to TF32, small the exact rest).  EXACT: x is a widened bfloat16,
// exact in TF32 (small is 0 and never used).
template <bool EXACT>
__device__ __forceinline__ void tf32_parts(float x, uint32_t& big,
                                           uint32_t& small) {
  if (EXACT) {
    big = __float_as_uint(x);
    small = 0u;
  } else {
    big = __float_as_uint(x) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big));
  }
}

// d += a * b on the tensor cores (m16n8k8, TF32 in, float32 sums; ZERO:
// d = a * b).
template <bool ZERO>
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if (ZERO)
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f));
  else
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (m16n8k8 TF32: register c holds row gq + 8 (c & 1), column tq
// + 4 (c >> 1)) split into its TF32 parts.
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// d (+)= a * b in 3xTF32, a_small b_big + a_big b_small + a_big b_big,
// without the terms whose small part is zero by construction (AX, BX: the
// operand is a widened bfloat16).  ZERO: the first term run starts d.  The
// float32 instantiation on widened bfloat16 inputs runs the same terms
// plus exact zeros, so the two give the same sums.
template <bool AX, bool BX, bool ZERO>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  if constexpr (!AX) mma_tf32<ZERO>(d, a.small, b.big[0], b.big[1]);
  if constexpr (!BX) mma_tf32<ZERO && AX>(d, a.big, b.small[0], b.small[1]);
  mma_tf32<ZERO && AX && BX>(d, a.big, b.big[0], b.big[1]);
}

// The A fragment at (m0, k0) of a row-major tile (row stride ld) of T_
// (float, or bfloat16 widened); TRANS: of the transposed tile (entry (m, k)
// at s[k * ld + m]).
template <bool EXACT, bool TRANS, class T_>
__device__ __forceinline__ void frag_a(FragA& f, const T_* s, int ld, int m0,
                                       int k0, int gq, int tq) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int m = m0 + gq + (c & 1) * 8, k = k0 + tq + (c >> 1) * 4;
    tf32_parts<EXACT>(to_f(TRANS ? s[k * ld + m] : s[m * ld + k]), f.big[c],
                      f.small[c]);
  }
}

// The B fragment (register c: row tq + 4 c, column gq) at (k0, n0) of a
// [K][N] tile (row stride ld); NK: of an [N][K] one.
template <bool EXACT, bool NK, class T_>
__device__ __forceinline__ void frag_b(FragB& f, const T_* s, int ld, int k0,
                                       int n0, int gq, int tq) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int k = k0 + tq + c * 4, n = n0 + gq;
    tf32_parts<EXACT>(to_f(NK ? s[n * ld + k] : s[k * ld + n]), f.big[c],
                      f.small[c]);
  }
}

// The tiled backward of one (b, h) a block: delta, dQ, dK and dV in one
// launch, for T > FT_TMAX or D > FC_DP (the long captions of
// --max-seq-len past 61: config4's [64, 129, 8, 32] generator and [64 or
// 256, 128, 8, 16] discriminator, config5's [64, 129, 12, 64]).
//   * delta_i = dO_i . out_i first, from the stored (rounded) out, one warp
//     a row (fixed shuffle tree), into ws.
//   * Key tiles j in order, each with its K and V tile staged once; for
//     each, the query tiles i that can see it (from j on when causal;
//     none past the key length), Q_i and dO_i double-buffered by 16-byte
//     cp.async (the next tile lands while this one is multiplied).
//   * A step: S = Q K^T and dP = dO V^T (each warp 16 x 16 of the 32 x 32
//     tile), then P = exp(S / sqrt(D) - lse) where valid and dS = P (dP -
//     delta), into shared P and dS tiles (float32, never rounded); then dV
//     += P^T dO and dK += dS^T Q (a warp's 16 keys x half of D, summed in
//     registers over the key tile's steps) and dQ_i += dS K (its 16 queries
//     x half of D, summed into ws: an entry is always summed by the same
//     thread, in key-tile order).
//   * Every product on the tensor cores (mma.sync m16n8k8): 3xTF32 where
//     an operand is float32 (P and dS, and every operand of the float32
//     instantiation), one TF32 term where both are widened bfloat16; each
//     product of K <= 32 into a fresh accumulator, added to its running sum
//     with a float32 add.
//   * dK and dV of a key tile leave when its last step ends, dQ when every
//     key tile has; key rows past the length get zeros.  No atomics, no
//     sum across blocks: two calls give the same bits.
template <int DP, class W>
__global__ void __launch_bounds__(TB_THREADS) flash_bwd_tiled_kernel(
    const W* __restrict__ q, const W* __restrict__ k,
    const W* __restrict__ v, const W* __restrict__ out,
    const W* __restrict__ dout, const float* __restrict__ lse,
    const int* __restrict__ lengths, W* __restrict__ dq,
    W* __restrict__ dk, W* __restrict__ dv, float* __restrict__ ws_global,
    int T, int H, int D, int causal, float scale) {
  using L = TiledBwd<DP, W>;
  constexpr bool X = gic::is_bf16<W>;   // staged operands exact in TF32
  constexpr int KC = DP < 32 ? DP : 32;  // D per fresh accumulator
  extern __shared__ __align__(16) unsigned char tb_smem[];
  W* const qs = reinterpret_cast<W*>(tb_smem);   // [2][TILE]
  W* const os = qs + 2 * L::TILE;                 // dO [2][TILE]
  W* const ks = os + 2 * L::TILE;
  W* const vs = ks + L::TILE;
  float* const ps = reinterpret_cast<float*>(vs + L::TILE);
  float* const ss = ps + TB_ROWS * TB_PLD;        // dS

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nq = (T + TB_ROWS - 1) / TB_ROWS, rows = nq * TB_ROWS;
  float* const wsq =
      ws_global != nullptr ? ws_global + (size_t)bh * tb_ws_floats(T, DP)
                           : ss + TB_ROWS * TB_PLD;
  float* const delta = wsq + (size_t)rows * L::WLD;
  const size_t rs = (size_t)H * D, head = ((size_t)b * T * H + h) * D;
  const int len = lengths != nullptr ? min(max(lengths[b], 0), T) : T;
  const int nkv = (len + TB_ROWS - 1) / TB_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wr = (warp >> 1) * 16;        // the warp's 16 rows of a tile
  const int wc = (warp & 1) * 16;         // its 16 keys of S and dP
  const int wd = (warp & 1) * (DP / 2);   // its half of D

  // the first tiles start landing while delta is summed
  auto first_i = [&](int j) { return causal ? j : 0; };
  if (nkv > 0) {
    tb_stage<DP>(ks, k, head, rs, 0, T, D);
    tb_stage<DP>(vs, v, head, rs, 0, T, D);
    tb_stage<DP>(qs, q, head, rs, first_i(0) * TB_ROWS, T, D);
    tb_stage<DP>(os, dout, head, rs, first_i(0) * TB_ROWS, T, D);
  }
  for (int i = tid; i < rows * L::WLD; i += TB_THREADS) wsq[i] = 0.f;
  for (int r = warp; r < rows; r += TB_THREADS / 32) {
    float acc = 0.f;
    if (r < T)
      for (int d = lane; d < D; d += 32)
        acc = fmaf(to_f(dout[head + (size_t)r * rs + d]),
                   to_f(out[head + (size_t)r * rs + d]), acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) delta[r] = acc;
  }

  float dka[L::NJ][4], dva[L::NJ][4];
#pragma unroll
  for (int n = 0; n < L::NJ; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[n][c] = dva[n][c] = 0.f;

  int buf = 0;
  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * TB_ROWS;
    for (int i = first_i(j); i < nq; ++i) {
      cp_async_wait_all();
      __syncthreads();  // this step's tiles landed; the last step is done
      if (i + 1 < nq) {
        tb_stage<DP>(qs + (buf ^ 1) * L::TILE, q, head, rs,
                     (i + 1) * TB_ROWS, T, D);
        tb_stage<DP>(os + (buf ^ 1) * L::TILE, dout, head, rs,
                     (i + 1) * TB_ROWS, T, D);
      }
      const W* const qt = qs + buf * L::TILE;
      const W* const ot = os + buf * L::TILE;
      const int q0 = i * TB_ROWS;

      // S and dP: the warp's rows wr.., keys wc.. (two n8 tiles)
      float sa[2][4], pa[2][4];
#pragma unroll
      for (int dc = 0; dc < DP; dc += KC) {
        float sp[2][4], pp[2][4];
#pragma unroll
        for (int kk = 0; kk < KC; kk += 8) {
          FragA aq, ao;
          frag_a<X, false>(aq, qt, L::LD, wr, dc + kk, gq, tq);
          frag_a<X, false>(ao, ot, L::LD, wr, dc + kk, gq, tq);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            FragB bk, bv;
            frag_b<X, true>(bk, ks, L::LD, dc + kk, wc + n * 8, gq, tq);
            frag_b<X, true>(bv, vs, L::LD, dc + kk, wc + n * 8, gq, tq);
            if (kk == 0) {
              mma3<X, X, true>(sp[n], aq, bk);
              mma3<X, X, true>(pp[n], ao, bv);
            } else {
              mma3<X, X, false>(sp[n], aq, bk);
              mma3<X, X, false>(pp[n], ao, bv);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            sa[n][c] = dc == 0 ? sp[n][c] : sa[n][c] + sp[n][c];
            pa[n][c] = dc == 0 ? pp[n][c] : pa[n][c] + pp[n][c];
          }
      }
      // P and dS (masked before the exponential: a row of no valid key
      // has lse about -1e30)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rl = wr + gq + hh * 8, qi = q0 + rl;
        const float l_q = qi < T ? lse[((size_t)b * T + qi) * H + h] : 0.f;
        const float d_q = delta[qi];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = wc + n * 8 + tq * 2 + e, key = k0 + cl;
            const bool valid = qi < T && key < len && (!causal || key <= qi);
            const float p =
                valid ? ex2((sa[n][2 * hh + e] * scale - l_q) * LOG2E)
                      : 0.f;
            ps[rl * TB_PLD + cl] = p;
            ss[rl * TB_PLD + cl] = p * (pa[n][2 * hh + e] - d_q);
          }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q: keys wr.. of the key tile, D
      // columns wd.. (A: P and dS read transposed; B: dO and Q [q][d])
      FragA ap[TB_ROWS / 8], as_[TB_ROWS / 8];
#pragma unroll
      for (int kk = 0; kk < TB_ROWS; kk += 8) {
        frag_a<false, true>(ap[kk / 8], ps, TB_PLD, wr, kk, gq, tq);
        frag_a<false, true>(as_[kk / 8], ss, TB_PLD, wr, kk, gq, tq);
      }
#pragma unroll
      for (int n = 0; n < L::NJ; ++n) {
        float vp[4], kp[4];
#pragma unroll
        for (int kk = 0; kk < TB_ROWS; kk += 8) {
          FragB bo, bq;
          frag_b<X, false>(bo, ot, L::LD, kk, wd + n * 8, gq, tq);
          frag_b<X, false>(bq, qt, L::LD, kk, wd + n * 8, gq, tq);
          if (kk == 0) {
            mma3<false, X, true>(vp, ap[0], bo);
            mma3<false, X, true>(kp, as_[0], bq);
          } else {
            mma3<false, X, false>(vp, ap[kk / 8], bo);
            mma3<false, X, false>(kp, as_[kk / 8], bq);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          dva[n][c] += vp[c];
          dka[n][c] += kp[c];
        }
      }
      // dQ_i += dS K: queries wr.. of the query tile, D columns wd..
      FragA ad[TB_ROWS / 8];
#pragma unroll
      for (int kk = 0; kk < TB_ROWS; kk += 8)
        frag_a<false, false>(ad[kk / 8], ss, TB_PLD, wr, kk, gq, tq);
#pragma unroll
      for (int n = 0; n < L::NJ; ++n) {
        float qp[4];
#pragma unroll
        for (int kk = 0; kk < TB_ROWS; kk += 8) {
          FragB bk;
          frag_b<X, false>(bk, ks, L::LD, kk, wd + n * 8, gq, tq);
          if (kk == 0)
            mma3<false, X, true>(qp, ad[0], bk);
          else
            mma3<false, X, false>(qp, ad[kk / 8], bk);
        }
        float* const row = wsq + (size_t)(q0 + wr + gq) * L::WLD + wd +
                           n * 8 + tq * 2;
        row[0] += qp[0];
        row[1] += qp[1];
        row[8 * L::WLD] += qp[2];
        row[8 * L::WLD + 1] += qp[3];
      }
      buf ^= 1;
    }

    // dK and dV of key tile j
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k0 + wr + gq + hh * 8;
#pragma unroll
      for (int n = 0; n < L::NJ; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wd + n * 8 + tq * 2 + e;
          if (key < T && col < D) {
            store_as(dk, head + (size_t)key * rs + col,
                     dka[n][2 * hh + e] * scale);
            store_as(dv, head + (size_t)key * rs + col, dva[n][2 * hh + e]);
          }
          dka[n][2 * hh + e] = dva[n][2 * hh + e] = 0.f;
        }
    }
    if (j + 1 < nkv) {
      __syncthreads();  // every warp is done with this key tile
      tb_stage<DP>(ks, k, head, rs, (j + 1) * TB_ROWS, T, D);
      tb_stage<DP>(vs, v, head, rs, (j + 1) * TB_ROWS, T, D);
      tb_stage<DP>(qs + buf * L::TILE, q, head, rs,
                   first_i(j + 1) * TB_ROWS, T, D);
      tb_stage<DP>(os + buf * L::TILE, dout, head, rs,
                   first_i(j + 1) * TB_ROWS, T, D);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every dQ sum is in

  // key rows of no step (past the length) get zeros; dQ leaves scaled
  constexpr int C4 = DP / 4;
  for (int i = tid; i < T * C4; i += TB_THREADS) {
    const int r = i / C4, c = i % C4 * 4;
    if (c >= D) continue;
    const size_t at = head + (size_t)r * rs + c;
    const float* a = wsq + (size_t)r * L::WLD + c;
    st4w(dq + at, make_float4(a[0] * scale, a[1] * scale, a[2] * scale,
                              a[3] * scale));
    if (r >= nkv * TB_ROWS) {
      st4w(dk + at, make_float4(0.f, 0.f, 0.f, 0.f));
      st4w(dv + at, make_float4(0.f, 0.f, 0.f, 0.f));
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

constexpr int CARD_SMEM = 227 * 1024;  // shared memory a block may use

// The dynamic shared memory of a fused block of G heads, by the kernels'
// layouts above: float32 tiles of the staged tensors (3 forward, 4
// backward) with rows of DP + FT_PAD floats, then the forward's scores
// (D > 32) or the backward's P and dS.
int fused_smem(bool bwd, int T, int D, int G) {
  if (D > FT_DMAX)
    return 4 * G * T * ((bwd ? 4 : 3) * FC_RS + (bwd ? 2 : 1) * (T | 1));
  const int rs = (D <= 16 ? 16 : 32) + FT_PAD;
  return 4 * G * T * (bwd ? FB_PLANES * rs + 2 * bwd_ld(T) : 3 * rs);
}

// A fused launch as the wrapper planned it (flash_attention.py:
// flash_fwd_plan, flash_bwd_plan choose G, the threads and the bytes; this
// file chooses nothing): refused unless its threads cover two a row of G
// heads within the kernel's launch bounds and its bytes cover the layout
// within what a block may use.
bool fused_plan_ok(bool bwd, int T, int H, int D, int G, int threads,
                   int smem) {
  const int most = D > FT_DMAX ? FC_THREADS : bwd ? FB_THREADS : FT_THREADS;
  return T <= FT_TMAX && D <= FC_DP && G >= 1 && G <= H &&
         threads % 32 == 0 && threads >= 2 * G * T && threads <= most &&
         smem >= fused_smem(bwd, T, D, G) && smem <= CARD_SMEM;
}

// The tiled backward's head dim: the power of two >= D, at least 16.
int tiled_dp(int D) {
  int dp = 16;
  while (dp < D) dp <<= 1;
  return dp;
}

// The shared memory a tiled backward block uses (TiledBwd's layout): the
// staged tiles, P and dS, and, where ws_shared, one (b, h)'s ws.
size_t tiled_smem(bool bf16, int T, int dp, bool ws_shared) {
  const size_t esz = bf16 ? 2 : 4, ld = dp + 16 / esz;
  return 6 * TB_ROWS * ld * esz + 2 * TB_ROWS * TB_PLD * 4 +
         (ws_shared ? 4 * tb_ws_floats(T, dp) : 0);
}

// A tiled backward launch as the wrapper planned it (flash_bwd_plan):
// refused unless it is TB_THREADS threads of the kernel for D's head dim
// and its bytes cover the layout (ws in shared memory where no scratch is
// given) within what a block may use.
bool tiled_plan_ok(bool bf16, int T, int D, int dp, int threads, int smem,
                   bool ws_shared) {
  return dp == tiled_dp(D) && dp <= 256 && threads == TB_THREADS &&
         (size_t)smem >= tiled_smem(bf16, T, dp, ws_shared) &&
         smem <= CARD_SMEM;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One launch of a planned kernel; dynamic shared memory above 48 KB must be
// allowed per kernel first.
template <class... P, class... A>
cudaError_t launch_fused(void (*kernel)(P...), int blocks, int threads,
                         int smem, cudaStream_t st, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <class W>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int* lengths, void* out, float* lse, int B,
                       int T, int H, int D, int causal, float scale, int G,
                       int threads, int smem, cudaStream_t st) {
  const W* qw = static_cast<const W*>(q);
  const W* kw = static_cast<const W*>(k);
  const W* vw = static_cast<const W*>(v);
  W* ow = static_cast<W*>(out);
  if (G == 0) {
    flash_fwd_kernel<W><<<grid_of(B, T, H, D), NT, 0, st>>>(
        qw, kw, vw, lengths, ow, lse, T, H, D, threads_per_row(D), causal,
        scale);
    return cudaGetLastError();
  }
  const int blocks = B * ((H + G - 1) / G);
  return D <= 16   ? launch_fused(flash_fwd_fused_kernel<16, W>, blocks,
                                  threads, smem, st, qw, kw, vw, lengths, ow,
                                  lse, T, H, D, G, causal, scale)
         : D <= 32 ? launch_fused(flash_fwd_fused_kernel<32, W>, blocks,
                                  threads, smem, st, qw, kw, vw, lengths, ow,
                                  lse, T, H, D, G, causal, scale)
                   : launch_fused(flash_fwd_fused64_kernel<W>, blocks,
                                  threads, smem, st, qw, kw, vw, lengths, ow,
                                  lse, T, H, D, G, causal, scale);
}

template <class W>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const float* lse,
                       const int* lengths, void* dq, void* dk, void* dv,
                       float* scratch, int B, int T, int H, int D,
                       int causal, float scale, int G, int dp, int threads,
                       int smem, cudaStream_t st) {
  const W* qw = static_cast<const W*>(q);
  const W* kw = static_cast<const W*>(k);
  const W* vw = static_cast<const W*>(v);
  const W* ow = static_cast<const W*>(out);
  const W* gw = static_cast<const W*>(dout);
  W* dqw = static_cast<W*>(dq);
  W* dkw = static_cast<W*>(dk);
  W* dvw = static_cast<W*>(dv);
  if (G == 0) {  // the tiled backward, one (b, h) a block
    switch (dp) {
      case 16:
        return launch_fused(flash_bwd_tiled_kernel<16, W>, B * H, threads,
                            smem, st, qw, kw, vw, ow, gw, lse, lengths, dqw,
                            dkw, dvw, scratch, T, H, D, causal, scale);
      case 32:
        return launch_fused(flash_bwd_tiled_kernel<32, W>, B * H, threads,
                            smem, st, qw, kw, vw, ow, gw, lse, lengths, dqw,
                            dkw, dvw, scratch, T, H, D, causal, scale);
      case 64:
        return launch_fused(flash_bwd_tiled_kernel<64, W>, B * H, threads,
                            smem, st, qw, kw, vw, ow, gw, lse, lengths, dqw,
                            dkw, dvw, scratch, T, H, D, causal, scale);
      case 128:
        return launch_fused(flash_bwd_tiled_kernel<128, W>, B * H, threads,
                            smem, st, qw, kw, vw, ow, gw, lse, lengths, dqw,
                            dkw, dvw, scratch, T, H, D, causal, scale);
      default:
        return launch_fused(flash_bwd_tiled_kernel<256, W>, B * H, threads,
                            smem, st, qw, kw, vw, ow, gw, lse, lengths, dqw,
                            dkw, dvw, scratch, T, H, D, causal, scale);
    }
  }
  const int blocks = B * ((H + G - 1) / G);
  return D <= 16   ? launch_fused(flash_bwd_fused_kernel<16, W>, blocks,
                                  threads, smem, st, qw, kw, vw, ow, gw, lse,
                                  lengths, dqw, dkw, dvw, T, H, D, G, causal,
                                  scale)
         : D <= 32 ? launch_fused(flash_bwd_fused_kernel<32, W>, blocks,
                                  threads, smem, st, qw, kw, vw, ow, gw, lse,
                                  lengths, dqw, dkw, dvw, T, H, D, G, causal,
                                  scale)
                   : launch_fused(flash_bwd_fused64_kernel<W>, blocks,
                                  threads, smem, st, qw, kw, vw, ow, gw, lse,
                                  lengths, dqw, dkw, dvw, T, H, D, G, causal,
                                  scale);
}

}  // namespace

extern "C" {

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v [B, T, H, D] contiguous, float32 or (bf16 = 1) bfloat16; lengths
// [B] int32 or null.  Outputs out [B, T, H, D] in the inputs' type and lse
// [B, T, H] float32.  Each function returns 0 or the CUDA error code of
// its launch; nothing synchronises.  The forward launches the tiled kernel
// where G is 0, else the fused one on the wrapper's plan (G heads a block,
// `threads`, `smem` bytes; T <= FT_TMAX, D <= FC_DP, q, k, v and out
// 16-byte aligned): a plan that fused_plan_ok refuses gives
// cudaErrorInvalidValue and launches nothing.
int gic_flash_fwd(const void* q, const void* k, const void* v,
                  const int* lengths, void* out, float* lse, int B, int T,
                  int H, int D, int causal, float scale, int G, int threads,
                  int smem, int bf16_, void* stream) {
  if (bad_shape(B, T, H, D)) return cudaErrorInvalidValue;
  if (G != 0) {
    if (!fused_plan_ok(false, T, H, D, G, threads, smem))
      return cudaErrorInvalidValue;
    const void* const ptrs[] = {q, k, v, out};
    for (const void* p : ptrs)
      if (!aligned16(p)) return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_ ? launch_fwd<bf16>(q, k, v, lengths, out, lse, B, T, H, D,
                                  causal, scale, G, threads, smem, st)
               : launch_fwd<float>(q, k, v, lengths, out, lse, B, T, H, D,
                                   causal, scale, G, threads, smem, st);
}

// The backward: out, dout [B, T, H, D] and lse [B, T, H] as the forward
// wrote them -> dq, dk, dv [B, T, H, D], delta included, in one launch, in
// the inputs' type, on the wrapper's plan (flash_bwd_plan): the fused
// kernel where G >= 1 (G heads a block, `threads`, `smem`; T <= FT_TMAX,
// D <= FC_DP), the tiled one where G is 0 (one (b, h) a block, TB_THREADS
// threads, head dim dp; its dQ sums and delta in shared memory, or in
// `scratch`, B * H * tb_ws_floats(T, dp) floats, where that is not null).
// A plan that fused_plan_ok / tiled_plan_ok refuses, another shape, or a
// pointer of the eight tensors that is not 16-byte aligned gives
// cudaErrorInvalidValue and launches nothing.
int gic_flash_bwd(const void* q, const void* k, const void* v,
                  const void* out, const void* dout, const float* lse,
                  const int* lengths, void* dq, void* dk, void* dv,
                  float* scratch, int B, int T, int H, int D, int causal,
                  float scale, int G, int dp, int threads, int smem,
                  int bf16_, void* stream) {
  if (bad_shape(B, T, H, D)) return cudaErrorInvalidValue;
  if (G == 0 ? !tiled_plan_ok(bf16_ != 0, T, D, dp, threads, smem,
                              scratch == nullptr)
             : dp != (D <= 16 ? 16 : D <= FT_DMAX ? FT_DMAX : FC_DP) ||
                   !fused_plan_ok(true, T, H, D, G, threads, smem))
    return cudaErrorInvalidValue;
  const void* const ptrs[] = {q, k, v, out, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (!aligned16(p)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_ ? launch_bwd<bf16>(q, k, v, out, dout, lse, lengths, dq, dk,
                                  dv, scratch, B, T, H, D, causal, scale, G,
                                  dp, threads, smem, st)
               : launch_bwd<float>(q, k, v, out, dout, lse, lengths, dq, dk,
                                   dv, scratch, B, T, H, D, causal, scale, G,
                                   dp, threads, smem, st);
}

}  // extern "C"
