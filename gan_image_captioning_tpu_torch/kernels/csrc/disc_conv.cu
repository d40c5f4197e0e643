// Discriminator conv bank + bias + ReLU + max over time, and its backward,
// for Hopper (sm_90a), float32.
//
// Replaces: gan_image_captioning_tpu/kernels/disc_conv.py, functions
// `_mxu_fwd_kernel` and `_mxu_bwd_dx_kernel` (launched per bank by
// `conv_relu_maxpool_mxu` through `_mxu_bank_call`), and `_fwd_kernel` /
// `_bwd_kernel` (the per-batch-row engine, `_bank_call`).  A column q = (b, r)
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
//   outside, with db, as the JAX package does; or, on the autograd route,
//   in the launch from d_pooled and pooled, with db):
//             d_emb row t*eds + k of column q  += w[n, k] * dpm[q, n]
//                                                 for t = idx[q, n]
//             dW[k, n] = sum_q x_q[idx[q, n]*eds + k] * dpm[q, n]
//   `_bwd_kernel` computes the same from the raw d_pooled, with the mask
//   and db in its launch: these kernels do so with MASK.  The row
//   engine's forward `_fwd_kernel` computes the same function as
//   `_mxu_fwd_kernel`, so conv_fwd_kernel replaces both (the wrapper
//   conv_rows_forward counts it apart).
//
// What bounds it on this card.  At the training width (B = 64, R = 64,
// eds = 1, L = 36, banks 3/4/5 x 300) the forward does 0.97 GFLOP per
// pass (0.014 ms at 67 TFLOP/s) and moves 29.5 MB (0.009 ms): bound by
// operations.  The backward needs only the one time row idx[q, n] of each
// (q, n), so it is bound by bytes: idx and dpm read once (29.5 MB).  The
// TPU kernel's loop over every t with a mask, and its XT transpose of the
// input, are TPU artefacts and are not carried over.
//
// What this design does about it.
//   * conv_fwd_kernel: one launch for every bank of a pass (up to
//     FW_MAX_BANKS; the wrapper's plan gives each bank its first filter
//     tile, so blockIdx.y picks the bank).  A block owns FW_QB = 16
//     columns and FW_NB = 64 filters of one bank; the columns' real rows
//     sit in shared memory.  A thread owns FW_NF = 4 filters of one
//     column: their taps (f*eds of them, up to FW_MAXT = 8, a template
//     parameter through a block-uniform switch) and biases live in
//     registers, so each input value read from shared memory (a
//     broadcast: a warp reads two columns) serves 4 FMAs, rather than one
//     shared load of a tap and one of an input per FMA.  Banks of more
//     taps read theirs from shared memory as float4s.  Each output is one
//     fmaf chain over k ascending from 0, then + bias, then the ReLU max
//     over t with the first maximum winning: the order of a thread per
//     (column, filter), so the tiling does not move a pooled bit or an
//     argmax on a near-tie.  K = f*eds is 3-5 at the training width: far
//     too short a product for the tensor cores (mma's k is 8 for tf32,
//     and every tap would be padded), so none are used.  Per (column,
//     filter, t) that leaves f FMAs, the bias add, a compare and two
//     selects and f/4 shared loads, about 9.5 instructions at f = 4
//     (ptxas's loop), so instruction issue bounds it.
//   * the backward (conv_bwd_kernel): one launch for every bank of a
//     pass, a block per 32 columns of all banks, idx and dpm streamed
//     through shared memory by cp.async, each (column, filter) scattered
//     to its taps' rows in a per-warp accumulator, then one fixed-order
//     reduction of the per-block dW partials; the comment above its code
//     says what bounds it.
//
// conv_dxs_kernel replaces the same file's `_mxu_bwd_kernel`, the DXS
// variant of the MXU backward (the JAX package's GIC_MXU_DX=0): instead of
// d_emb it writes, per bank, the per-step tap gradients
//   DXS[t, q, k] = sum_n [idx[q, n] == t] * dp[q, n] * w[n, k]
// [lv, Q, f*eds], which the caller overlap-adds into d_emb with f shifted
// adds, as `_mxu_vjp_bwd` does, and dW and db through the same
// fixed-order reduction as the backward above.  It takes the raw d_pooled
// and applies the ReLU mask in its launch (the JAX package masks dp and
// sums db around its kernel); the comment above its code says what bounds
// it and how it is laid out.

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int FW_NF = 4, FW_FG = 16, FW_NB = FW_NF * FW_FG;
constexpr int FW_NT = 256, FW_QB = FW_NT / FW_FG;  // 16 columns
constexpr int FW_MAXT = 8, FW_MAX_BANKS = 8;

__host__ __device__ inline int odd(int v) { return v | 1; }

// The banks of one forward launch: per bank its filter count, taps per
// row, first row in w_all / b_all / pooled's columns, first filter tile
// (tile0[count] is the grid's y extent) and its idx [Q, n].
struct FwdBanks {
  int n[FW_MAX_BANKS], f[FW_MAX_BANKS], off[FW_MAX_BANKS];
  int tile0[FW_MAX_BANKS + 1];
  int32_t* idx[FW_MAX_BANKS];
  int count;
};

// One thread's FW_NF filters n0 + 4*fg + j over column x (its rows in
// shared memory): TAPS > 0 taps in registers; TAPS == 0, `taps` of them
// from ws [taps][FW_NB].  m / best: pooled value and first argmax.
template <int TAPS>
__device__ __forceinline__ void conv_fwd_filters(
    const float* __restrict__ x, const float* __restrict__ ws,
    const float* __restrict__ w, int ldw, const float* __restrict__ bias,
    int taps, int eds, int lv, int n, int n0, int fg, float (&m)[FW_NF],
    int (&best)[FW_NF]) {
  constexpr int KR = TAPS > 0 ? TAPS : 1;
  float wr[FW_NF][KR], bv[FW_NF];
#pragma unroll
  for (int j = 0; j < FW_NF; ++j) {
    const int nn = n0 + fg * FW_NF + j;
    bv[j] = nn < n ? bias[nn] : 0.f;
#pragma unroll
    for (int k = 0; k < KR; ++k)
      wr[j][k] = TAPS > 0 && nn < n ? w[(size_t)nn * ldw + k] : 0.f;
  }
  for (int t = 0; t < lv; ++t) {
    const float* xt = x + t * eds;
    float acc[FW_NF];
#pragma unroll
    for (int j = 0; j < FW_NF; ++j) acc[j] = 0.f;
    if (TAPS > 0) {
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        const float xv = xt[k];
#pragma unroll
        for (int j = 0; j < FW_NF; ++j) acc[j] = fmaf(xv, wr[j][k], acc[j]);
      }
    } else {
      for (int k = 0; k < taps; ++k) {
        const float xv = xt[k];
        const float4 wv =
            *reinterpret_cast<const float4*>(ws + k * FW_NB + fg * FW_NF);
        acc[0] = fmaf(xv, wv.x, acc[0]);
        acc[1] = fmaf(xv, wv.y, acc[1]);
        acc[2] = fmaf(xv, wv.z, acc[2]);
        acc[3] = fmaf(xv, wv.w, acc[3]);
      }
    }
    // relu(z) > m with m from -1 is the same test as z > m once m =
    // relu(z at t = 0) >= 0; the first maximum wins (strict >)
#pragma unroll
    for (int j = 0; j < FW_NF; ++j) {
      const float z = acc[j] + bv[j];
      if (t == 0) {
        m[j] = fmaxf(z, 0.f);
        best[j] = 0;
      } else if (z > m[j]) {
        m[j] = z;
        best[j] = t;
      }
    }
  }
}

__global__ void __launch_bounds__(FW_NT) conv_fwd_kernel(
    const float* __restrict__ emb, const float* __restrict__ w_all, int ldw,
    const float* __restrict__ b_all, int Q, int Lp, int R, int eds, int L,
    FwdBanks banks, float* __restrict__ pooled, int ldp) {
  extern __shared__ float smem[];
  const int tile = blockIdx.y;
  int b = 0;
  while (b + 1 < banks.count && tile >= banks.tile0[b + 1]) ++b;
  const int n = banks.n[b], f = banks.f[b], off = banks.off[b];
  const int taps = f * eds, lv = L - f + 1;
  const int n0 = (tile - banks.tile0[b]) * FW_NB;
  const int rows = L * eds, xld = odd(rows);
  float* xs = smem;                    // [FW_QB][xld]
  float* ws = smem + FW_QB * xld;      // [taps][FW_NB], taps > FW_MAXT only
  const int q0 = blockIdx.x * FW_QB, tid = threadIdx.x, E = R * eds;
  const float* w = w_all + (size_t)off * ldw;

  for (int e = tid; e < FW_QB * rows; e += FW_NT) {
    const int qi = e % FW_QB, p = e / FW_QB, q = q0 + qi;
    float v = 0.f;
    if (q < Q) {
      const int bq = q / R, r = q % R, t = p / eds, k = p % eds;
      v = emb[((size_t)bq * Lp + t) * E + r * eds + k];
    }
    xs[qi * xld + p] = v;
  }
  if (taps > FW_MAXT) {
    for (int e = tid; e < taps * FW_NB; e += FW_NT) {
      const int nl = e % FW_NB, k = e / FW_NB, nn = n0 + nl;
      ws[k * FW_NB + nl] = nn < n ? w[(size_t)nn * ldw + k] : 0.f;
    }
  }
  __syncthreads();

  const int fg = tid % FW_FG, qi = tid / FW_FG, q = q0 + qi;
  const float* x = xs + qi * xld;
  const float* bias = b_all + off;
  float m[FW_NF];
  int best[FW_NF];
  switch (taps) {  // block-uniform
#define GIC_TAPS(K)                                                        \
  case K:                                                                  \
    conv_fwd_filters<K>(x, ws, w, ldw, bias, taps, eds, lv, n, n0, fg, m, \
                        best);                                             \
    break;
    GIC_TAPS(1) GIC_TAPS(2) GIC_TAPS(3) GIC_TAPS(4)
    GIC_TAPS(5) GIC_TAPS(6) GIC_TAPS(7) GIC_TAPS(8)
#undef GIC_TAPS
    default:
      conv_fwd_filters<0>(x, ws, w, ldw, bias, taps, eds, lv, n, n0, fg, m,
                          best);
  }
  if (q >= Q) return;
  int32_t* idx = banks.idx[b];
#pragma unroll
  for (int j = 0; j < FW_NF; ++j) {
    const int nn = n0 + fg * FW_NF + j;
    if (nn < n) {
      pooled[(size_t)q * ldp + off + nn] = m[j];
      idx[(size_t)q * n + nn] = best[j];
    }
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

// taps: the most of any bank of the launch that reads its taps from
// shared memory (more than FW_MAXT), else 0.
size_t fwd_smem(int L, int eds, int taps) {
  return sizeof(float) * ((size_t)FW_QB * odd(L * eds) + (size_t)taps * FW_NB);
}

// ---- The backward of the conv banks (conv_bwd_kernel, gic_conv_bwd), for
// the `mxu` engine and, with MASK, the per-batch-row engine (`pallas`,
// `hybrid`): every bank of a pass in one launch, tiled by column, then one
// fixed-order reduction of the per-block dW (and db) partials.  float32.
//
// For one bank of n filters of f taps (taps = f*eds, w [n, taps] the bank's
// rows of w_all), column q = (b, r) with rows x_q[t*eds + e] =
// emb[b, t, r*eds + e] (t < L), the pooled argmax rows idx [Q, n] and the
// masked pooled gradient dp:
//   d_emb row t*eds + k of column q += w[n, k] * dp[q, n], t = idx[q, n]
//   dW[n, k] = sum_q x_q[idx[q, n]*eds + k] * dp[q, n]
//   db[n]    = sum_q dp[q, n]
// MASK = false: dp is given, one [Q, n] tensor per bank (the JAX package
// masks it and sums db outside `_mxu_bwd_dx_kernel`).  MASK = true: dp is
// d_pooled masked by pooled > 0 in the launch, and db is summed too (as
// `_bwd_kernel` does).
//
// What bounds it.  Only the one time row idx[q, n] of each (q, n) is
// touched: per (q, n) 2*taps FMAs against 8 bytes read (idx, dp; 12 with
// MASK: idx, pooled, d_pooled).  At the training width (B = R = 64, eds =
// 1, L = 36, banks 3/4/5 x 300: Q = 4096, 3.7 M pairs) that is 29.5 MB
// (44.2 MB with MASK) against 30 MFLOP: bound by bytes, 0.0092 ms (0.0134)
// at 3.35 TB/s.  The design has to stream idx and dp once at the memory's
// rate and keep each pair's work O(taps), not O(L): the scan that sent
// every filter past every input row cost Q*L*n steps a bank.
//
// What this design does about it.
//   * A block owns CB_QB = 32 columns across every bank of the launch (up
//     to CB_MAX_BANKS), so it owns their d_emb rows: no atomics.  The
//     columns' input rows sit in shared memory.
//   * idx and dp (and pooled) stream through shared memory in slabs of
//     CB_SF = 64 filters of one bank for all 32 columns, with the slab's
//     taps, by cp.async into a CB_STAGES-deep ring, CB_STAGES - CB_GROUPS
//     slabs ahead.  A copy moves 16 bytes: 4-byte copies take four times
//     the copy instructions.  Each slab row's 16-byte chunks are
//     rotated (cb_slot) so that both readers below are free of bank
//     conflicts.  Rows that are not 16-byte aligned (n or the row stride
//     not a multiple of 4) take 4-byte copies.
//   * Two groups of 8 warps take alternate slabs, so that 16 warps hide
//     each other's shared-memory latency.
//   * Scatter: warp w of a group takes the slab's filters [8w, 8w + 8), a
//     lane per column, idx and dp of 4 filters in one 16-byte load and
//     their taps in one 16-byte broadcast per tap.  The lane adds each
//     filter's taps into rows idx*eds + k of its own column in the warp's
//     accumulator acc[w][row][lane]: an address per lane, one shared bank
//     per lane, so no conflicts and no races.  Each (column, filter) costs
//     taps read-modify-writes, not L*eds tests.
//   * dW: the same warp, a lane per (filter, group of 8 columns), sums its
//     8 columns at their argmax rows in column order, then the 4 groups by
//     two shuffles: a partial per block, per (tap, filter).  The taps are
//     a template parameter (1..8, through a block-uniform switch), so the
//     taps' sums run side by side.
//   * At the end the block sums its 16 warps' accumulators in warp order
//     and writes d_emb (its time padding rows zero), so d_emb is written
//     once and needs no memset.  A launch after the first (more than
//     CB_MAX_BANKS banks) adds into it.
//   * The accumulators take 16 * L*eds * 32 floats.  Where that does not
//     fit (long sequences, or eds > 1: at eds = 16 and 8 time rows already
//     256 KB), the block accumulates the rows in equal windows
//     (cb_window), streaming the slabs once per window and computing dW on
//     the first.  Rows of more than CB_MAXT taps are read from w_all (L1)
//     rather than staged, so the ring stays small.  config3 (36 rows, 3-5
//     taps) is one window with staged taps.
//   * conv_bwd_reduce_kernel sums the partials over blocks in block order
//     (CB_RD_S block ranges, then the ranges in order) and writes dW in
//     w_all's layout, the padding taps of a shorter bank zero, and db.
// Every sum has a fixed order, so two calls are bit-equal.  The order is
// not the one-chain-per-row order of the kernel this replaced (its d_emb
// differs in the last bits).
// What bounds it now (config3): shared-memory wavefronts, the acc
// read-modify-writes and the dW gathers of x (which conflict at random
// rows), and the fixed cost of two launches and the prologue; PERF.md
// gives the H100's times.

constexpr int CB_QB = 32;                   // columns per block: a lane each
constexpr int CB_GROUPS = 2, CB_GW = 8;     // warp groups, warps a group
constexpr int CB_WARPS = CB_GROUPS * CB_GW, CB_NT = 32 * CB_WARPS;
constexpr int CB_FW = 8;                    // filters per warp per slab
constexpr int CB_SF = CB_GW * CB_FW;        // 64 filters per slab
constexpr int CB_SLD = CB_SF + 4;           // a slab row: 17 chunks of 16 B
constexpr int CB_STAGES = 4, CB_MAX_BANKS = 8;
constexpr int CB_MAXT = 8;                  // taps staged for a register path
constexpr size_t CB_SMEM_LIMIT = 232448;    // H100: opt-in bytes per block
static_assert(CB_STAGES >= CB_GROUPS + 1, "a slab in flight per group");
constexpr int CB_RD_O = 32, CB_RD_S = 8, CB_RD_NT = CB_RD_O * CB_RD_S;
static_assert(CB_QB == 32 && CB_FW == 8 && CB_SF == 64,
              "dW maps a warp to 8 filters x 4 groups of 8 columns; "
              "cb_slot rotates the 16 chunks of 4 filters of a slab row");

// The word of (column r, slab filter gl) in a [CB_QB][CB_SLD] slab array.
// Row r's 16-byte chunks (4 filters each) are rotated by 2*(r/8): a lane
// per column reading one chunk (the scatter) and 8 lanes over each of 4
// columns 8 apart (dW) then hit distinct banks, and a chunk stays whole
// for the 16-byte copies.
__host__ __device__ inline int cb_slot(int r, int gl) {
  return r * CB_SLD + ((((gl >> 2) + 2 * (r >> 3)) & 15) << 2) + (gl & 3);
}

// Whether a launch stages its slabs' taps (rows of at most CB_MAXT taps:
// read from registers); longer rows are read from w_all in global memory.
__host__ __device__ inline bool cb_staged(int ldw) { return ldw <= CB_MAXT; }

// Floats of one ring stage: idx, dp (and pooled) [CB_QB][CB_SLD], then, if
// staged, the slab's taps, tap-major [ldw][CB_SF] (16-byte aligned).
__host__ __device__ inline int cb_stage(int ldw, bool mask) {
  return (mask ? 3 : 2) * CB_QB * CB_SLD +
         (cb_staged(ldw) ? (CB_SF * ldw + 3) & ~3 : 0);
}

// The banks of one launch: per bank its filter count, taps per row, first
// row of w_all (its first filter of the pass), row stride of dp / pooled,
// first slab (slab0[count] is the launch's slab count), idx [Q, n], dp
// (row q at d + q*ldd) and, with MASK, pooled (same layout).
struct BwdBanks {
  int n[CB_MAX_BANKS], f[CB_MAX_BANKS], off[CB_MAX_BANKS], ldd[CB_MAX_BANKS];
  int slab0[CB_MAX_BANKS + 1];
  const int32_t* idx[CB_MAX_BANKS];
  const float* d[CB_MAX_BANKS];
  const float* pooled[CB_MAX_BANKS];
  int count;
};

struct Slab {
  int b, nn0, cnt;  // bank, first filter in the bank, filters (<= CB_SF)
};

__device__ __forceinline__ Slab find_slab(const BwdBanks& bk, int s) {
  int b = 0;
  while (b + 1 < bk.count && s >= bk.slab0[b + 1]) ++b;
  const int nn0 = (s - bk.slab0[b]) * CB_SF;
  return {b, nn0, min(CB_SF, bk.n[b] - nn0)};
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// 16 bytes, through L2 only: the slabs are read once
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A slab's idx / dp (/ pooled) into `buf` (cb_slot layout), 16 bytes a
// copy where the rows allow it, and its taps; columns past Q and filters
// past the slab's count are zeros (they add nothing).
template <bool MASK>
__device__ __forceinline__ void stage_slab(float* buf, const BwdBanks& bk,
                                           const Slab& sl,
                                           const float* __restrict__ w_all,
                                           int ldw, int q0, int Q) {
  int* si = reinterpret_cast<int*>(buf);
  float* sd = buf + CB_QB * CB_SLD;
  float* sp = sd + CB_QB * CB_SLD;
  float* sw = buf + (MASK ? 3 : 2) * CB_QB * CB_SLD;
  const int32_t* idx = bk.idx[sl.b] + sl.nn0;
  const float* d = bk.d[sl.b] + sl.nn0;
  const float* p = MASK ? bk.pooled[sl.b] + sl.nn0 : nullptr;
  const int n = bk.n[sl.b], ldd = bk.ldd[sl.b];
  const bool vec = ((n | ldd) & 3) == 0 && aligned16(idx) && aligned16(d) &&
                   (!MASK || aligned16(p));
  for (int e = threadIdx.x; e < CB_QB * CB_SF / 4; e += CB_NT) {
    const int r = e / (CB_SF / 4), gl = e % (CB_SF / 4) * 4, q = q0 + r;
    const int o = cb_slot(r, gl);
    const size_t oi = (size_t)q * n + gl, od = (size_t)q * ldd + gl;
    if (vec && q < Q && gl + 4 <= sl.cnt) {
      cp_async16(si + o, idx + oi);
      cp_async16(sd + o, d + od);
      if (MASK) cp_async16(sp + o, p + od);
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (q < Q && gl + i < sl.cnt) {
        cp_async4(si + o + i, idx + oi + i);
        cp_async4(sd + o + i, d + od + i);
        if (MASK) cp_async4(sp + o + i, p + od + i);
      } else {
        si[o + i] = 0;
        sd[o + i] = 0.f;
        if (MASK) sp[o + i] = 0.f;
      }
    }
  }
  if (!cb_staged(ldw)) return;
  const float* w = w_all + (size_t)(bk.off[sl.b] + sl.nn0) * ldw;
  for (int e = threadIdx.x; e < sl.cnt * ldw; e += CB_NT) {
    const int gl = e / ldw, k = e - gl * ldw;
    cp_async4(sw + k * CB_SF + gl, w + e);
  }
}

template <bool MASK>
__device__ __forceinline__ float masked(float d, float p) {
  return MASK ? (p > 0.f ? d : 0.f) : d;  // the ReLU mask
}

// One filter's taps into the rows of one column's accumulator `ar` (row
// t*eds - r0 at ar[0], rows CB_QB floats apart).  TAPS > 0: its taps wv,
// every row in the window.  TAPS == 0: `taps` of them at ws, ws_ld floats
// apart; with WIN only the rows in [0, rw) of the window.
template <int TAPS, bool WIN>
__device__ __forceinline__ void scatter_one(float* __restrict__ ar,
                                            const float (&wv)[TAPS > 0 ? TAPS
                                                                       : 1],
                                            const float* ws, int ws_ld,
                                            float d, int taps, int row,
                                            int rw) {
  if (TAPS > 0) {
    constexpr int K = TAPS > 0 ? TAPS : 1;
    float av[K];
#pragma unroll
    for (int k = 0; k < K; ++k) av[k] = ar[k * CB_QB];
#pragma unroll
    for (int k = 0; k < K; ++k) ar[k * CB_QB] = fmaf(wv[k], d, av[k]);
  } else {
    for (int k = 0; k < taps; ++k) {
      if (WIN && (unsigned)(row + k) >= (unsigned)rw) continue;
      ar[k * CB_QB] = fmaf(ws[k * ws_ld], d, ar[k * CB_QB]);
    }
  }
}

// Warp `gl0 / 8`'s work on a slab (the slab filters [gl0, gl0 + 8) below
// `cnt`; TAPS > 0: that many taps, staged, unrolled; 0: `taps`, staged
// or from w_all).  WIN: the accumulator holds rows [r0, r0 + rw) only.
//   Scatter: lane = column; each filter in order adds its taps into rows
//   idx*eds + k of the lane's column of the warp's accumulator `a`
//   (acc[w] + lane).  idx and dp of 4 filters come in one 16-byte load.
//   dW / db: lane (j, grp) sums filter gl0 + j over columns 8*grp ..
//   8*grp + 7 in order, then the groups (0+1 and 2+3, then the two) by
//   shuffles, on the first window only (do_dw).  dW slot (k, g) is
//   pb[k*F + g] for every k < ldw (zero past the bank's taps), db
//   pb[ldw*F + g].
template <bool MASK, int TAPS, bool WIN>
__device__ __forceinline__ void slab_warp(
    float* __restrict__ a, const int* si, const float* sd, const float* sp,
    const float* sw, const float* __restrict__ w_all, const float* xs,
    int xld, int ldw, int taps, int eds, int F, int g0, int gl0, int cnt,
    int r0, int rw, bool do_dw, float* __restrict__ pb, int lane) {
  const bool staged = cb_staged(ldw);
  constexpr int K = TAPS > 0 ? TAPS : 1;
#pragma unroll
  for (int h = 0; h < CB_FW; h += 4) {
    const int o = cb_slot(lane, gl0 + h);
    const int4 t4 = *reinterpret_cast<const int4*>(si + o);
    const float4 d4 = *reinterpret_cast<const float4*>(sd + o);
    float4 p4 = d4;
    if (MASK) p4 = *reinterpret_cast<const float4*>(sp + o);
    // the 4 filters' taps: a 16-byte broadcast per tap
    float4 w4[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      w4[k] = TAPS > 0
                  ? *reinterpret_cast<const float4*>(sw + k * CB_SF + gl0 + h)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    const int tv[4] = {t4.x, t4.y, t4.z, t4.w};
    const float dv[4] = {masked<MASK>(d4.x, p4.x), masked<MASK>(d4.y, p4.y),
                         masked<MASK>(d4.z, p4.z), masked<MASK>(d4.w, p4.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gl = gl0 + h + i;
      float wv[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        wv[k] = i == 0 ? w4[k].x : i == 1 ? w4[k].y : i == 2 ? w4[k].z
                                                            : w4[k].w;
      const int row = tv[i] * eds - r0;
      if (gl < cnt)  // warp-uniform
        scatter_one<TAPS, WIN>(
            a + row * CB_QB, wv,
            staged ? sw + gl : w_all + (size_t)(g0 + gl) * ldw,
            staged ? CB_SF : 1, dv[i], taps, row, rw);
    }
  }
  if (!do_dw) return;

  const int j = lane % CB_FW, grp = lane / CB_FW, gl = gl0 + j;
  const float* x = xs + grp * CB_FW * xld;
  int tt[CB_FW];
  float dd[CB_FW];
#pragma unroll
  for (int c = 0; c < CB_FW; ++c) {
    const int o = cb_slot(grp * CB_FW + c, gl);
    tt[c] = si[o] * eds + c * xld;
    dd[c] = masked<MASK>(sd[o], MASK ? sp[o] : 0.f);
  }
  const bool out = grp == 0 && gl < cnt;
  float* pg = pb + g0 + gl;
  if (TAPS > 0) {
    constexpr int K = TAPS > 0 ? TAPS : 1;
    float sk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sk[k] = 0.f;
#pragma unroll
      for (int c = 0; c < CB_FW; ++c)
        sk[k] = fmaf(x[tt[c] + k], dd[c], sk[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      sk[k] += __shfl_xor_sync(0xffffffffu, sk[k], 8);
#pragma unroll
    for (int k = 0; k < K; ++k)
      sk[k] += __shfl_xor_sync(0xffffffffu, sk[k], 16);
    if (out) {
#pragma unroll
      for (int k = 0; k < K; ++k) pg[(size_t)k * F] = sk[k];
      for (int k = K; k < ldw; ++k) pg[(size_t)k * F] = 0.f;
    }
  } else {
    for (int k = 0; k < ldw; ++k) {
      float s = 0.f;
      if (k < taps) {
#pragma unroll
        for (int c = 0; c < CB_FW; ++c) s = fmaf(x[tt[c] + k], dd[c], s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (out) pg[(size_t)k * F] = s;
    }
  }
  if (MASK) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CB_FW; ++c) s += dd[c];
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (out) pg[(size_t)ldw * F] = s;
  }
}

// One launch: blockIdx.x owns columns [32*blockIdx.x, +32) of every bank in
// `bk`.  part [gridDim.x][ldw*F (+ F with MASK)].  accumulate: add d_emb
// into what an earlier launch of the pass wrote (its time padding rows
// untouched) rather than write it.  rw: the rows of a column accumulated
// at once (cb_window); with fewer than L*eds the slabs stream once per
// window of rows, and dW only on the first.
template <bool MASK>
__global__ void __launch_bounds__(CB_NT) conv_bwd_kernel(
    const float* __restrict__ emb, const float* __restrict__ w_all, int ldw,
    int Q, int Lp, int R, int eds, int L, int F, BwdBanks bk, int accumulate,
    int rw, float* __restrict__ d_emb, float* __restrict__ part) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  const int rows = L * eds, xld = odd(rows), E = R * eds;
  const int stage = cb_stage(ldw, MASK);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * CB_QB, slabs = bk.slab0[bk.count];
  const bool win = rw < rows, staged = cb_staged(ldw);
  float* xs = reinterpret_cast<float*>(smem4);    // [CB_QB][xld]
  float* acc = xs + CB_QB * xld;                  // [CB_WARPS][rw][CB_QB]
  float* ring = acc + CB_WARPS * rw * CB_QB;      // [CB_STAGES][stage]
  float* pb = part + (size_t)blockIdx.x * ((size_t)ldw * F + (MASK ? F : 0));

  // group G = warp / CB_GW takes the slabs s = G (mod CB_GROUPS), CB_GROUPS
  // of them an iteration; CB_STAGES - CB_GROUPS slabs are in flight
  constexpr int AHEAD = CB_STAGES - CB_GROUPS;
  float* a = acc + warp * rw * CB_QB + lane;
  const int E2 = CB_QB * eds, b0 = q0 / R, c0 = q0 % R;
  for (int r0 = 0; r0 < rows; r0 += rw) {
    for (int s = 0; s < AHEAD; ++s) {
      if (s < slabs)
        stage_slab<MASK>(ring + s * stage, bk, find_slab(bk, s), w_all, ldw,
                         q0, Q);
      cp_async_commit();
    }
    if (r0 == 0) {
      for (int e = tid; e < CB_QB * rows; e += CB_NT) {
        const int qi = e % CB_QB, p = e / CB_QB, q = q0 + qi;
        xs[qi * xld + p] =
            q < Q ? emb[((size_t)(q / R) * Lp + p / eds) * E +
                        (q % R) * eds + p % eds]
                  : 0.f;
      }
    }
    for (int e = tid; e < CB_WARPS * rw * CB_QB; e += CB_NT) acc[e] = 0.f;

    for (int s0 = 0; s0 < slabs; s0 += CB_GROUPS) {
#pragma unroll
      for (int g = 0; g < CB_GROUPS; ++g) {  // buffers read at s0 - 1
        const int pre = s0 + AHEAD + g;
        if (pre < slabs)
          stage_slab<MASK>(ring + (pre % CB_STAGES) * stage, bk,
                           find_slab(bk, pre), w_all, ldw, q0, Q);
        cp_async_commit();
      }
      cp_async_wait<AHEAD>();
      __syncthreads();  // slabs s0 .. s0 + CB_GROUPS - 1 are in every view

      const int s = s0 + warp / CB_GW;
      const Slab sl = find_slab(bk, min(s, slabs - 1));
      const float* buf = ring + (s % CB_STAGES) * stage;
      const int* si = reinterpret_cast<const int*>(buf);
      const float* sd = buf + CB_QB * CB_SLD;
      const float* sp = sd + CB_QB * CB_SLD;
      const float* sw = buf + (MASK ? 3 : 2) * CB_QB * CB_SLD;
      const int taps = bk.f[sl.b] * eds, g0 = bk.off[sl.b] + sl.nn0;
      const int gl0 = warp % CB_GW * CB_FW;
      if (s < slabs && gl0 < sl.cnt) {  // warp-uniform
#define GIC_SLAB(K, W)                                                   \
  slab_warp<MASK, K, W>(a, si, sd, sp, sw, w_all, xs, xld, ldw, taps, eds, \
                        F, g0, gl0, sl.cnt, r0, rw, r0 == 0, pb, lane)
        if (win) {  // block-uniform, as are staged and taps
          GIC_SLAB(0, true);
        } else if (!staged) {
          GIC_SLAB(0, false);
        } else {
          switch (taps) {  // at most CB_MAXT when staged
#define GIC_TAPS(K) \
  case K:           \
    GIC_SLAB(K, false); \
    break;
            GIC_TAPS(1) GIC_TAPS(2) GIC_TAPS(3) GIC_TAPS(4)
            GIC_TAPS(5) GIC_TAPS(6) GIC_TAPS(7) GIC_TAPS(8)
#undef GIC_TAPS
          }
        }
#undef GIC_SLAB
      }
      __syncthreads();  // the slab's buffer may be refilled
    }

    // d_emb of the block's columns in this window: the warps'
    // accumulators in warp order; neighbouring threads on neighbouring
    // (column, e), so a row's stores are contiguous.  The time padding
    // rows (t >= L) are written with the first window.
    for (int e = tid; e < Lp * E2; e += CB_NT) {
      const int t = e / E2, c = e - t * E2;
      const int qi = eds == 1 ? c : c / eds, e2 = c - qi * eds;
      const int q = q0 + qi, p = t * eds + e2 - r0;
      if (q >= Q || (t < L ? (unsigned)p >= (unsigned)rw
                           : accumulate || r0 > 0))
        continue;
      float s = 0.f;
      if (t < L) {
        const float* ap = acc + p * CB_QB + qi;
        s = ap[0];
#pragma unroll
        for (int w = 1; w < CB_WARPS; ++w) s += ap[(size_t)w * rw * CB_QB];
      }
      int b = b0, r = c0 + qi;
      if (r >= R) {  // the tile runs into the next batch rows
        b += r / R;
        r %= R;
      }
      float* out = d_emb + ((size_t)b * Lp + t) * E + r * eds + e2;
      *out = accumulate ? *out + s : s;
    }
    __syncthreads();  // the accumulators are read before the next window
  }
}

// part [nblk][M] summed over blocks into dW (slots k*F + g → dw[g*ldw + k])
// and, past ldw*F, db: block ranges of ceil(nblk / CB_RD_S) in order by
// one thread each, then the ranges in order.
__global__ void __launch_bounds__(CB_RD_NT) conv_bwd_reduce_kernel(
    const float* __restrict__ part, int nblk, int M, int F, int ldw,
    float* __restrict__ dw, float* __restrict__ db) {
  __shared__ float red[CB_RD_S][CB_RD_O];
  const int ol = threadIdx.x % CB_RD_O, r = threadIdx.x / CB_RD_O;
  const int o = blockIdx.x * CB_RD_O + ol;
  const int per = (nblk + CB_RD_S - 1) / CB_RD_S;
  const int b1 = min(nblk, (r + 1) * per);
  float v = 0.f;
  if (o < M) {
#pragma unroll 8
    for (int b = r * per; b < b1; ++b) v += part[(size_t)b * M + o];
  }
  red[r][ol] = v;
  __syncthreads();
  if (r != 0 || o >= M) return;
  float s = red[0][ol];
#pragma unroll
  for (int i = 1; i < CB_RD_S; ++i) s += red[i][ol];
  if (o < ldw * F)
    dw[(size_t)(o % F) * ldw + o / F] = s;
  else
    db[o - ldw * F] = s;
}

// The rows of a column a launch accumulates at once: all L*eds where the
// 16 warps' accumulators fit beside the input rows and the ring in
// CB_SMEM_LIMIT bytes, else the fewest equal windows that fit (0: none
// fits).
int cb_window(int L, int eds, int ldw, bool mask) {
  const long rows = (long)L * eds;
  const long room =
      ((long)(CB_SMEM_LIMIT / sizeof(float)) - CB_QB * odd((int)rows) -
       (long)CB_STAGES * cb_stage(ldw, mask)) /
      (CB_WARPS * CB_QB);
  if (room < 1) return 0;
  const long windows = (rows + room - 1) / room;
  return (int)((rows + windows - 1) / windows);
}

size_t conv_bwd_smem(int L, int eds, int ldw, int rw, bool mask) {
  return sizeof(float) *
         ((size_t)CB_QB * odd(L * eds) + (size_t)CB_WARPS * rw * CB_QB +
          (size_t)CB_STAGES * cb_stage(ldw, mask));
}

// ---- The DXS backward (conv_dxs_kernel, gic_conv_dxs): every bank of a
// pass in one launch at the training width, then conv_bwd_reduce_kernel.
// float32.  Per bank (n filters of f taps, taps = f*eds, lv = L - f + 1),
// from the argmax rows idx [Q, n] and the raw pooled gradient d_pooled,
// masked by pooled > 0 in the launch (dp), with db:
//   DXS[t, q, k] = sum_n [idx[q, n] == t] * dp[q, n] * w[n, k]   [lv, Q, taps]
//   dW[n, k]     = sum_q x_q[idx[q, n]*eds + k] * dp[q, n]
//   db[n]        = sum_q dp[q, n]
//
// What bounds it.  idx, d_pooled and pooled are read once (44.2 MB at the
// training width: B = R = 64, eds = 1, L = 36, banks 3/4/5 x 300) and DXS
// written once (6.5 MB): bound by bytes, about 0.015 ms at 3.35 TB/s.  The work is 2*taps FMAs a (column, filter).
//
// What this design does about it.
//   * A block owns DX_QB = 32 columns, a lane each, of every bank of its
//     launch.  Its work items are the (bank, tap) pairs (12 at the
//     training width), a warp each (round robin past DX_MAX_WARPS): an
//     item owns its accumulator acc[t][lane] (lv rows of 32 columns), so
//     no two threads ever add into one float and every sum runs over the
//     filters in order: no atomics, and two calls are bit-equal.  An item
//     adds one FMA per (column, filter), where a warp per filter slice
//     would need a copy of every accumulator per warp and a combine.
//   * idx, d and pooled stream through shared memory in steps of DX_SF
//     = 32 filters of every bank of the launch (so that every item has
//     work in every step), 16-byte cp.async copies into a DX_STAGES-deep
//     ring, two steps ahead; the taps of the step's filters come too.
//     Rows are DX_SLD = 36 floats (9 chunks of 16 bytes), so the lanes'
//     16-byte reads of one chunk each (4 filters) are free of bank
//     conflicts.  The columns' input rows sit in shared memory as
//     xs[row][32], so a lane's read of its column at any row is
//     conflict-free; so are the accumulators.
//   * An item takes its filters four at a time: the four accumulator rows
//     are read together and a filter that hits the row of an earlier one
//     of the four adds to that one's sum, so the rows' read-modify-writes
//     do not wait on each other (each row still sums in filter order).
//   * dW: each lane forms its column's product x * dp for the step's 32
//     filters in registers; a butterfly of 31 shuffles sums them over the
//     lanes and leaves filter j's sum in lane j, which writes the block's
//     partial (and, on the bank's tap 0, db and the zero slots past its
//     taps).  conv_bwd_reduce_kernel then sums the partials over blocks in
//     block order into dw [F, ldw] and db.
//   * At the end the block writes each bank's DXS rows [t][q0, q0 + 32)
//     [taps] from the accumulators, zeros included, in 16-byte stores
//     where the run is aligned.
//   * The accumulators take sum(taps * lv) * 32 floats (50 KB at the
//     training width).  Where a launch's items do not fit beside the ring
//     in the card's shared memory, the plan (disc_conv.conv_dxs_plan)
//     splits the (bank, tap) items over several launches; each writes its
//     own slots of the partials, and one reduction follows them all.
// What holds it now (config3, H100): the stream of idx, d and pooled, 128
// bytes of a row at a time, does not run at the memory's rate, and the
// items' work (most of it the dW butterflies) does not hide behind it.
// A deeper ring, 64-filter steps and two warps an item (halves of a step,
// two accumulator copies) were no faster; PERF.md gives the times.

constexpr int DX_QB = 32, DX_SF = 32, DX_SLD = DX_SF + 4, DX_STAGES = 3;
constexpr int DX_AHEAD = DX_STAGES - 1, DX_MAX_SEGS = 8, DX_MAX_WARPS = 16;
static_assert(DX_QB == 32 && DX_SF == 32,
              "a lane per column; the dW butterfly sums 32 filters");

// One segment of a launch: bank `bank`'s taps [k0, k1).  item0: its first
// item in the launch's order; acc0: the float offset of its accumulators
// (one of lv*32 + 1 floats per tap); idx [Q, n]; d and pooled row q at
// q*ldd; dxs [lv, Q, taps].
struct DxsSeg {
  int n, f, off, ldd, k0, k1, item0, acc0;
  const int32_t* idx;
  const float* d;
  const float* pooled;
  float* dxs;
};

struct DxsLaunch {
  DxsSeg s[DX_MAX_SEGS];
  int count, items, steps;
};

// Floats of one bank's share of a ring stage: idx, d and pooled
// [DX_QB][DX_SLD], then the step's taps [DX_SF][ldw] (16-byte aligned).
__host__ __device__ inline int dxs_stage(int ldw) {
  return 3 * DX_QB * DX_SLD + ((DX_SF * ldw + 3) & ~3);
}

__host__ __device__ inline int dxs_item_floats(int L, int f) {
  return (L - f + 1) * DX_QB + 1;
}

// Step `step`'s slab of every segment's bank into `buf` ([count][stage]):
// columns past Q and filters past the bank's count are zeros.
__device__ __forceinline__ void dxs_stage_step(
    float* buf, const DxsLaunch& ln, const float* __restrict__ w_all, int ldw,
    int stage, int step, int q0, int Q) {
  const int nn0 = step * DX_SF;
  for (int sg = 0; sg < ln.count; ++sg) {
    const DxsSeg& b = ln.s[sg];
    if (nn0 >= b.n) continue;
    const int cnt = min(DX_SF, b.n - nn0);
    float* base = buf + sg * stage;
    int* si = reinterpret_cast<int*>(base);
    float* sd = base + DX_QB * DX_SLD;
    float* sp = sd + DX_QB * DX_SLD;
    float* sw = base + 3 * DX_QB * DX_SLD;
    const int32_t* idx = b.idx + nn0;
    const float* d = b.d + nn0;
    const float* p = b.pooled + nn0;
    const bool vec = ((b.n | b.ldd) & 3) == 0 && aligned16(idx) &&
                     aligned16(d) && aligned16(p);
    for (int e = threadIdx.x; e < DX_QB * DX_SF / 4; e += blockDim.x) {
      const int r = e / (DX_SF / 4), gl = e % (DX_SF / 4) * 4, q = q0 + r;
      const int o = r * DX_SLD + gl;
      const size_t oi = (size_t)q * b.n + gl, od = (size_t)q * b.ldd + gl;
      if (vec && q < Q && gl + 4 <= cnt) {
        cp_async16(si + o, idx + oi);
        cp_async16(sd + o, d + od);
        cp_async16(sp + o, p + od);
        continue;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (q < Q && gl + i < cnt) {
          cp_async4(si + o + i, idx + oi + i);
          cp_async4(sd + o + i, d + od + i);
          cp_async4(sp + o + i, p + od + i);
        } else {
          si[o + i] = 0;
          sd[o + i] = 0.f;
          sp[o + i] = 0.f;
        }
      }
    }
    const float* w = w_all + (size_t)(b.off + nn0) * ldw;
    for (int e = threadIdx.x; e < cnt * ldw; e += blockDim.x)
      cp_async4(sw + e, w + e);
  }
}

// One stage of lane_sums: lanes with bit S set keep the upper half of v,
// the others the lower half, each adding its partner's copy.
template <int S>
__device__ __forceinline__ void lane_fold(float (&v)[32], int lane) {
  const bool up = (lane & S) != 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float send = up ? v[i] : v[i + S];
    const float keep = up ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// v[j] summed over the warp's lanes in a fixed order (a butterfly of 31
// shuffles); lane j gets the sum of v[j].
__device__ __forceinline__ float lane_sums(float (&v)[32], int lane) {
  lane_fold<16>(v, lane);
  lane_fold<8>(v, lane);
  lane_fold<4>(v, lane);
  lane_fold<2>(v, lane);
  lane_fold<1>(v, lane);
  return v[0];
}

// Item (segment b, tap k) on one step: each of the step's filters in
// order adds its tap into the accumulator row of its argmax step, a lane
// per column; then the step's dW (and, on tap 0, db) partials.  Four
// filters at a time: their four rows are read together, and a filter
// whose row an earlier one of the four also hits adds to that one's sum,
// so each row still takes its filters in order, one FMA each.
__device__ __forceinline__ void dxs_item(
    const float* base, const DxsSeg& b, int k, int step, const float* xs,
    float* acc, int L, int eds, int ldw, int F, float* __restrict__ pb,
    int lane) {
  const int nn0 = step * DX_SF;
  if (nn0 >= b.n) return;  // warp-uniform
  const int cnt = min(DX_SF, b.n - nn0), taps = b.f * eds;
  const unsigned lv = L - b.f + 1;
  const int* si = reinterpret_cast<const int*>(base) + lane * DX_SLD;
  const float* sd = base + DX_QB * DX_SLD + lane * DX_SLD;
  const float* sp = sd + DX_QB * DX_SLD;
  const float* sw = base + 3 * DX_QB * DX_SLD + k;
  float* a = acc + b.acc0 + (k - b.k0) * dxs_item_floats(L, b.f) + lane;
  const float* x = xs + k * DX_QB + lane;
  float pv[DX_SF];
#pragma unroll
  for (int h = 0; h < DX_SF; h += 4) {
    const int4 t4 = *reinterpret_cast<const int4*>(si + h);
    const float4 d4 = *reinterpret_cast<const float4*>(sd + h);
    const float4 p4 = *reinterpret_cast<const float4*>(sp + h);
    const unsigned tv[4] = {(unsigned)t4.x, (unsigned)t4.y, (unsigned)t4.z,
                            (unsigned)t4.w};
    const float dd[4] = {masked<true>(d4.x, p4.x), masked<true>(d4.y, p4.y),
                         masked<true>(d4.z, p4.z), masked<true>(d4.w, p4.w)};
    bool ok[4];
    float dp[4], av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ok[i] = h + i < cnt && tv[i] < lv;
      dp[i] = ok[i] ? dd[i] : 0.f;
      av[i] = ok[i] ? a[tv[i] * DX_QB] : 0.f;
      pv[h + i] = ok[i] ? x[tv[i] * eds * DX_QB] * dp[i] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < i; ++e)  // the latest earlier filter on the row
        if (ok[e] && tv[e] == tv[i]) av[i] = av[e];
      av[i] = fmaf(sw[(h + i) * ldw], dp[i], av[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)  // in order: the last write of a row wins
      if (ok[i]) a[tv[i] * DX_QB] = av[i];
  }
  const int g = b.off + nn0 + lane;
  const float s = lane_sums(pv, lane);
  if (lane < cnt) pb[(size_t)k * F + g] = s;
  if (k != 0) return;
  // the bank's own slots: zero taps past its width, and db
  if (lane < cnt)
    for (int kk = taps; kk < ldw; ++kk) pb[(size_t)kk * F + g] = 0.f;
#pragma unroll
  for (int h = 0; h < DX_SF; h += 4) {
    const float4 d4 = *reinterpret_cast<const float4*>(sd + h);
    const float4 p4 = *reinterpret_cast<const float4*>(sp + h);
    const float dd[4] = {masked<true>(d4.x, p4.x), masked<true>(d4.y, p4.y),
                         masked<true>(d4.z, p4.z), masked<true>(d4.w, p4.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[h + i] = h + i < cnt ? dd[i] : 0.f;
  }
  const float sb = lane_sums(pv, lane);
  if (lane < cnt) pb[(size_t)ldw * F + g] = sb;
}

// One launch: blockIdx.x owns columns [32*blockIdx.x, +32) of every
// segment of `ln`.  part [gridDim.x][ldw*F + F]: the launch
// writes the slots of its items (dW (k, g) of its taps; on a bank's tap 0
// also the zero taps and db).
__global__ void __launch_bounds__(32 * DX_MAX_WARPS) conv_dxs_kernel(
    const float* __restrict__ emb, const float* __restrict__ w_all, int ldw,
    int Q, int Lp, int R, int eds, int L, int F, DxsLaunch ln,
    float* __restrict__ part) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  const int stage = dxs_stage(ldw), rows = L * eds, E = R * eds;
  float* ring = reinterpret_cast<float*>(smem4);  // [DX_STAGES][count][stage]
  float* xs = ring + DX_STAGES * ln.count * stage;  // [rows][DX_QB]
  float* acc = xs + rows * DX_QB;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nw = blockDim.x / 32, q0 = blockIdx.x * DX_QB;
  float* pb = part + (size_t)blockIdx.x * ((size_t)ldw * F + F);

  for (int s = 0; s < DX_AHEAD; ++s) {
    if (s < ln.steps)
      dxs_stage_step(ring + s * ln.count * stage, ln, w_all, ldw, stage,
                           s, q0, Q);
    cp_async_commit();
  }
  for (int e = tid; e < rows * DX_QB; e += blockDim.x) {
    const int c = e % DX_QB, p = e / DX_QB, q = q0 + c;
    xs[e] = q < Q ? emb[((size_t)(q / R) * Lp + p / eds) * E + (q % R) * eds +
                        p % eds]
                  : 0.f;
  }
  const DxsSeg& last = ln.s[ln.count - 1];
  const int acc_floats =
      last.acc0 + (last.k1 - last.k0) * dxs_item_floats(L, last.f);
  for (int e = tid; e < acc_floats; e += blockDim.x) acc[e] = 0.f;

  for (int s = 0; s < ln.steps; ++s) {
    const int pre = s + DX_AHEAD;  // into the buffer read at s - 1
    if (pre < ln.steps)
      dxs_stage_step(ring + (pre % DX_STAGES) * ln.count * stage, ln,
                           w_all, ldw, stage, pre, q0, Q);
    cp_async_commit();
    cp_async_wait<DX_AHEAD>();
    __syncthreads();  // step s is in every view
    const float* buf = ring + (s % DX_STAGES) * ln.count * stage;
    for (int it = warp; it < ln.items; it += nw) {
      int sg = 0;
      while (sg + 1 < ln.count && it >= ln.s[sg + 1].item0) ++sg;
      const DxsSeg& b = ln.s[sg];
      dxs_item(buf + sg * stage, b, b.k0 + it - b.item0, s, xs, acc, L,
                     eds, ldw, F, pb, lane);
    }
    __syncthreads();  // the step's buffer may be refilled
  }

  // each segment's DXS rows of the block's columns, [t][q0 + c][k] with
  // neighbouring threads on neighbouring floats; 16-byte stores where a
  // bank's whole row run is aligned
  const int cols = min(DX_QB, Q - q0);
  for (int sg = 0; sg < ln.count; ++sg) {
    const DxsSeg& b = ln.s[sg];
    const int taps = b.f * eds, lv = L - b.f + 1, span = b.k1 - b.k0;
    const int item = dxs_item_floats(L, b.f), run = cols * span;
    const float* ab = acc + b.acc0;
    const bool vec = span == taps && run % 4 == 0 &&
                     ((size_t)Q * taps) % 4 == 0 && (q0 * taps) % 4 == 0 &&
                     aligned16(b.dxs);
    if (vec) {
      const int r4 = run / 4;
      for (int e = tid; e < lv * r4; e += blockDim.x) {
        const int t = e / r4, c4 = (e - t * r4) * 4;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = (c4 + i) / taps, k = c4 + i - c * taps;
          v[i] = ab[k * item + t * DX_QB + c];
        }
        *reinterpret_cast<float4*>(b.dxs + ((size_t)t * Q + q0) * taps + c4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
      for (int e = tid; e < lv * run; e += blockDim.x) {
        const int t = e / run, r = e - t * run, c = r / span, k = r - c * span;
        b.dxs[((size_t)t * Q + q0 + c) * taps + b.k0 + k] =
            ab[k * item + t * DX_QB + c];
      }
    }
  }
}

size_t dxs_smem(int L, int eds, int ldw, int segs, int acc_floats) {
  return sizeof(float) * ((size_t)DX_STAGES * segs * dxs_stage(ldw) +
                          (size_t)L * eds * DX_QB + acc_floats);
}

}  // namespace

extern "C" {

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The forward of up to FW_MAX_BANKS banks in one launch on `stream`
// (the wrapper's plan, disc_conv.conv_fwd_plan).  emb [Bn, Lp, R*eds];
// w_all [F, ldw], b_all [F]; per bank i, bank_ints[4i..4i+3] = (n, f,
// first row, first filter tile) and idx[i] [Bn*R, n]; pooled [Bn*R, ldp]
// (each bank's columns from its first row).  filter_tiles and smem_bytes
// are the plan's; a launch they do not match is refused
// (cudaErrorInvalidValue).
int gic_conv_fwd(const float* emb, const float* w_all, int ldw,
                 const float* b_all, int Bn, int Lp, int R, int eds, int L,
                 int n_banks, const int* bank_ints, void* const* idx,
                 int filter_tiles, int smem_bytes, float* pooled, int ldp,
                 void* stream) {
  if (n_banks < 1 || n_banks > FW_MAX_BANKS) return cudaErrorInvalidValue;
  FwdBanks banks;
  banks.count = n_banks;
  int tiles = 0, gen_taps = 0;
  for (int i = 0; i < n_banks; ++i) {
    const int* bi = bank_ints + 4 * i;
    banks.n[i] = bi[0];
    banks.f[i] = bi[1];
    banks.off[i] = bi[2];
    banks.tile0[i] = bi[3];
    banks.idx[i] = static_cast<int32_t*>(idx[i]);
    if (bi[3] != tiles || bi[0] < 1 || bi[1] < 1 || bi[1] > L)
      return cudaErrorInvalidValue;
    tiles += (bi[0] + FW_NB - 1) / FW_NB;
    if (bi[1] * eds > FW_MAXT && bi[1] * eds > gen_taps) gen_taps = bi[1] * eds;
  }
  banks.tile0[n_banks] = tiles;
  const size_t smem = fwd_smem(L, eds, gen_taps);
  if (tiles != filter_tiles || smem != (size_t)smem_bytes)
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)conv_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const int Q = Bn * R;
  const dim3 grid((Q + FW_QB - 1) / FW_QB, tiles);
  conv_fwd_kernel<<<grid, FW_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      emb, w_all, ldw, b_all, Q, Lp, R, eds, L, banks, pooled, ldp);
  return cudaGetLastError();
}

// The backward of every bank of a pass on `stream`: one conv_bwd_kernel
// launch per CB_MAX_BANKS banks (one at the training width), then the
// fixed-order reduction of the dW (and db) partials.  Per bank i,
// bank_ints[4i..4i+3] = (n, f, first row of w_all, row stride of d[i] /
// pooled[i]) and idx[i] [Bn*R, n].  mask = 0: d[i] is bank i's masked
// pooled gradient [Bn*R, n]; mask = 1: d[i] and pooled[i] are bank i's
// first column of the [Bn*R, F] d_pooled and pooled, masked in the launch,
// and db [F] is written.  part: scratch of part_floats floats.  Writes
// every entry of d_emb [Bn, Lp, R*eds], dw [F, ldw] (zero past a bank's
// taps) and db.  slabs and part_floats are the wrapper's plan
// (disc_conv.conv_bwd_plan); a call they do not match, or whose rows leave
// no shared memory for one row of accumulators, is refused
// (cudaErrorInvalidValue).
int gic_conv_bwd(const float* emb, const float* w_all, int ldw, int Bn,
                 int Lp, int R, int eds, int L, int n_banks,
                 const int* bank_ints, void* const* idx, void* const* d,
                 void* const* pooled, int mask, int slabs, size_t part_floats,
                 float* d_emb, float* part, float* dw, float* db,
                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_banks < 1 || (mask && !db)) return cudaErrorInvalidValue;
  int F = 0, total = 0;
  for (int i = 0; i < n_banks; ++i) {
    const int* bi = bank_ints + 4 * i;
    if (bi[0] < 1 || bi[1] < 1 || bi[1] > L || bi[1] * eds > ldw ||
        bi[2] != F || bi[3] < bi[0])
      return cudaErrorInvalidValue;
    F += bi[0];
    total += (bi[0] + CB_SF - 1) / CB_SF;
  }
  const int Q = Bn * R, nblk = (Q + CB_QB - 1) / CB_QB;
  const int M = ldw * F + (mask ? F : 0);
  const int rw = cb_window(L, eds, ldw, mask != 0);
  if (rw < 1 || total != slabs || part_floats != (size_t)nblk * M)
    return cudaErrorInvalidValue;
  const size_t smem = conv_bwd_smem(L, eds, ldw, rw, mask != 0);
  const void* kern = mask ? (const void*)conv_bwd_kernel<true>
                          : (const void*)conv_bwd_kernel<false>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  for (int g0 = 0; g0 < n_banks; g0 += CB_MAX_BANKS) {
    BwdBanks bk;
    bk.count = min(CB_MAX_BANKS, n_banks - g0);
    bk.slab0[0] = 0;
    for (int i = 0; i < bk.count; ++i) {
      const int* bi = bank_ints + 4 * (g0 + i);
      bk.n[i] = bi[0];
      bk.f[i] = bi[1];
      bk.off[i] = bi[2];
      bk.ldd[i] = bi[3];
      bk.slab0[i + 1] = bk.slab0[i] + (bi[0] + CB_SF - 1) / CB_SF;
      bk.idx[i] = static_cast<const int32_t*>(idx[g0 + i]);
      bk.d[i] = static_cast<const float*>(d[g0 + i]);
      bk.pooled[i] = mask ? static_cast<const float*>(pooled[g0 + i])
                          : nullptr;
    }
    if (mask)
      conv_bwd_kernel<true><<<nblk, CB_NT, smem, st>>>(
          emb, w_all, ldw, Q, Lp, R, eds, L, F, bk, g0 > 0, rw, d_emb,
          part);
    else
      conv_bwd_kernel<false><<<nblk, CB_NT, smem, st>>>(
          emb, w_all, ldw, Q, Lp, R, eds, L, F, bk, g0 > 0, rw, d_emb,
          part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  conv_bwd_reduce_kernel<<<(M + CB_RD_O - 1) / CB_RD_O, CB_RD_NT, 0, st>>>(
      part, nblk, M, F, ldw, dw, db);
  return cudaGetLastError();
}

// The DXS backward of every bank of a pass on `stream` (the wrapper's plan,
// disc_conv.conv_dxs_plan): one conv_dxs_kernel launch per group of (bank,
// tap) items (one at the training width), then the fixed-order reduction
// of the dW (and db) partials.  Per bank i, bank_ints[4i..4i+3] = (n, f,
// first row of w_all, row stride of d[i] / pooled[i]), idx[i] [Bn*R, n]
// and dxs[i] [L - f + 1, Bn*R, f*eds]; d[i] the raw pooled gradient and
// pooled[i] the pooled features (same layout): the ReLU mask and db are in
// the launch.  launch_ints:
// per launch (segments, shared-memory bytes), then per segment (bank,
// first tap, end tap).  Writes every entry of each dxs[i], dw [F, ldw]
// (zero past a bank's taps) and db [F].  The segments must
// cover every (bank, tap) once and in order, a bank at most once a launch,
// and the bytes must be the ones this side computes; a call that does not
// match, or whose part_floats are not the partials' blocks x slots, is
// refused (cudaErrorInvalidValue) before anything is launched.
int gic_conv_dxs(const float* emb, const float* w_all, int ldw, int Bn,
                 int Lp, int R, int eds, int L, int n_banks,
                 const int* bank_ints, void* const* idx, void* const* d,
                 void* const* pooled, int n_launches,
                 const int* launch_ints, size_t part_floats,
                 void* const* dxs, float* part, float* dw, float* db,
                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_banks < 1 || n_launches < 1 || !pooled || !db)
    return cudaErrorInvalidValue;
  int F = 0;
  for (int i = 0; i < n_banks; ++i) {
    const int* bi = bank_ints + 4 * i;
    if (bi[0] < 1 || bi[1] < 1 || bi[1] > L || bi[1] * eds > ldw ||
        bi[2] != F || bi[3] < bi[0])
      return cudaErrorInvalidValue;
    F += bi[0];
  }
  const int Q = Bn * R, nblk = (Q + DX_QB - 1) / DX_QB;
  const size_t M = (size_t)ldw * F + F;
  if (Q < 1 || part_floats != (size_t)nblk * M) return cudaErrorInvalidValue;
  std::vector<DxsLaunch> launches(n_launches);
  size_t smem_max = 0;
  int bank = 0, k = 0;  // the next (bank, tap) to cover
  const int* li = launch_ints;
  for (int l = 0; l < n_launches; ++l) {
    const int count = li[0];
    if (count < 1 || count > DX_MAX_SEGS) return cudaErrorInvalidValue;
    DxsLaunch& ln = launches[l];
    ln.count = count;
    ln.items = ln.steps = 0;
    int acc = 0;
    for (int sg = 0; sg < count; ++sg) {
      const int* si = li + 2 + 3 * sg;
      const int b = si[0], k0 = si[1], k1 = si[2];
      if (b != bank || k0 != k || b >= n_banks || (sg > 0 && k0 != 0))
        return cudaErrorInvalidValue;
      const int* bi = bank_ints + 4 * b;
      const int taps = bi[1] * eds;
      if (k1 <= k0 || k1 > taps) return cudaErrorInvalidValue;
      DxsSeg& s = ln.s[sg];
      s.n = bi[0];
      s.f = bi[1];
      s.off = bi[2];
      s.ldd = bi[3];
      s.k0 = k0;
      s.k1 = k1;
      s.item0 = ln.items;
      s.acc0 = acc;
      s.idx = static_cast<const int32_t*>(idx[b]);
      s.d = static_cast<const float*>(d[b]);
      s.pooled = static_cast<const float*>(pooled[b]);
      s.dxs = static_cast<float*>(dxs[b]);
      ln.items += k1 - k0;
      acc += (k1 - k0) * dxs_item_floats(L, bi[1]);
      ln.steps = max(ln.steps, (bi[0] + DX_SF - 1) / DX_SF);
      if (k1 == taps) {
        ++bank;
        k = 0;
      } else if (sg + 1 < count) {
        return cudaErrorInvalidValue;  // a bank's taps split inside a launch
      } else {
        k = k1;
      }
    }
    const size_t smem = dxs_smem(L, eds, ldw, count, acc);
    if (smem != (size_t)li[1] || smem > CB_SMEM_LIMIT)
      return cudaErrorInvalidValue;
    smem_max = smem > smem_max ? smem : smem_max;
    li += 2 + 3 * count;
  }
  if (bank != n_banks) return cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)conv_dxs_kernel, smem_max);
  if (err != cudaSuccess) return err;
  li = launch_ints;
  for (const DxsLaunch& ln : launches) {
    const size_t smem = (size_t)li[1];
    li += 2 + 3 * ln.count;
    const int threads = 32 * min(DX_MAX_WARPS, ln.items);
    conv_dxs_kernel<<<nblk, threads, smem, st>>>(emb, w_all, ldw, Q, Lp, R,
                                                 eds, L, F, ln, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  conv_bwd_reduce_kernel<<<(M + CB_RD_O - 1) / CB_RD_O, CB_RD_NT, 0, st>>>(
      part, nblk, (int)M, F, ldw, dw, db);
  return cudaGetLastError();
}

}  // extern "C"
