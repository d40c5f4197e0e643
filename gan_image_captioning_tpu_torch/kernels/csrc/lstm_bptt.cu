// LSTM backward recurrences for Hopper (sm_90a), float32: the stacked
// chain of the decode backward and the single-layer reverse loop of the
// teacher-forced pass.
//
// gic_lstm_bptt_chain replaces gan_image_captioning_tpu/kernels/
// lstm_bptt.py, function `_chain_kernel` (launched by `lstm_bptt_chain`).
// For t = T-1 .. 0 and,
// inside each step, l = NL-1 .. 0 (the upper layer first, because it feeds
// the lower one in the same step):
//   dh = dh_carry[l] + (l == NL-1 ? d_hs[t] : dx_upper)
//   i, f, g, o = act(gates[t, l]) ;  tc = tanh(cs[t, l])
//   do = dh*tc*o*(1-o) ;  dc = dc_carry[l] + dh*o*(1-tc^2)
//   di = dc*g*i*(1-i) ;  df = dc*c_prev*f*(1-f) ;  dg = dc*i*(1-g^2)
//   d_pre[t, l] = [di | df | dg | do]   (c_prev = cs[t-1, l], 0 at t = 0)
//   dc_carry[l] = dc*f ;  dh_carry[l] = d_pre[t, l] @ w_hhs[l]^T
//   dx_upper = d_pre[t, l] @ w_ihs_upper[l-1]^T          (l > 0)
// with w_hhs [NL, H, 4H] and w_ihs_upper [NL-1, H, 4H] the transposed
// torch-layout weights, as the TPU kernel takes them.
//
// What bounds it on this card.  At the training width (H = 512, NL = 2,
// T = 36, B = 64) the products are T*(2*NL-1) of [B, 4H] x [4H, H]:
// 14.5 GFLOP, 0.22 ms at float32's 67 TFLOP/s; the bytes (gates, c,
// d_hs and d_pre once, each weight once: about 102 MB) take 0.03 ms.  The
// recurrence is sequential: T*NL dependent layer-steps.
//
// What this design does about it: one persistent kernel, one cooperative
// launch per call (persistent.cuh), the reverse kernel's structure with
// the inter-layer term.  A block per SM owns hidden units [j0, j0 + upb)
// (upb a power of two, at most 8) in every layer:
//   * its (dh, dc) carries of all NL layers and its slice of dx_upper stay
//     in shared memory for the whole call;
//   * its rows of w_hhs[l] and of w_ihs_upper[l-1] stay in shared memory
//     when they fit (config3: 3 slices x 4 rows x 2052 floats = 98.5 KB
//     beside a 3-slot K-tile pool of 101 KB), else they are read from
//     global memory into the K-tile stage each step (a 5-slot pool in the
//     room they leave), the same arithmetic; where both fit, resident
//     measured 3 % faster on the card (PERF.md);
//   * the block that owns unit j owns row j of w_ihs_upper[l-1], so
//     dx_upper[:, j] is computed and consumed by the same block.
// Per layer-step (t = T-1 .. 0, l = NL-1 .. 0): the gate gradients of the
// block's units, written to d_pre[t, l]; one grid barrier (NL per step);
// then the products of d_pre[t, l] (staged in K tiles through L2 by
// cp.async) with the block's weight rows: w_hhs[l] into the dh carry and,
// for l > 0, w_ihs_upper[l-1] into dx_upper in the same pass, so one
// staged element feeds both.  The product is register-tiled for shared
// memory, which bounded the reverse kernel (a 128-bit shared load costs a
// warp 4 cycles): a warp owns 8 batch rows, a lane the float4 chunks
// lane, lane + 32, ... of K, and accumulates 8 rows x NC weight rows
// (NC = 8 at config3: 16 loads per 256 FMAs, against the reverse's 5
// per 16); the 32 lanes' partial sums meet by a warp shuffle
// reduce-scatter, and warps that split K at a small batch add theirs in
// shared memory.  The chain is held by tolerance (1e-4 of the largest
// d_pre), so K is split; the arithmetic stays float32 FMA.  The product
// of t = 0, l = 0 is skipped: nothing reads that carry.  What bounds it
// now (PERF.md): every block stages all of d_pre[t, l] (512 KB at
// config3) from L2 each layer-step, about 128 MB a step.
//
// gic_bptt_reverse replaces the same file's `_kernel` (launched by
// `lstm_bptt_reverse`; caller `models/lstm.py:_layer_seq_bwd`): one layer's
// reverse loop, the chain's step with NL = 1, no inter-layer input and the
// cell state entering each step read from c_prev [T, B, H] (so a non-zero
// initial state works); the carries start at zero and leave as (dh0, dc0).
// At the training width (H = 512, T = 36, B = 64) its T products of
// [B, 4H] x [4H, H] are 4.8 GFLOP, 0.072 ms at 67 TFLOP/s, against about
// 56 MB of bytes (0.017 ms): bound by operations.  Two launches per step
// (the chain's kernels) spent about 50 us a step on launch latency and on
// re-reading w_hh through small K tiles.  So it is one persistent kernel
// (persistent.cuh), one cooperative launch per call, the TPU kernel's
// design: a block per SM owns hidden units [j0, j0 + upb), keeps their
// rows of w_hh [H, 4H] in shared memory for the whole call (H = 512:
// 4 units, 32 KB; read from global memory each step into the K-tile stage
// when they do not fit) and their (dh, dc) carries in shared memory.  Per
// step, t = T-1 .. 0: the gate gradients of its units from its own
// carries, written to d_pre[t]; one grid barrier; then its units' dh
// carry = d_pre[t] @ w_hh[j]^T over all B rows, d_pre[t] staged in K
// tiles through L2 by cp.async.  The next step needs only the block's own carries, so
// one barrier per step.  The reverse is held by tolerance, so each product
// is split four ways along K inside the block (a thread owns a batch row
// and a quarter of the K chunks of every unit: the staged row is read once
// for all units), the partial sums added in shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "persistent.cuh"
#include "tile_dot.cuh"

namespace {

using gic::sigmoidf;

constexpr int R_MAX_UNITS = 16;
constexpr int R_SLOT = 64 * (128 + 4);  // floats of one pipeline slot
constexpr int R_DEPTH = 4;                 // slots in the pool
constexpr int R_POOL = R_DEPTH * R_SLOT;
constexpr int R_SPLIT = 4;  // K split of each product inside the block

// Phase clocks of block 0 (clock64 cycles, summed over the call) when the
// caller asked for them (gic_reverse_set_profile).
enum { RPROF_LOAD, RPROF_GATES, RPROF_BARRIER, RPROF_PRODUCT, RPROF_SLOTS };

// The inputs are W (float, or bfloat16 for the bfloat16 instantiation:
// the TPU kernel's caller casts them all to float32 in the kernel's
// prologue, so each element is widened as it is read); the outputs are
// float32 in both.
struct ReverseParams {
  const void* w_hh;     // [H, 4H]
  const void* d_hs;     // [T, B, H]
  const void* gates;    // [T, B, 4H]
  const void* c_prev;   // [T, B, H]
  const void* cs;       // [T, B, H]
  float* dh;            // [B, H] out: dh0
  float* dc;            // [B, H] out: dc0
  float* d_pre;         // [T, B, 4H] out
  unsigned int* barrier;
  unsigned long long* prof;  // [RPROF_SLOTS] or null
  int T, B, H, upb, resident;
};

__host__ __device__ inline size_t reverse_smem_floats(int B, int H, int upb,
                                                     int resident) {
  return R_POOL + (resident ? (size_t)upb * (gic::kpad(4 * H) + 4) : 0) +
         2 * (size_t)B * upb;
}

// Dynamic shared memory: the K-tile pool, the block's w_hh rows
// [upb][kpad(4H) + 4] when resident, then the carries dh, dc [B * upb]
// each (item e = b * upb + u).
template <class W>
__global__ void __launch_bounds__(gic::PT_NT, 1) reverse_persistent_kernel(
    ReverseParams p) {
  using namespace gic;
  const W* w_hh = static_cast<const W*>(p.w_hh);
  const W* d_hs = static_cast<const W*>(p.d_hs);
  const W* gates = static_cast<const W*>(p.gates);
  const W* c_prev = static_cast<const W*>(p.c_prev);
  const W* cs = static_cast<const W*>(p.cs);
  extern __shared__ float4 dyn_smem[];
  float* pool = reinterpret_cast<float*>(dyn_smem);
  const int B = p.B, H = p.H, K = 4 * H, upb = p.upb, tid = threadIdx.x;
  const int j0 = blockIdx.x * upb, wst = kpad(K) + 4;
  float* wres = pool + R_POOL;
  float* dh_s = wres + (p.resident ? upb * wst : 0);
  float* dc_s = dh_s + B * upb;
  const int n_own = B * upb;
  const bool timed = p.prof != nullptr && blockIdx.x == 0 && tid == 0;
  unsigned long long t0 = timed ? clock64() : 0;
  auto mark = [&](int slot) {
    if (timed) {
      const unsigned long long now = clock64();
      p.prof[slot] += now - t0;
      t0 = now;
    }
  };

  if (p.resident) {
    for (int e = tid; e < upb * wst; e += PT_NT) {
      const int u = e / wst, k = e % wst, j = j0 + u;
      wres[e] = j < H && k < K ? to_f(w_hh[(size_t)j * K + k]) : 0.f;
    }
  }
  for (int e = tid; e < n_own; e += PT_NT) dh_s[e] = dc_s[e] = 0.f;
  __syncthreads();
  mark(RPROF_LOAD);

  // a thread owns batch row bl of the chunk and the k-quarter q (float4
  // chunks m with m mod 4 = q) of every unit's product
  const int bc = min(B, PT_NT / R_SPLIT), q = tid / bc, bl = tid % bc;
  const bool active = tid < R_SPLIT * bc;
  const int kt = tile_k(p.resident ? bc : bc + upb, R_SLOT, K);
  const int ntiles = kpad(K) / kt, xfl = bc * (kt + 4);
  const Seg w_seg{p.w_hh, K, K,
                  reinterpret_cast<uintptr_t>(p.w_hh) %
                          (is_bf16<W> ? 8 : 16) ==
                      0,
                  is_bf16<W>};
  const Seg none{nullptr, 0, 0, true};
  unsigned int target = 0;
  for (int t = p.T - 1; t >= 0; --t) {
    // the gate gradients of the block's units
    for (int e = tid; e < n_own && j0 < H; e += PT_NT) {
      const int b = e / upb, j = j0 + e % upb;
      if (j >= H) continue;
      const size_t sidx = ((size_t)t * B + b) * H + j;
      const W* g = gates + ((size_t)t * B + b) * K + j;
      const float ig = sigmoidf(to_f(g[0])), fg = sigmoidf(to_f(g[H]));
      const float gg = tanhf(to_f(g[2 * H])), og = sigmoidf(to_f(g[3 * H]));
      const float dh = dh_s[e] + to_f(d_hs[sidx]);
      const float tc = tanhf(to_f(cs[sidx]));
      const float d_o = dh * tc * og * (1.f - og);
      const float dc = dc_s[e] + dh * og * (1.f - tc * tc);
      const float cp = to_f(c_prev[sidx]);
      float* dp = p.d_pre + ((size_t)t * B + b) * K + j;
      dp[0] = dc * gg * ig * (1.f - ig);
      dp[H] = dc * cp * fg * (1.f - fg);
      dp[2 * H] = dc * ig * (1.f - gg * gg);
      dp[3 * H] = d_o;
      dc_s[e] = dc * fg;
    }
    mark(RPROF_GATES);
    grid_barrier(p.barrier, target);
    mark(RPROF_BARRIER);

    // dh carry of the block's units: d_pre[t] @ w_hh[j]^T, each thread's
    // k-quarter partial sums added in shared memory afterwards
    const Seg x_seg{p.d_pre + (size_t)t * B * K, K, K, true};
    for (int b0 = 0; b0 < B && j0 < H; b0 += bc) {
      float acc[R_MAX_UNITS];
#pragma unroll
      for (int u = 0; u < R_MAX_UNITS; ++u) acc[u] = 0.f;
      k_pipeline<R_DEPTH>(
          pool, R_SLOT, ntiles,
          [&](int i, float* slot) {
            stage_rows(slot, kt, bc, RowRange{b0, B}, x_seg, K, none, i * kt);
            if (!p.resident)
              stage_rows(slot + xfl, kt, upb, RowRange{j0, H}, w_seg, K, none,
                         i * kt);
          },
          [&](int it, const float* slot) {
            if (!active) return;
            const float* wbase = p.resident ? wres + it * kt : slot + xfl;
            const int ws_row = p.resident ? wst : kt + 4;
            const float* xrow = slot + bl * (kt + 4);
            for (int kk = 4 * q; kk < kt; kk += 4 * R_SPLIT) {
              const float4 x = ld4(xrow + kk);
#pragma unroll
              for (int u = 0; u < R_MAX_UNITS; ++u) {
                if (u >= upb) break;
                const float4 w = ld4(wbase + (size_t)u * ws_row + kk);
                acc[u] = fmaf(w.x, x.x, acc[u]);
                acc[u] = fmaf(w.y, x.y, acc[u]);
                acc[u] = fmaf(w.z, x.z, acc[u]);
                acc[u] = fmaf(w.w, x.w, acc[u]);
              }
            }
          });
      // partials [R_SPLIT][bc][upb] in the (now free) pool
      if (active) {
#pragma unroll
        for (int u = 0; u < R_MAX_UNITS; ++u) {
          if (u >= upb) break;
          pool[((size_t)q * bc + bl) * upb + u] = acc[u];
        }
      }
      __syncthreads();
      for (int e = tid; e < bc * upb; e += PT_NT) {
        const int b = b0 + e / upb;
        if (b < B) {
          const float* pt = pool + e;
          const size_t qs = (size_t)bc * upb;
          dh_s[b * upb + e % upb] = (pt[0] + pt[qs]) + (pt[2 * qs] + pt[3 * qs]);
        }
      }
      __syncthreads();
    }
    mark(RPROF_PRODUCT);
  }
  for (int e = tid; e < n_own; e += PT_NT) {
    const int b = e / upb, j = j0 + e % upb;
    if (j < H) {
      p.dh[(size_t)b * H + j] = dh_s[e];
      p.dc[(size_t)b * H + j] = dc_s[e];
    }
  }
}

// ------------------------------------------------------------ the chain

// Weight rows of one product pass: a block owning more units takes them
// in passes of C_MAX_UNITS.
constexpr int C_MAX_UNITS = 8;
// The K-tile pool: 3 slots of 72 rows x 128 columns (64 rows of d_pre and,
// when the weight rows are streamed, 8 of them).
constexpr int C_SLOT = 72 * (128 + 4), C_DEPTH = 3;
constexpr int C_ROWS = 8;               // batch rows of one warp
constexpr int C_WARPS = gic::PT_NT / 32;

// gates and cs are G (float, or bfloat16 for the bfloat16 instantiation:
// the TPU kernel reads the decode's bfloat16 residuals as float32); the
// weights, d_hs and d_pre are float32 in both (the caller casts them).
struct ChainParams {
  const float* w_hhs;        // [NL, H, 4H]
  const float* w_ihs_upper;  // [NL-1, H, 4H] or null (NL = 1)
  const float* d_hs;         // [T, B, H]
  const void* gates;         // [T, NL, B, 4H]
  const void* cs;            // [T, NL, B, H]
  float* d_pre;              // [T, NL, B, 4H] out
  unsigned int* barrier;
  unsigned long long* prof;  // [RPROF_SLOTS] or null
  int T, NL, B, H, upb, resident;
  int bc;                    // batch rows of one chunk (the carries' rows)
};

__host__ __device__ inline size_t chain_smem_floats(int bc, int H, int NL,
                                                   int upb, int resident) {
  return (size_t)C_DEPTH * C_SLOT +
         (resident ? (size_t)upb * (gic::kpad(4 * H) + 4) * (2 * NL - 1)
                   : 0) +
         (size_t)(2 * NL + 1) * bc * upb;
}

// Sum over the 32 lanes of a[0..N) (N a power of two) by halving: at each
// offset O a lane keeps one half of its values and adds its partner's
// copy of that half.  Afterwards lane L holds, in a[0..max(N/32, 1)), the
// sums of the indices L * N / 32 + i (N >= 32) or L / (32 / N) (N < 32).
template <int N, int O>
__device__ __forceinline__ void reduce_scatter(float* a, int lane) {
  if constexpr (O >= 1) {
    if constexpr (N >= 2) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float lo = a[i], hi = a[i + N / 2];
        a[i] = (up ? hi : lo) +
               __shfl_xor_sync(0xffffffffu, up ? lo : hi, O);
      }
      reduce_scatter<N / 2, O / 2>(a, lane);
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], O);
      reduce_scatter<1, O / 2>(a, lane);
    }
  }
}

// The weight rows of one chain product pass: NC rows, NC / NM units of
// each of NM matrices from the block's unit u0 on, matrix 0 (w_hh[l])
// first, then matrix 1 (w_ih_upper[l-1]) where NM = 2; local unit u stands
// for global row j0 + u of its [H, 4H] matrix.
struct ChainWeights {
  const float* res[2];  // resident rows [upb][wst] of each matrix, or null
  const float* glob[2];  // the [H, 4H] matrices (streamed branch)
  float* out[2];        // the block's [B * upb] results of each matrix
};

// out_m[b * upb + u] = sum_k x[b, k] * W_m[j0 + u, k] for the NC weight
// rows of the pass over the B rows of x, a chunk of d_pre[t, l] [., 4H]
// (written by every block before the last grid barrier: staged through
// L2 only); the weight rows resident (RES) or staged with x.  RES is a
// template parameter so that the inner loop tests no branch flag: as a
// runtime flag it cost 6 % at config3 (PERF.md).
template <int NC, int NM, bool RES>
__device__ void chain_product(const ChainParams& p, const float* x, int B,
                              const ChainWeights& w, int u0, float* pool) {
  using namespace gic;
  constexpr int UP = NC / NM;  // units of each matrix in the pass
  const int H = p.H, K = 4 * H, upb = p.upb;
  const int j0 = blockIdx.x * upb, wst = kpad(K) + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Seg x_seg{x, K, K, true};
  const Seg none{nullptr, 0, 0, true};
  for (int b0 = 0; b0 < B; b0 += 64) {
    // rows staged: the chunk's rows rounded up to whole warps (zeros past B)
    const int staged = min(64, (min(B - b0, 64) + C_ROWS - 1) / C_ROWS * C_ROWS);
    const int nrg = staged / C_ROWS, kg_n = C_WARPS / nrg;
    const int rg = warp % nrg, kg = warp / nrg;
    const int kt = tile_k(RES ? staged : staged + NC, C_SLOT, K);
    const int ntiles = kpad(K) / kt, xfl = staged * (kt + 4);
    float acc[C_ROWS * NC];
#pragma unroll
    for (int i = 0; i < C_ROWS * NC; ++i) acc[i] = 0.f;
    k_pipeline<C_DEPTH>(
        pool, C_SLOT, ntiles,
        [&](int i, float* slot) {
          stage_rows(slot, kt, staged, RowRange{b0, B}, x_seg, K, none,
                     i * kt);
          if constexpr (!RES)
            for (int m = 0; m < NM; ++m)
              stage_rows(slot + xfl + m * UP * (kt + 4), kt, UP,
                         RowRange{j0 + u0, H},
                         Seg{w.glob[m], K, K,
                             reinterpret_cast<uintptr_t>(w.glob[m]) % 16 == 0},
                         K, none, i * kt);
        },
        [&](int it, const float* slot) {
          if (kg >= kg_n) return;
          const float* xb = slot + rg * C_ROWS * (kt + 4);
          for (int c = lane + 32 * kg; c < kt / 4; c += 32 * kg_n) {
            const int kk = 4 * c;
            float4 wv[NC];
#pragma unroll
            for (int n = 0; n < NC; ++n) {
              const int m = n / UP, u = u0 + n % UP;
              wv[n] = RES ? ld4(w.res[m] + (size_t)u * wst + it * kt + kk)
                          : ld4(slot + xfl + n * (kt + 4) + kk);
            }
#pragma unroll
            for (int r = 0; r < C_ROWS; ++r) {
              const float4 xv = ld4(xb + r * (kt + 4) + kk);
#pragma unroll
              for (int n = 0; n < NC; ++n)
                acc[r * NC + n] = fma4(wv[n], xv, acc[r * NC + n]);
            }
          }
        });
    // the 32 lanes' partial sums, then the k-groups' in the (free) pool:
    // part[kg][r][n] for the chunk's staged rows
    constexpr int V = C_ROWS * NC;
    reduce_scatter<V, 16>(acc, lane);
    float* part = pool;
    if (kg < kg_n) {
      constexpr int PER = V >= 32 ? V / 32 : 1;
      const bool writer = V >= 32 || lane % (32 / V) == 0;
      const int i0 = V >= 32 ? lane * PER : lane / (32 / V);
      if (writer) {
#pragma unroll
        for (int i = 0; i < PER; ++i)
          part[(size_t)(kg * nrg + rg) * V + i0 + i] = acc[i];
      }
    }
    __syncthreads();
    for (int e = tid; e < staged * NC; e += PT_NT) {
      const int rl = e / NC, n = e % NC, b = b0 + rl;
      if (b >= B) continue;
      const int g = rl / C_ROWS, r = rl % C_ROWS;
      float s = 0.f;
      for (int q = 0; q < kg_n; ++q)
        s += part[(size_t)(q * nrg + g) * V + r * NC + n];
      w.out[n / UP][b * upb + u0 + n % UP] = s;
    }
    __syncthreads();
  }
}

template <int NC, int NM>
__device__ __forceinline__ void chain_product_n(int nc, const ChainParams& p,
                                                const float* x, int B,
                                                const ChainWeights& w,
                                                int u0, float* pool) {
  if constexpr (NC >= NM) {
    if (nc != NC)
      chain_product_n<NC / 2, NM>(nc, p, x, B, w, u0, pool);
    else if (p.resident)
      chain_product<NC, NM, true>(p, x, B, w, u0, pool);
    else
      chain_product<NC, NM, false>(p, x, B, w, u0, pool);
  }
}

// Dynamic shared memory: the K-tile pool, the block's weight rows when
// resident (per layer l = 0 .. NL-1: w_hhs[l] rows, then w_ihs_upper[l-1]
// rows for l > 0; [upb][kpad(4H) + 4] each), and the carries of one batch
// chunk of p.bc rows, dh, dc [NL][bc * upb] and dx_upper [bc * upb] (item
// e = b * upb + u).  The rows of the batch are independent: the block
// runs the whole reverse recurrence for one chunk after another.
template <class G>
__global__ void __launch_bounds__(gic::PT_NT, 1) chain_persistent_kernel(
    ChainParams p) {
  using namespace gic;
  const G* gates = static_cast<const G*>(p.gates);
  const G* cs = static_cast<const G*>(p.cs);
  extern __shared__ float4 dyn_smem[];
  float* pool = reinterpret_cast<float*>(dyn_smem);
  const int B = p.B, H = p.H, K = 4 * H, NL = p.NL, upb = p.upb;
  const int tid = threadIdx.x, j0 = blockIdx.x * upb, wst = kpad(K) + 4;
  const size_t slice = (size_t)upb * wst, w_size = (size_t)H * K;
  float* wres = pool + C_DEPTH * C_SLOT;
  float* dh_s = wres + (p.resident ? (2 * NL - 1) * slice : 0);
  float* dc_s = dh_s + (size_t)NL * p.bc * upb;
  float* dx_s = dc_s + (size_t)NL * p.bc * upb;
  const bool timed = p.prof != nullptr && blockIdx.x == 0 && tid == 0;
  unsigned long long t0 = timed ? clock64() : 0;
  auto mark = [&](int s) {
    if (timed) {
      const unsigned long long now = clock64();
      p.prof[s] += now - t0;
      t0 = now;
    }
  };
  // slice s of the resident rows: 2l - 1 + m for (layer l, matrix m)
  auto res_of = [&](int l, int m) -> const float* {
    return p.resident ? wres + (size_t)(l == 0 ? 0 : 2 * l - 1 + m) * slice
                      : nullptr;
  };

  if (p.resident) {
    for (size_t e = tid; e < (2 * NL - 1) * slice; e += PT_NT) {
      const int s = (int)(e / slice), rem = (int)(e % slice);
      const int u = rem / wst, k = rem % wst, j = j0 + u;
      const float* src = s == 0 ? p.w_hhs
                         : (s % 2 ? p.w_hhs + (size_t)((s + 1) / 2) * w_size
                                  : p.w_ihs_upper + (size_t)(s / 2 - 1) * w_size);
      wres[e] = j < H && k < K ? src[(size_t)j * K + k] : 0.f;
    }
  }
  unsigned int target = 0;
  for (int b_lo = 0; b_lo < B; b_lo += p.bc) {
    const int nb = min(p.bc, B - b_lo), n_own = nb * upb;
    for (int e = tid; e < (2 * NL + 1) * p.bc * upb; e += PT_NT) dh_s[e] = 0.f;
    __syncthreads();
    mark(RPROF_LOAD);

    for (int t = p.T - 1; t >= 0; --t) {
      for (int l = NL - 1; l >= 0; --l) {
        const size_t tl = (size_t)t * NL + l;
        float* dh_l = dh_s + (size_t)l * n_own;
        float* dc_l = dc_s + (size_t)l * n_own;
        float* dp_tl = p.d_pre + tl * B * K;
        // the gate gradients of the block's units (the reverse kernel's)
        for (int e = tid; e < n_own && j0 < H; e += PT_NT) {
          const int b = b_lo + e / upb, j = j0 + e % upb;
          if (j >= H) continue;
          const size_t sidx = (tl * B + b) * H + j;
          const G* g = gates + (tl * B + b) * K + j;
          const float ig = sigmoidf(to_f(g[0])), fg = sigmoidf(to_f(g[H]));
          const float gg = tanhf(to_f(g[2 * H]));
          const float og = sigmoidf(to_f(g[3 * H]));
          const float dh_in = l == NL - 1
                                  ? p.d_hs[((size_t)t * B + b) * H + j]
                                  : dx_s[e];
          const float dh = dh_l[e] + dh_in;
          const float tc = tanhf(to_f(cs[sidx]));
          const float d_o = dh * tc * og * (1.f - og);
          const float dc = dc_l[e] + dh * og * (1.f - tc * tc);
          const float cp =
              t > 0 ? to_f(cs[sidx - (size_t)NL * B * H]) : 0.f;
          float* dp = dp_tl + (size_t)b * K + j;
          dp[0] = dc * gg * ig * (1.f - ig);
          dp[H] = dc * cp * fg * (1.f - fg);
          dp[2 * H] = dc * ig * (1.f - gg * gg);
          dp[3 * H] = d_o;
          dc_l[e] = dc * fg;
        }
        mark(RPROF_GATES);
        grid_barrier(p.barrier, target);
        mark(RPROF_BARRIER);
        if (j0 >= H || (t == 0 && l == 0)) continue;  // nothing reads it
        // dh carry (w_hhs[l]) and, above layer 0, dx_upper (w_ihs_upper[l-1])
        // of the block's units: both in one pass where 2 * upb rows fit,
        // else each matrix in passes of at most C_MAX_UNITS units
        const ChainWeights both{
            {res_of(l, 0), l > 0 ? res_of(l, 1) : nullptr},
            {p.w_hhs + (size_t)l * w_size,
             l > 0 ? p.w_ihs_upper + (size_t)(l - 1) * w_size : nullptr},
            {dh_l, dx_s}};
        const float* x = dp_tl + (size_t)b_lo * K;
        if (l > 0 && 2 * upb <= C_MAX_UNITS) {
          chain_product_n<C_MAX_UNITS, 2>(2 * upb, p, x, nb, both, 0, pool);
        } else {
          const int up = min(upb, C_MAX_UNITS);
          for (int m = 0; m < (l > 0 ? 2 : 1); ++m) {
            const ChainWeights one{
                {m == 0 ? both.res[0] : both.res[1], nullptr},
                {m == 0 ? both.glob[0] : both.glob[1], nullptr},
                {m == 0 ? dh_l : dx_s, nullptr}};
            for (int u0 = 0; u0 < upb; u0 += up)
              chain_product_n<C_MAX_UNITS, 1>(up, p, x, nb, one, u0, pool);
          }
        }
        mark(RPROF_PRODUCT);
      }
    }
  }
}

unsigned long long* g_prof = nullptr;  // gic_reverse_set_profile
unsigned long long* g_chain_prof = nullptr;  // gic_chain_set_profile

}  // namespace

extern "C" {

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The current device's SM count and opt-in shared memory per block, for
// the wrapper's launch plans.
int gic_device_limits(int* n_sm, int* smem_optin) {
  return gic::device_limits(n_sm, smem_optin);
}

// The whole stacked reverse recurrence on `stream`: one cooperative
// launch.  Inputs: w_hhs [NL, H, 4H], w_ihs_upper [NL-1, H, 4H] (null when
// NL = 1), d_hs [T, B, H], gates [T, NL, B, 4H], cs [T, NL, B, H].
// Output: d_pre [T, NL, B, 4H].  plan: blocks, units per block (a power
// of two), resident (0/1), dynamic shared-memory bytes (kernels/
// lstm_bptt.py:chain_plan), batch rows of one chunk; barrier one device
// unsigned int.  Returns 0 or the first CUDA error code
// (cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident);
// nothing synchronises.
// bf16 = 1: gates and cs are bfloat16 (the bfloat16 instantiation).
int gic_lstm_bptt_chain(const float* w_hhs, const float* w_ihs_upper,
                        const float* d_hs, const void* gates, const void* cs,
                        int T, int NL, int B, int H, int bf16, float* d_pre,
                        const int* plan, unsigned int* barrier,
                        void* stream) {
  const int blocks = plan[0], upb = plan[1], resident = plan[2];
  const int smem = plan[3], bc = plan[4];
  if (NL < 1 || upb < 1 || (upb & (upb - 1)) || bc < 1 || bc > B ||
      (long long)blocks * upb < H || (NL > 1 && w_ihs_upper == nullptr))
    return cudaErrorInvalidValue;
  if ((size_t)smem != 4 * chain_smem_floats(bc, H, NL, upb, resident))
    return cudaErrorInvalidValue;
  const ChainParams p{w_hhs, w_ihs_upper, d_hs, gates, cs,  d_pre,
                      barrier, g_chain_prof, T, NL, B, H, upb, resident, bc};
  return gic::launch_persistent(
      bf16 ? chain_persistent_kernel<gic::bf16> : chain_persistent_kernel<float>,
      p, barrier, blocks, gic::PT_NT, (size_t)smem,
      static_cast<cudaStream_t>(stream));
}

// From now on the chain kernel adds its block 0's phase clocks (cycles:
// load, gate gradients, barrier waits, products) into prof [4] (device
// memory, zeroed by the caller); null turns it off.
int gic_chain_set_profile(unsigned long long* prof) {
  g_chain_prof = prof;
  return 0;
}

// Registers per thread and spilled bytes of the chain kernel, float32
// (bf16 = 0) or bfloat16 (1) residuals.
int gic_chain_kernel_attrs(int bf16, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, bf16 ? chain_persistent_kernel<gic::bf16>
               : chain_persistent_kernel<float>);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// One layer's reverse recurrence on `stream`: one cooperative launch.
// Inputs: w_hh [H, 4H] (the transposed torch-layout recurrent weight),
// d_hs [T, B, H], gates [T, B, 4H], c_prev and cs [T, B, H] (the cell
// state entering and leaving each step).  Outputs: d_pre [T, B, 4H]; dh
// and dc [B, H], the carries, which leave as dh0 and dc0.  plan: blocks,
// units per block, resident (0/1), dynamic shared-memory bytes
// (kernels/lstm_bptt.py:reverse_plan); barrier one device unsigned int.
// Returns 0 or the first CUDA error code (cudaErrorCooperativeLaunchTooLarge
// when the grid cannot be co-resident); nothing synchronises.
// bf16 = 1: the five inputs are bfloat16 (the bfloat16 instantiation).
int gic_bptt_reverse(const void* w_hh, const void* d_hs, const void* gates,
                     const void* c_prev, const void* cs, int T, int B, int H,
                     int bf16, float* dh, float* dc, float* d_pre,
                     const int* plan, unsigned int* barrier, void* stream) {
  const int blocks = plan[0], upb = plan[1], resident = plan[2];
  const int smem = plan[3];
  if (upb < 1 || upb > R_MAX_UNITS || (long long)blocks * upb < H)
    return cudaErrorInvalidValue;
  if ((size_t)smem != 4 * reverse_smem_floats(B, H, upb, resident))
    return cudaErrorInvalidValue;
  const ReverseParams p{w_hh,    d_hs,   gates, c_prev, cs, dh, dc,
                        d_pre,   barrier, g_prof, T,     B,  H,  upb,
                        resident};
  return gic::launch_persistent(
      bf16 ? reverse_persistent_kernel<gic::bf16>
           : reverse_persistent_kernel<float>,
      p, barrier, blocks, gic::PT_NT, (size_t)smem,
      static_cast<cudaStream_t>(stream));
}

// From now on the reverse kernel adds its block 0's phase clocks (cycles:
// load, gate gradients, barrier waits, product) into prof [4] (device
// memory, zeroed by the caller); null turns it off.
int gic_reverse_set_profile(unsigned long long* prof) {
  g_prof = prof;
  return 0;
}

// Registers per thread and spilled bytes of the reverse kernel, float32
// (bf16 = 0) or bfloat16 (1) inputs.
int gic_reverse_kernel_attrs(int bf16, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, bf16 ? reverse_persistent_kernel<gic::bf16>
               : reverse_persistent_kernel<float>);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
