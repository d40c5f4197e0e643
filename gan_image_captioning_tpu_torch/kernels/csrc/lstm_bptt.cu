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
// recurrence is sequential, so per-launch latency adds up as in the decode.
//
// What this design does about it.  It is the simple version: the reverse
// time loop runs on the host inside one C call on the caller's stream,
// with 2 launches per step and layer:
//   * gate_grad_kernel: one thread per (b, j) computes the four gate
//     gradients of hidden unit j and updates the dc carry in place;
//   * carry_kernel: the register-tiled product (tile_dot.cuh) of d_pre[t, l]
//     with w_hhs[l] (blockIdx.z = 0, into dh_carry[l]) and, for l > 0, with
//     w_ihs_upper[l-1] (blockIdx.z = 1, into dx_upper) in the same launch.
// The carries live in device buffers the wrapper allocates.  Weights stay
// in L2 between steps when they fit (12.6 MB here).  Fusing the gate
// gradients into the products' load phase, or one persistent kernel for
// the whole recurrence, is later work.
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

using gic::KT;
using gic::sigmoidf;
using gic::tile_dot;

constexpr int G_NT = 256;  // gate-gradient threads per block

// Product tile: C_RT hidden units (rows of the [H, 4H] weight) x C_BT rows.
constexpr int C_RT = 16, C_BT = 32, C_TR = 2, C_TB = 2;
constexpr int C_NT = (C_RT / C_TR) * (C_BT / C_TB);  // 128 threads

struct PlainRows {
  int r0, n;
  __device__ int operator()(int r) const {
    const int R = r0 + r;
    return R < n ? R : -1;
  }
};

__global__ void __launch_bounds__(G_NT) gate_grad_kernel(
    const float* __restrict__ gates, const float* __restrict__ c_t,
    const float* __restrict__ c_prev, const float* __restrict__ dh_in,
    const float* __restrict__ dh_carry, float* __restrict__ dc_carry,
    float* __restrict__ d_pre, int B, int H) {
  const int e = blockIdx.x * G_NT + threadIdx.x;
  if (e >= B * H) return;
  const int b = e / H, j = e % H;
  const float* g = gates + (size_t)b * 4 * H + j;
  const float ig = sigmoidf(g[0]), fg = sigmoidf(g[H]);
  const float gg = tanhf(g[2 * H]), og = sigmoidf(g[3 * H]);
  const float dh = dh_carry[e] + dh_in[e];
  const float tc = tanhf(c_t[e]);
  const float d_o = dh * tc * og * (1.f - og);
  const float dc = dc_carry[e] + dh * og * (1.f - tc * tc);
  const float cp = c_prev != nullptr ? c_prev[e] : 0.f;
  float* dp = d_pre + (size_t)b * 4 * H + j;
  dp[0] = dc * gg * ig * (1.f - ig);
  dp[H] = dc * cp * fg * (1.f - fg);
  dp[2 * H] = dc * ig * (1.f - gg * gg);
  dp[3 * H] = d_o;
  dc_carry[e] = dc * fg;
}

// out_z[b, j] = sum_k d_pre[b, k] * w_z[j, k] with w_z [H, 4H]:
// z = 0 -> (w_hh, dh_carry), z = 1 -> (w_ih_upper, dx_upper).
__global__ void __launch_bounds__(C_NT) carry_kernel(
    const float* __restrict__ d_pre, const float* __restrict__ w_hh,
    const float* __restrict__ w_ih_upper, float* __restrict__ dh_out,
    float* __restrict__ dx_out, int B, int H) {
  __shared__ float Ws[C_RT][KT + 1];
  __shared__ float Xs[C_BT][KT + 1];
  constexpr int NR = C_RT / C_TR, NB = C_BT / C_TB;
  const int r0 = blockIdx.x * C_RT, b0 = blockIdx.y * C_BT;
  const int tid = threadIdx.x, tr = tid % NR, tb = tid / NR;
  const float* w = blockIdx.z == 0 ? w_hh : w_ih_upper;
  float* out = blockIdx.z == 0 ? dh_out : dx_out;

  float acc[C_TR][C_TB];
  tile_dot<C_RT, C_BT, C_TR, C_TB>(PlainRows{r0, H}, w, nullptr, d_pre,
                                   nullptr, 4 * H, 0, b0, B, acc, Ws, Xs);
#pragma unroll
  for (int i = 0; i < C_TR; ++i) {
    const int j = r0 + tr + i * NR;
#pragma unroll
    for (int k = 0; k < C_TB; ++k) {
      const int b = b0 + tb + k * NB;
      if (j < H && b < B) out[(size_t)b * H + j] = acc[i][k];
    }
  }
}

constexpr int R_MAX_UNITS = 16;
constexpr int R_SLOT = 64 * (128 + 4);  // floats of one pipeline slot
constexpr int R_DEPTH = 4;                 // slots in the pool
constexpr int R_POOL = R_DEPTH * R_SLOT;
constexpr int R_SPLIT = 4;  // K split of each product inside the block

// Phase clocks of block 0 (clock64 cycles, summed over the call) when the
// caller asked for them (gic_reverse_set_profile).
enum { RPROF_LOAD, RPROF_GATES, RPROF_BARRIER, RPROF_PRODUCT, RPROF_SLOTS };

struct ReverseParams {
  const float* w_hh;    // [H, 4H]
  const float* d_hs;    // [T, B, H]
  const float* gates;   // [T, B, 4H]
  const float* c_prev;  // [T, B, H]
  const float* cs;      // [T, B, H]
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
__global__ void __launch_bounds__(gic::PT_NT, 1) reverse_persistent_kernel(
    ReverseParams p) {
  using namespace gic;
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
      wres[e] = j < H && k < K ? p.w_hh[(size_t)j * K + k] : 0.f;
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
                  reinterpret_cast<uintptr_t>(p.w_hh) % 16 == 0};
  const Seg none{nullptr, 0, 0, true};
  unsigned int target = 0;
  for (int t = p.T - 1; t >= 0; --t) {
    // the gate gradients of the block's units (gate_grad_kernel's)
    for (int e = tid; e < n_own && j0 < H; e += PT_NT) {
      const int b = e / upb, j = j0 + e % upb;
      if (j >= H) continue;
      const size_t sidx = ((size_t)t * B + b) * H + j;
      const float* g = p.gates + ((size_t)t * B + b) * K + j;
      const float ig = sigmoidf(g[0]), fg = sigmoidf(g[H]);
      const float gg = tanhf(g[2 * H]), og = sigmoidf(g[3 * H]);
      const float dh = dh_s[e] + p.d_hs[sidx];
      const float tc = tanhf(p.cs[sidx]);
      const float d_o = dh * tc * og * (1.f - og);
      const float dc = dc_s[e] + dh * og * (1.f - tc * tc);
      const float cp = p.c_prev[sidx];
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

unsigned long long* g_prof = nullptr;  // gic_reverse_set_profile

}  // namespace

extern "C" {

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The whole reverse recurrence on `stream`.  Inputs: w_hhs [NL, H, 4H],
// w_ihs_upper [NL-1, H, 4H] (unused when NL = 1), d_hs [T, B, H],
// gates [T, NL, B, 4H], cs [T, NL, B, H].  Scratch: dh_carry, dc_carry
// [NL, B, H], dx_upper [B, H].  Output: d_pre [T, NL, B, 4H].  Returns 0 or
// the first CUDA error code; nothing synchronises.
int gic_lstm_bptt_chain(const float* w_hhs, const float* w_ihs_upper,
                        const float* d_hs, const float* gates,
                        const float* cs, int T, int NL, int B, int H,
                        float* dh_carry, float* dc_carry, float* dx_upper,
                        float* d_pre, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t state = (size_t)B * H, w_size = (size_t)H * 4 * H;
  cudaError_t err = cudaMemsetAsync(dh_carry, 0, sizeof(float) * NL * state, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(dc_carry, 0, sizeof(float) * NL * state, s);
  if (err != cudaSuccess) return err;

  const int g_blocks = (int)((state + G_NT - 1) / G_NT);
  for (int t = T - 1; t >= 0; --t) {
    for (int l = NL - 1; l >= 0; --l) {
      const size_t tl = (size_t)t * NL + l;
      const float* dh_in = l == NL - 1 ? d_hs + (size_t)t * state : dx_upper;
      const float* c_prev = t > 0 ? cs + (tl - NL) * state : nullptr;
      float* dp = d_pre + tl * 4 * state;
      gate_grad_kernel<<<g_blocks, G_NT, 0, s>>>(
          gates + tl * 4 * state, cs + tl * state, c_prev, dh_in,
          dh_carry + l * state, dc_carry + l * state, dp, B, H);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      const dim3 grid((H + C_RT - 1) / C_RT, (B + C_BT - 1) / C_BT,
                      l > 0 ? 2 : 1);
      carry_kernel<<<grid, C_NT, 0, s>>>(
          dp, w_hhs + l * w_size,
          l > 0 ? w_ihs_upper + (l - 1) * w_size : nullptr,
          dh_carry + l * state, dx_upper, B, H);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
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
int gic_bptt_reverse(const float* w_hh, const float* d_hs, const float* gates,
                     const float* c_prev, const float* cs, int T, int B, int H,
                     float* dh, float* dc, float* d_pre, const int* plan,
                     unsigned int* barrier, void* stream) {
  const int blocks = plan[0], upb = plan[1], resident = plan[2];
  const int smem = plan[3];
  if (upb < 1 || upb > R_MAX_UNITS || (long long)blocks * upb < H)
    return cudaErrorInvalidValue;
  if ((size_t)smem != 4 * reverse_smem_floats(B, H, upb, resident))
    return cudaErrorInvalidValue;
  const ReverseParams p{w_hh,    d_hs,   gates, c_prev, cs, dh, dc,
                        d_pre,   barrier, g_prof, T,     B,  H,  upb,
                        resident};
  return gic::launch_persistent(reverse_persistent_kernel, p, barrier,
                                blocks, gic::PT_NT, (size_t)smem,
                                static_cast<cudaStream_t>(stream));
}

// From now on the reverse kernel adds its block 0's phase clocks (cycles:
// load, gate gradients, barrier waits, product) into prof [4] (device
// memory, zeroed by the caller); null turns it off.
int gic_reverse_set_profile(unsigned long long* prof) {
  g_prof = prof;
  return 0;
}

// Registers per thread and spilled bytes of the reverse kernel.
int gic_reverse_kernel_attrs(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, reverse_persistent_kernel);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
