// Stacked-LSTM free-running decode for Hopper (sm_90a), float32 or
// bfloat16 (a template parameter, bf16.cuh), every mode: greedy / serve
// (with or without carried state), pretrain, and the Gumbel modes sample,
// sample_resid and sample_embed.
//
// Replaces: gan_image_captioning_tpu/kernels/decode_sample.py, function
// `_kernel` in modes "serve", "greedy", "pretrain", "sample", "sample_resid"
// and "sample_embed" (launched by `decode_sample`).  Per step t of T, for a
// batch of B rows:
//   gates_l = [x | h_l] @ [w_ih_l | w_hh_l]^T + (b_ih_l + b_hh_l)  (i, f, g, o)
//   c_l = f*c_l + i*g ;  h_l = o*tanh(c_l) ;  x = h_l            (per layer)
//   logits = h_top @ w_proj^T + b_proj
// serve:
//   ids[b, t] = argmax(logits)             (first index on ties)
//   lps[b, t] = -log(sum(exp(logits - max)))
// sample_resid:
//   u ~ U[0, 1) per (t, b, v): Philox4x32-10 keyed by the seed, counter
//       (v, b, t, 0), top 24 bits of the first word times 2^-24 (the TPU
//       kernel's construction from 32 random bits); or read from `u_in`
//   g = -log(-log(u + 1e-10) + 1e-10) ;  s = logits + g
//   ids[b, t] = argmax(s)                  (unscaled, first index on ties)
//   soft[t, b] = softmax(temp * s)
//   hs/cs[t, l], gates[t, l] = h_l, c_l and the pre-activation gates (both
//   biases) of every layer: the residuals of the manual backward
// pretrain: ids as serve, and logits[t, b] instead of lps
// sample:   ids as sample_resid (the same s), and noise[t, b] = g instead
//   of soft and the residuals
// sample_embed: sample_resid, then emb[t, b] = soft[t, b] @ wd^T with the
//   discriminator's embedding wd [Ed, V], one product over all T*B rows
//   after the time loop (embed_kernel, a second launch: nothing feeds emb
//   back into the recurrence)
// and in every mode  x = embed[ids[:, t]]  is the next step's input.  serve
// with carried state starts from a given (h0, c0, x0) instead of (0, 0,
// features) and hands back the state after its last step (hT, cT, xT),
// xT = embed[last ids]: the continuous engine's chunks and the adaptive
// decode.
//
// Also replaces the same file's `_qserve_kernel` (launched by
// `decode_sample_q_serve`): mode serve, carried state or not, on a
// weight-only quantized decoder (ops/quantize.py:quantize_lstm_decoder):
// per layer Wq [In+H, 4H] with per-column scales [4H] and one bias
// b [4H]; Pq [H, V] with scales [V] and the bias; Eq [V, E] with scales
// [E]; int8, or int4 packed two rows a byte (byte row r holds row r in
// its low nibble and row r + R in its high nibble, values in [-7, 7]; an
// odd vocabulary's embedding has one zero pad row).  Every weight is
// deq(Q)[k, n] = float(Q[k, n]) * scale[n], rounded once.
//
// What bounds it on this card.  At the training width (E = H = 512, two
// layers, V = 11008, T = 36, B = 64) one decode does 2*B*T*(2*4H*(E+H) +
// V*H) = 45.3 GFLOP: 0.68 ms at float32's 67 TFLOP/s (no tensor cores:
// every gate and logit is one float32 FMA chain, see below), against
// 0.06 ms for the bytes.  The steps are sequential and each needs every
// weight again, so a decode is T dependent steps of 19 us of arithmetic
// at best.  A host loop of nl + 2 launches per step (the previous design)
// spent 118-161 us per step on launch latency, weight re-reads through
// small K tiles and serial per-row statistics.
//
// What this design does about it: one persistent kernel, one cooperative
// launch per call, the time loop inside it (persistent.cuh).  A block per
// SM; each owns
//   * a fixed set of hidden units [j0, j0 + upb) in every layer, and keeps
//     their gate rows of [w_ih | w_hh] in shared memory for the whole call
//     (config3: 4 units, 16 rows x 1024 x 2 layers = 131 KB) -- the TPU
//     kernel's weights-resident-in-VMEM design.  When that slice does not
//     fit (e.g. H = 1024, nl = 2) the same code streams it from global
//     memory each step through the K-tile stage: the same arithmetic in
//     the same order, only the source of the weights differs;
//   * fixed 64-row tiles of the vocabulary (w_proj, 22.5 MB, does not also
//     fit on chip; each block reads the same rows every step, from L2);
//   * fixed batch rows for the row combine.
// Per step three kinds of phase, with a grid barrier after each (nl + 2
// barriers per step):
//   1. layer l's gates and cell update, l = 0 .. nl-1: a thread owns
//      (unit, batch row) items and accumulates the unit's four gate rows
//      over K tiles of [x | h] that cp.async brings into a 4-slot pool
//      (three tiles in flight; the tile as wide as the batch chunk allows,
//      64 columns at B = 64, 512 at B = 8).  The kernel's own x and h
//      rows are padded to 4 floats for 16-byte copies; h is ping-ponged
//      (t % 2 read, (t+1) % 2 written) because other blocks still read
//      the old h;
//   2. the projection of the block's vocabulary tiles with each tile's
//      statistics per batch row (serve: max, first argmax, sum(exp(l -
//      max)); sample: max and first argmax of s, and max and sum(exp(z -
//      max)) of z = temp * s, z stored into soft);
//   3. the row combine (a block per batch row): ids, lps or the
//      normalised soft row, and x = embed[id].
// The quantized decode is the same kernel (template parameter Q), only
// the source of the weights differs: the block's gate rows are
// dequantized once per call into the same resident slice (read along the
// payload's K-major rows: the block's columns of one k are neighbours);
// the projection's int8 / packed int4 rows of each K tile arrive by
// cp.async in a byte ring beside the pool (8 KB) and are dequantized into
// the slot's projection rows just before the FMA loop reads them, so the
// projection reads a quarter (int8) or an eighth (int4) of the dense
// kernel's 22.5 MB of weight bytes a step; the row combine takes
// x = deq(Eq)[id].  Where the gate rows do not fit, they are dequantized
// into the K-tile stage each step (without cp.async).
// What stays bit-equal to the previous design, and so between the dense
// decode on dequantized weights and the quantized one: each gate
// pre-activation and each logit is one float32 accumulator running over k
// ascending by fmaf, x before h, the bias added after (tile_dot.cuh's
// order; no split-K: the zero pad columns add exact zeros); the cell
// update's and the Gumbel score's expressions; each 64-row tile's exp-sum
// serial over its rows; the tiles combined in block_rescaled_sum's order
// (128 partial sums over tiles i = tid mod 128, then a halving tree).
// Data another block wrote in the same launch is read through L2 only
// (ld.cg, cp.async.cg).
// What still bounds it (PERF.md, PR 8): each layer-step every block
// stages all B rows of [x | h] from L2 and reads them from shared memory
// once per unit; each K tile costs a wait and a __syncthreads; the 172
// vocabulary tiles fall 2 / 1 on 132 blocks.  Thread-block clusters
// sharing one staged copy, folding the row combine into the next step's
// first layer, and bf16 weights are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "persistent.cuh"
#include "tile_dot.cuh"

using namespace gic;

namespace {

constexpr int NT = PT_NT;
constexpr int XROWS = 64;                  // batch rows of one chunk
// The pool: 8 slots of 2304 floats for the layers (x tiles only, 7 in
// flight), read as 4 slots of 4608 by the projection (h_top and w_proj
// tiles together, 3 in flight).
constexpr int POOL_FLOATS = 18432;
constexpr int L_DEPTH = 8, L_SLOT = POOL_FLOATS / L_DEPTH;
constexpr int P_DEPTH = 4, SLOT = POOL_FLOATS / P_DEPTH;
constexpr int MAX_NL = 8;
constexpr int MAX_UNITS = 16;              // upb limit
constexpr int LS = P_RT + 1;               // projection tile row stride
// The quantized projection's byte ring: RING_SLOTS K tiles of a
// vocabulary tile's int8 / packed int4 rows, [PQ_KT][P_RT] bytes each.
// Tile i + 1's bytes travel with tile i's h rows, one tile ahead, so that
// the compute step of tile i dequantizes tile i + 1 (its bytes have
// landed) into that tile's pool slot without a barrier of its own: one
// slot more than the pool, because tile i + P_DEPTH's bytes are issued
// while tile i + 1's are read.
constexpr int PQ_KT = 32, RING_SLOTS = P_DEPTH + 1;
constexpr int RING_FLOATS = RING_SLOTS * PQ_KT * P_RT / 4;
// the projection's K tile is never wider than PQ_KT: a slot holds at
// least 8 + P_RT rows; and a thread dequantizes one row of a tile
static_assert(SLOT < (8 + P_RT) * (2 * PQ_KT + 4) && NT % P_RT == 0,
              "projection tile geometry");

// Phase clocks of block 0 (clock64 cycles, summed over the call) when the
// caller asked for them (gic_decode_set_profile): where a step's time goes.
enum { PROF_LOAD, PROF_LSTM, PROF_BARRIER, PROF_PROJ, PROF_COMBINE,
       PROF_SLOTS };

// W: the element type of the weights and activations (float, or bf16 for
// the bfloat16 instantiation: every W-typed input widened exactly, every
// W-typed output rounded once).  Scratch, c, the statistics, the log-
// probabilities and the uniforms are float32 in both; so are the quantized
// decode's biases and scales.  The dense biases are W (B: const void*,
// read by bias_at).
template <class W>
struct DecodeParams {
  const W* w_ih[MAX_NL];
  const W* w_hh[MAX_NL];
  const void* b_ih[MAX_NL];
  const void* b_hh[MAX_NL];
  const W* w_proj;
  const void* b_proj;
  const W* embed;
  const W* x_init;      // feats or the carried x0 [B, E]
  const W* h0;          // [nl, B, H] or null (zeros)
  const float* c0;      // [nl, B, H] or null (zeros)
  float* x;             // scratch [B, Ep]  (Ep = E rounded up to 4)
  float* h;             // scratch [2, nl, B, Hp], zero columns past H
  float* c;             // scratch [nl, B, H]
  float* pmax;          // [B, ntile]: max of the logits / of s
  int* pidx;            // [B, ntile]: its first index
  float* psum;          // [B, ntile]: sum(exp(l - max))   (greedy modes)
  float* pzmax;         // [B, ntile]: max of z             (soft sample)
  float* pzsum;         // [B, ntile]: sum(exp(z - max))    (soft sample)
  float* zbuf;          // [B, V]: z of the step (bfloat16 soft sample; the
                        // float32 one keeps z in soft itself)
  unsigned int* barrier;
  int32_t* ids;         // [B, T]
  float* lps;           // [B, T] or null
  W* logits;            // [T, B, V] or null (pretrain)
  W* soft;              // [T, B, V] or null (sample_resid, sample_embed)
  W* noise;             // [T, B, V] or null (sample)
  W* hs;                // [T, nl, B, H] or null (residuals)
  W* cs;                // [T, nl, B, H]
  W* gates;             // [T, nl, B, 4H]
  W* hT;                // [nl, B, H] or null (carried state out)
  float* cT;
  W* xT;                // [B, E] or null
  const float* u_in;    // [T, B, V] or null (Philox)
  float* u_out;         // [T, B, V] or null
  unsigned long long* prof;  // [PROF_SLOTS] or null
  // quantized weights (the kernel's Q instantiation): per layer the fused
  // gate matrix wq [In+H, 4H] and its column scales [4H] (the bias in
  // b_ih, b_hh null); the projection pq [H, V] and its scales [V] (the bias
  // in b_proj); the embedding eq [V, E] and its scales [E].  bits 4: each
  // payload row-packed, R rows a byte holding rows r (low nibble) and
  // r + R (high), R = half the rows (r_emb for the embedding)
  const int8_t* wq[MAX_NL];
  const float* wscale[MAX_NL];
  const int8_t* pq;
  const float* pscale;
  const int8_t* eq;
  const float* escale;
  unsigned long long seed;
  float temp;
  int B, E, H, V, nl, T, upb, resident, pb, sample, ntile, Ep, Hp, bits,
      r_emb;
};

// Element i of a bias: float32 in the quantized decode (Q), else W.
template <bool Q, class W>
__device__ __forceinline__ float bias_at(const void* b, size_t i) {
  if constexpr (Q)
    return static_cast<const float*>(b)[i];
  else
    return to_f(static_cast<const W*>(b)[i]);
}

// The padded width of layer l's input and of its [x | h] row.
__host__ __device__ inline int in_pad(int l, int E, int H) {
  return pad4(l ? H : E);
}
__host__ __device__ inline int row_pad(int l, int E, int H) {
  return kpad(in_pad(l, E, H) + pad4(H)) + 4;
}

// Floats of the resident gate rows of every layer: 4 * upb rows of
// [w_ih | 0 | w_hh | 0] per layer, each column block padded to 4.
__host__ __device__ inline int resident_floats(int nl, int E, int H,
                                               int upb) {
  int n = 0;
  for (int l = 0; l < nl; ++l) n += 4 * upb * row_pad(l, E, H);
  return n;
}

template <class W>
__device__ __forceinline__ size_t half_off(const DecodeParams<W>& p, int t) {
  return (size_t)(t % 2) * p.nl * p.B * p.Hp;
}

// Local gate row r = g * upb + u of the block at unit j0: global row
// g * H + j0 + u of the [4H, K] weights, -1 past H.
__device__ __forceinline__ int gate_row(int r, int j0, int upb, int H) {
  const int g = r / upb, j = j0 + r % upb;
  return r < 4 * upb && j < H ? g * H + j : -1;
}

// A read-only [rows, cols] input (row stride cols) as a stage segment;
// bfloat16 rows are loaded 8 bytes (4 columns) at a time and widened.
__device__ __forceinline__ Seg input_seg(const float* p, int cols) {
  return Seg{p, cols, cols,
             p != nullptr && cols % 4 == 0 &&
                 reinterpret_cast<uintptr_t>(p) % 16 == 0};
}
__device__ __forceinline__ Seg input_seg(const bf16* p, int cols) {
  return Seg{p, cols, cols,
             p != nullptr && cols % 4 == 0 &&
                 reinterpret_cast<uintptr_t>(p) % 8 == 0,
             true};
}

// A kernel-written padded scratch matrix (stride and columns padded to 4,
// the pad columns zero).
__device__ __forceinline__ Seg scratch_seg(const float* p, int cols_pad) {
  return Seg{p, cols_pad, cols_pad, true};
}

__device__ __forceinline__ unsigned long long clk() { return clock64(); }

// Gate row r = g * upb + u of the block's [4H, K] weights (-1 past H).
struct GateRows {
  int j0, upb, H;
  __device__ int operator()(int r) const { return gate_row(r, j0, upb, H); }
};

// The signed value a payload byte holds: int8, or the low or high nibble
// of packed int4, sign-extended.
__device__ __forceinline__ int qunpack(int b, int bits, bool high) {
  if (bits == 8) return b;
  return high ? b >> 4 : ((b & 0x0F) ^ 8) - 8;  // >> 4: arithmetic, signed
}

// Element (k, n) of a quantized [K, N] payload: int8, or packed int4 with
// R byte rows (row k in the low nibble of byte row k, row k + R in the
// high nibble of byte row k).
__device__ __forceinline__ int qval(const int8_t* q, int bits, int R, int N,
                                    int k, int n) {
  const bool high = bits == 4 && k >= R;
  return qunpack(q[(size_t)(high ? k - R : k) * N + n], bits, high);
}

// float(q) * scale, rounded once, as ops/quantize.py:dequantize rounds it.
__device__ __forceinline__ float deq(int q, float scale) {
  return __fmul_rn((float)q, scale);
}

// Element k of gate row R (a column of the [In+H, 4H] payload) of layer l
// in the padded [x | 0 | h | 0] row layout; zero in the pads.  bfloat16:
// the dequantized weight rounded to bfloat16, as the TPU kernel's
// `_dq(...).astype(dt)` stores it.
template <class W>
__device__ __forceinline__ float qgate(const DecodeParams<W>& p, int l, int R,
                                       int k) {
  const int In = l ? p.H : p.E, wa = in_pad(l, p.E, p.H), N = 4 * p.H;
  int kk;
  if (k < In)
    kk = k;
  else if (k >= wa && k - wa < p.H)
    kk = In + k - wa;
  else
    return 0.f;
  return round_to<W>(deq(qval(p.wq[l], p.bits, (In + p.H) / 2, N, kk, R),
                         p.wscale[l][R]));
}

// The block's dense gate rows of every layer, [w_ih | 0 | w_hh | 0]
// zero-padded to row_pad.
template <class W>
__device__ void load_dense_rows(const DecodeParams<W>& p, float* wres) {
  for (int l = 0; l < p.nl; ++l) {
    const int In = l ? p.H : p.E, wa = in_pad(l, p.E, p.H);
    const int ws = row_pad(l, p.E, p.H);
    const int j0 = blockIdx.x * p.upb, rows = 4 * p.upb;
    for (int e = threadIdx.x; e < rows * ws; e += NT) {
      const int r = e / ws, k = e % ws, R = gate_row(r, j0, p.upb, p.H);
      float v = 0.f;
      if (R >= 0 && k < In)
        v = to_f(p.w_ih[l][(size_t)R * In + k]);
      else if (R >= 0 && k >= wa && k - wa < p.H)
        v = to_f(p.w_hh[l][(size_t)R * p.H + k - wa]);
      wres[e] = v;
    }
    wres += rows * ws;
  }
}

// The block's resident gate rows of every layer, [w_ih | 0 | w_hh | 0]
// zero-padded to row_pad; quantized (Q): dequantized once, here, each
// element read along the payload's rows (the block's columns of one k
// are neighbours in memory).
template <bool Q, class W>
__device__ void load_resident(const DecodeParams<W>& p, float* wres) {
  if constexpr (Q) {
    for (int l = 0; l < p.nl; ++l) {
      const int ws = row_pad(l, p.E, p.H), rows = 4 * p.upb;
      const int j0 = blockIdx.x * p.upb;
      for (int e = threadIdx.x; e < rows * ws; e += NT) {
        const int r = e % rows, k = e / rows, R = gate_row(r, j0, p.upb, p.H);
        wres[(size_t)r * ws + k] = R >= 0 ? qgate(p, l, R, k) : 0.f;
      }
      wres += rows * ws;
    }
  } else {
    load_dense_rows(p, wres);
  }
}

// Phase 1: layer l of step t for the block's hidden units, all B rows.
// A thread owns one unit (its four gate rows) and one batch row of the
// chunk; each K tile stages the chunk's rows of [x | h] (and, streamed,
// the block's gate rows) in a pipeline slot.  (Two or four rows a thread
// load less shared memory per FMA but leave too few warps: slower on the
// card at B = 64.)
template <bool Q, class W>
__device__ void lstm_phase(const DecodeParams<W>& p, int t, int l,
                           const float* wres_l, float* pool) {
  const int B = p.B, H = p.H, Hp = p.Hp, upb = p.upb, j0 = blockIdx.x * upb;
  if (j0 >= H) return;  // block-uniform: no unit in this block
  const int In = l ? H : p.E, wa = in_pad(l, p.E, H), Kp = wa + Hp;
  const int wstride = row_pad(l, p.E, H);
  const size_t lp = (size_t)l * B * Hp, lo = (size_t)l * B * H;
  const Seg xs = l ? scratch_seg(p.h + half_off(p, t + 1) + lp - (size_t)B * Hp, Hp)
                   : (t == 0 ? input_seg(p.x_init, In) : scratch_seg(p.x, wa));
  const Seg hs_seg = t ? scratch_seg(p.h + half_off(p, t) + lp, Hp)
                       : input_seg(p.h0 != nullptr ? p.h0 + lo : nullptr, H);
  const Seg wi = input_seg(p.w_ih[l], In), wh = input_seg(p.w_hh[l], H);
  float* hnew = p.h + half_off(p, t + 1) + lp;
  // a chunk of batch rows small enough for one (unit, row) item a thread
  const int bc = min(min(B, XROWS), NT / upb), wrows = 4 * upb;
  // resident: x rows only in a layer slot; streamed: x rows, then gate
  // rows in a projection-sized slot
  const int slot_fl = p.resident ? L_SLOT : SLOT;
  const int kt = tile_k(p.resident ? bc : bc + wrows, slot_fl, Kp);
  const int ntiles = kpad(Kp) / kt, xfl = bc * (kt + 4);
  const int tid = threadIdx.x, u = tid / bc, bl = tid % bc;
  const bool active = tid < upb * bc;

  for (int b0 = 0; b0 < B; b0 += bc) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const auto issue = [&](int i, float* slot) {
      stage_rows(slot, kt, bc, RowRange{b0, B}, xs, wa, hs_seg, i * kt);
      if (p.resident) return;
      if constexpr (Q) {  // dequantized here, without cp.async
        for (int c = tid; c < wrows * kt; c += NT) {
          const int r = c % wrows, kk = c / wrows;
          const int R = gate_row(r, j0, upb, H);
          slot[xfl + r * (kt + 4) + kk] = R >= 0 ? qgate(p, l, R, i * kt + kk)
                                                 : 0.f;
        }
      } else {
        stage_rows(slot + xfl, kt, wrows, GateRows{j0, upb, H}, wi, wa, wh,
                   i * kt);
      }
    };
    const auto compute = [&](int it, const float* slot) {
      if (!active) return;
      const float* wbase = p.resident ? wres_l + it * kt : slot + xfl;
      const int wst = p.resident ? wstride : kt + 4;
      const float* w0 = wbase + (size_t)(0 * upb + u) * wst;
      const float* w1 = wbase + (size_t)(1 * upb + u) * wst;
      const float* w2 = wbase + (size_t)(2 * upb + u) * wst;
      const float* w3 = wbase + (size_t)(3 * upb + u) * wst;
      const float* xrow = slot + bl * (kt + 4);
#pragma unroll 8
      for (int kk = 0; kk < kt; kk += 4) {
        const float4 xv = ld4(xrow + kk);
        acc[0] = fma4(ld4(w0 + kk), xv, acc[0]);
        acc[1] = fma4(ld4(w1 + kk), xv, acc[1]);
        acc[2] = fma4(ld4(w2 + kk), xv, acc[2]);
        acc[3] = fma4(ld4(w3 + kk), xv, acc[3]);
      }
    };
    if (p.resident)
      k_pipeline<L_DEPTH>(pool, L_SLOT, ntiles, issue, compute);
    else
      k_pipeline<P_DEPTH>(pool, SLOT, ntiles, issue, compute);

    // the cell update of the item (lstm_cell_tile's expressions)
    const int b = b0 + bl, j = j0 + u;
    if (active && j < H && b < B) {
      // the bias b_ih + b_hh (one float32 add, as the previous design's
      // wrapper formed it) after the K loop
      // (quantized: one bias, b_hh zero, as dequantized_decoder gives it;
      // bfloat16: the sum rounded to bfloat16, as the TPU kernel's caller
      // adds the two bfloat16 biases)
      const auto bias = [&](int g) {
        const size_t i = (size_t)g * H + j;
        const float s =
            bias_at<Q, W>(p.b_ih[l], i) +
            (p.b_hh[l] != nullptr ? bias_at<Q, W>(p.b_hh[l], i) : 0.f);
        return Q ? s : round_to<W>(s);
      };
      const float pi = acc[0] + bias(0);
      const float pf = acc[1] + bias(1);
      const float pg = acc[2] + bias(2);
      const float po = acc[3] + bias(3);
      const float gi = sigmoidf(pi), gf = sigmoidf(pf);
      const float gg = tanhf(pg), go = sigmoidf(po);
      const size_t o = (size_t)b * H + j;
      const float c_old = t ? p.c[lo + o]
                            : (p.c0 != nullptr ? p.c0[lo + o] : 0.f);
      const float cn = gf * c_old + gi * gg;
      const float hn = go * tanhf(cn);
      p.c[lo + o] = cn;  // float32 in both instantiations
      // h in W: the next layer's input, the next step's h and the
      // projection's input (the TPU kernel's bfloat16 h carry)
      hnew[(size_t)b * Hp + j] = round_to<W>(hn);
      if (p.gates != nullptr) {
        const size_t tl = (size_t)t * p.nl + l, layer = (size_t)B * H;
        const size_t gr = tl * 4 * layer + (size_t)b * 4 * H + j;
        store_cs(p.gates, gr, pi);
        store_cs(p.gates, gr + H, pf);
        store_cs(p.gates, gr + 2 * H, pg);
        store_cs(p.gates, gr + 3 * H, po);
        store_cs(p.hs, tl * layer + o, hn);
        store_cs(p.cs, tl * layer + o, cn);
      }
      if (t == p.T - 1) {
        if (p.hT != nullptr) store_as(p.hT, lo + o, hn);
        if (p.cT != nullptr) p.cT[lo + o] = cn;
      }
    }
  }
}

// The bytes of K tile [k0, k0 + kt) of the quantized projection's
// vocabulary tile [v0, v0 + 64) into a ring slot, [kk][64], issued without
// waiting where the rows are 16-byte aligned; byte row k, or k - H/2 for
// the high nibbles of packed int4.  Columns past V are not read.
template <class W>
__device__ __forceinline__ void stage_qproj(const DecodeParams<W>& p,
                                            int8_t* dst, int v0, int k0,
                                            int kt) {
  const int V = p.V, H = p.H, R = p.bits == 4 ? H / 2 : H;
  const bool aligned =
      V % 16 == 0 && reinterpret_cast<uintptr_t>(p.pq) % 16 == 0;
  if (aligned) {
    for (int c = threadIdx.x; c < kt * (P_RT / 16); c += NT) {
      const int kk = c / (P_RT / 16), v = v0 + (c % (P_RT / 16)) * 16;
      const int k = k0 + kk;
      if (k >= H || v >= V) continue;
      const int8_t* src = p.pq + (size_t)(k < R ? k : k - R) * V + v;
      cp_async16(reinterpret_cast<float*>(dst + kk * P_RT + (v - v0)),
                 reinterpret_cast<const float*>(src));
    }
    return;
  }
  for (int c = threadIdx.x; c < kt * P_RT; c += NT) {
    const int kk = c / P_RT, v = v0 + c % P_RT, k = k0 + kk;
    if (k < H && v < V) dst[c] = p.pq[(size_t)(k < R ? k : k - R) * V + v];
  }
}

// Phase 2: the block's vocabulary tiles of step t and their statistics.
// A thread owns RV rows (tr + NRL i) x TB batch rows (tb + NBL j) of a
// 64-row tile and a chunk of PB = NBL * TB batch rows (register tiles as
// large as the batch allows: fewer shared-memory loads per FMA); a slot
// holds the K tile of the chunk's h_top rows, then of the tile's
// projection rows.
// Quantized (Q): the tile's payload rows arrive as bytes in the byte ring
// (cp.async when 16-byte aligned), one K tile ahead of the h_top rows,
// and the compute step of K tile i dequantizes tile i + 1 into its pool
// slot's projection rows, the floats the dense kernel reads there.
template <bool Q, class W, int RV, int TB, int NBL>
__device__ void proj_phase(const DecodeParams<W>& p, int t, float* pool,
                           int8_t* ring) {
  constexpr int NRL = P_RT / RV, PB = NBL * TB;
  static_assert(NRL * NBL <= NT, "proj thread tile");
  const int B = p.B, H = p.H, Hp = p.Hp, V = p.V, ntile = p.ntile;
  const int tid = threadIdx.x, tr = tid % NRL, tb = tid / NRL;
  const bool active = tid < NRL * NBL;
  const Seg hx = scratch_seg(
      p.h + half_off(p, t + 1) + (size_t)(p.nl - 1) * B * Hp, Hp);
  const Seg wp = input_seg(p.w_proj, H), none{nullptr, 0, 0, true};
  const int kt = tile_k(PB + P_RT, SLOT, Hp), ntiles = kpad(Hp) / kt;
  const int xfl = PB * (kt + 4);
  float* Ls = pool;  // [PB][LS], after the K loop
  const size_t step = (size_t)t * B * V;

  for (int tile = blockIdx.x; tile < ntile; tile += gridDim.x) {
    const int v0 = tile * P_RT, n = min(P_RT, V - v0);
    // quantized: the scale of the vocabulary row this thread dequantizes
    const int qr = tid % P_RT, qv = v0 + qr;
    const float qscale = Q && qv < V ? p.pscale[qv] : 0.f;
    const auto ring_slot = [&](int i) {
      return ring + (i % RING_SLOTS) * (PQ_KT * P_RT);
    };
    // tile i's bytes into its pool slot's projection rows: a thread owns
    // vocabulary row qr of the tile (NT is a multiple of P_RT) and every
    // fourth group of 4 k, stored as one float4 (neighbouring threads:
    // neighbouring rows, no bank conflict)
    const auto dequant = [&](int i) {
      const int8_t* bytes = ring_slot(i);
      float* w = pool + (i % P_DEPTH) * SLOT + xfl + qr * (kt + 4);
      const int R = p.H / 2;
      const auto one = [&](int kk) {
        const int k = i * kt + kk;
        const int q = qunpack(bytes[kk * P_RT + qr], p.bits, k >= R);
        return qv < V && k < H ? round_to<W>(deq(q, qscale)) : 0.f;
      };
#pragma unroll 2
      for (int kq = tid / P_RT; kq < kt / 4; kq += NT / P_RT) {
        const int kk = 4 * kq;
        *reinterpret_cast<float4*>(w + kk) =
            make_float4(one(kk), one(kk + 1), one(kk + 2), one(kk + 3));
      }
    };
    for (int b0 = 0; b0 < B; b0 += PB) {
      float acc[RV][TB];
#pragma unroll
      for (int i = 0; i < RV; ++i)
#pragma unroll
        for (int j = 0; j < TB; ++j) acc[i][j] = 0.f;
      k_pipeline<P_DEPTH>(
          pool, SLOT, ntiles,
          [&](int i, float* slot) {
            stage_rows(slot, kt, PB, RowRange{b0, B}, hx, Hp, none, i * kt);
            if constexpr (Q) {
              if (i == 0) stage_qproj(p, ring_slot(0), v0, 0, kt);
              if (i + 1 < ntiles)
                stage_qproj(p, ring_slot(i + 1), v0, (i + 1) * kt, kt);
            } else if constexpr (is_bf16<W>) {  // 16 bytes a load
              stage_rows_bf16(slot + xfl, kt, P_RT, RowRange{v0, V}, wp,
                              i * kt);
            } else {
              stage_rows(slot + xfl, kt, P_RT, RowRange{v0, V}, wp, Hp, none,
                         i * kt);
            }
          },
          [&](int it, const float* slot) {
            if constexpr (Q) {
              if (it == 0) {
                dequant(0);
                __syncthreads();
              }
            }
            if (active) {
              const float* xb = slot;
              const float* wb = slot + xfl;
#pragma unroll 4
              for (int kk = 0; kk < kt; kk += 4) {
                float4 wv[RV], xv[TB];
#pragma unroll
                for (int i = 0; i < RV; ++i)
                  wv[i] = ld4(wb + (tr + NRL * i) * (kt + 4) + kk);
#pragma unroll
                for (int j = 0; j < TB; ++j)
                  xv[j] = ld4(xb + (tb + NBL * j) * (kt + 4) + kk);
#pragma unroll
                for (int i = 0; i < RV; ++i)
#pragma unroll
                  for (int j = 0; j < TB; ++j)
                    acc[i][j] = fma4(wv[i], xv[j], acc[i][j]);
              }
            }
            if constexpr (Q) {
              if (it + 1 < ntiles) dequant(it + 1);
            }
          });

#pragma unroll
      for (int i = 0; i < RV; ++i) {
        const int r = tr + NRL * i, v = v0 + r;
        const float bv = v < V ? bias_at<Q, W>(p.b_proj, v) : 0.f;
#pragma unroll
        for (int j = 0; j < TB; ++j) {
          const int bl = tb + NBL * j, b = b0 + bl;
          if (!active) continue;
          float s = acc[i][j] + bv;
          if (p.sample) {  // proj_sample_kernel's score
            s = 0.f;
            if (v < V && b < B) {
              const size_t o = step + (size_t)b * V + v;
              const float u = p.u_in != nullptr ? p.u_in[o]
                                                : philox_uniform(p.seed, t, b, v);
              if (p.u_out != nullptr) __stcs(p.u_out + o, u);
              const float g = -logf(-logf(u + GUMBEL_EPS) + GUMBEL_EPS);
              if (p.noise != nullptr) store_cs(p.noise, o, g);
              s = (acc[i][j] + bv) + g;
            }
          }
          Ls[bl * LS + r] = s;
        }
      }
      __syncthreads();

      // pretrain logits, or z = temp * s into soft (rounded once, as the
      // statistics below see it; bfloat16: into the float32 zbuf, the
      // soft sample is rounded only when it is normalised), coalesced
      // along the vocabulary
      if (p.logits != nullptr || p.soft != nullptr) {
        for (int e = tid; e < PB * P_RT; e += NT) {
          const int bl = e / P_RT, r = e % P_RT, b = b0 + bl;
          if (b >= B || r >= n) continue;
          const size_t o = step + (size_t)b * V + v0 + r;
          const float z = Ls[bl * LS + r];
          if (p.logits != nullptr)
            store_cs(p.logits, o, z);
          else if constexpr (is_bf16<W>)
            p.zbuf[(size_t)b * V + v0 + r] = __fmul_rn(p.temp, z);
          else
            p.soft[o] = __fmul_rn(p.temp, z);
        }
      }
      // one thread per (batch row, tile): proj_tile_stats /
      // proj_sample_kernel's serial loops
      if (tid < PB && b0 + tid < B) {
        const float* row = Ls + tid * LS;
        const size_t o = (size_t)(b0 + tid) * ntile + tile;
        float m = -INFINITY, zm = -INFINITY;
        int arg = -1;
        for (int r = 0; r < n; ++r) {
          const float l = row[r];
          if (l > m) {  // strict: the first maximum wins
            m = l;
            arg = v0 + r;
          }
          if (p.sample) zm = fmaxf(zm, __fmul_rn(p.temp, l));
        }
        p.pmax[o] = m;
        p.pidx[o] = arg;
        if (!p.sample && p.lps != nullptr) {
          float s = 0.f;
          for (int r = 0; r < n; ++r) s += expf(row[r] - m);
          p.psum[o] = s;
        } else if (p.soft != nullptr) {
          float zs = 0.f;
          for (int r = 0; r < n; ++r) zs += expf(__fmul_rn(p.temp, row[r]) - zm);
          p.pzmax[o] = zm;
          p.pzsum[o] = zs;
        }
      }
      __syncthreads();  // Ls and the buffers are reused
    }
  }
}

// The lowest tile reaching the row's max of pm (first index on ties).
__device__ int first_argmax(const float* pm, int n, float* red_m,
                            int* red_i) {
  const int tid = threadIdx.x;
  float m = -INFINITY;
  int best = -1;
  for (int i = tid; i < n; i += NT) {
    const float v = ld_shared_global(pm + i);
    if (v > m) {
      m = v;
      best = i;
    }
  }
  red_m[tid] = m;
  red_i[tid] = best;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) {
      const float m2 = red_m[tid + s], m1 = red_m[tid];
      const int i2 = red_i[tid + s], i1 = red_i[tid];
      if (i2 >= 0 && (i1 < 0 || m2 > m1 || (m2 == m1 && i2 < i1))) {
        red_m[tid] = m2;
        red_i[tid] = i2;
      }
    }
    __syncthreads();
  }
  best = red_i[0];
  __syncthreads();
  return best;
}

// block_rescaled_sum's order exactly: 128 partial sums over the tiles
// i = tid mod 128, then the halving tree.
__device__ float rescaled_sum(const float* pm, const float* ps, int n,
                              float m, float* red) {
  const int tid = threadIdx.x;
  if (tid < F_NT) {
    float acc = 0.f;
    for (int i = tid; i < n; i += F_NT) {
      const float s = ld_shared_global(ps + i);
      acc += s * expf(ld_shared_global(pm + i) - m);
    }
    red[tid] = acc;
  }
  __syncthreads();
  for (int s = F_NT / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

// Phase 3: the rows of step t (a block per row): ids, lps or the soft
// row, and the next input x = embed[id].
template <bool Q, class W>
__device__ void combine_phase(const DecodeParams<W>& p, int t, float* red_m,
                              int* red_i, int* s_id) {
  const int tid = threadIdx.x, ntile = p.ntile, V = p.V, E = p.E;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const size_t base = (size_t)b * ntile;
    const int best = first_argmax(p.pmax + base, ntile, red_m, red_i);
    const int id = best >= 0 ? ld_shared_global(p.pidx + base + best) : 0;
    if (!p.sample && p.lps != nullptr) {
      const float m = best >= 0 ? ld_shared_global(p.pmax + base + best) : 0.f;
      const float total = rescaled_sum(p.pmax + base, p.psum + base, ntile, m,
                                       red_m);
      if (tid == 0) p.lps[(size_t)b * p.T + t] = -logf(total);
    } else if (p.sample && p.soft != nullptr) {
      float m = -INFINITY;  // the max of z: the max of the tile maxima
      for (int i = tid; i < ntile; i += NT)
        m = fmaxf(m, ld_shared_global(p.pzmax + base + i));
      red_m[tid] = m;
      __syncthreads();
      for (int s = NT / 2; s > 0; s >>= 1) {
        if (tid < s) red_m[tid] = fmaxf(red_m[tid], red_m[tid + s]);
        __syncthreads();
      }
      m = red_m[0];
      __syncthreads();
      const float total = rescaled_sum(p.pzmax + base, p.pzsum + base, ntile,
                                       m, red_m);
      // a batch of loads before the stores: the row is read and written
      // through one pointer, so one value at a time would serialise the
      // L2 round trips (bfloat16: z read from zbuf, the soft row written
      // rounded)
      W* row = p.soft + ((size_t)t * p.B + b) * V;
      const float* zrow;
      if constexpr (is_bf16<W>)
        zrow = p.zbuf + (size_t)b * V;
      else
        zrow = row;
      constexpr int NB = 8;
      for (int v0 = tid; v0 < V; v0 += NB * NT) {
        float z[NB];
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          const int v = v0 + q * NT;
          z[q] = v < V ? ld_shared_global(zrow + v) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          const int v = v0 + q * NT;
          if (v < V) store_cs(row, v, expf(z[q] - m) / total);
        }
      }
    }
    if (tid == 0) {
      p.ids[(size_t)b * p.T + t] = id;
      *s_id = id;
    }
    __syncthreads();
    const int row = *s_id;
    for (int e = tid; e < p.Ep; e += NT) {  // zeros in the pad columns
      float v = 0.f;
      if constexpr (Q) {
        if (e < E)
          v = round_to<W>(
              deq(qval(p.eq, p.bits, p.r_emb, E, row, e), p.escale[e]));
      } else {
        if (e < E) v = to_f(p.embed[(size_t)row * E + e]);
      }
      p.x[(size_t)b * p.Ep + e] = v;
      if (t == p.T - 1 && p.xT != nullptr && e < E)
        store_as(p.xT, (size_t)b * E + e, v);
    }
    __syncthreads();
  }
}

template <bool Q, class W>
__global__ void __launch_bounds__(NT, 1) decode_persistent_kernel(
    DecodeParams<W> p) {
  extern __shared__ float4 dyn_smem[];
  __shared__ float red_m[NT];
  __shared__ int red_i[NT];
  __shared__ int s_id;
  float* pool = reinterpret_cast<float*>(dyn_smem);
  int8_t* ring = reinterpret_cast<int8_t*>(pool + POOL_FLOATS);
  float* wres = pool + POOL_FLOATS + (Q ? RING_FLOATS : 0);
  const bool timed = p.prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long t0 = timed ? clk() : 0;
  auto mark = [&](int slot) {
    if (timed) {
      const unsigned long long now = clk();
      p.prof[slot] += now - t0;
      t0 = now;
    }
  };
  if (p.resident) load_resident<Q, W>(p, wres);
  __syncthreads();
  mark(PROF_LOAD);

  unsigned int target = 0;
  for (int t = 0; t < p.T; ++t) {
    const float* wres_l = wres;
    for (int l = 0; l < p.nl; ++l) {
      lstm_phase<Q, W>(p, t, l, wres_l, pool);
      wres_l += 4 * p.upb * row_pad(l, p.E, p.H);
      mark(PROF_LSTM);
      grid_barrier(p.barrier, target);
      mark(PROF_BARRIER);
    }
    if (p.pb == 8)
      proj_phase<Q, W, 4, 1, 8>(p, t, pool, ring);
    else if (p.pb == 16)
      proj_phase<Q, W, 4, 1, 16>(p, t, pool, ring);
    else if (p.pb == 32)
      proj_phase<Q, W, 4, 2, 16>(p, t, pool, ring);
    else
      proj_phase<Q, W, 4, 4, 16>(p, t, pool, ring);
    mark(PROF_PROJ);
    grid_barrier(p.barrier, target);
    mark(PROF_BARRIER);
    combine_phase<Q, W>(p, t, red_m, red_i, &s_id);
    mark(PROF_COMBINE);
    if (t + 1 < p.T) grid_barrier(p.barrier, target);
    mark(PROF_BARRIER);
  }
}

// Mode sample_embed, after the time loop: emb [R, Ed] = soft [R, V] @
// wd^T for the R = T*B rows of the soft sample, wd [Ed, V] the
// discriminator's embedding (torch layout).  A block owns 64 embedding
// columns and 32 soft rows: the register-tiled product of tile_dot.cuh.
// bfloat16 (W): the rounded soft sample and wd widened, the sum float32,
// emb rounded once (the TPU kernel's dot of soft.astype(bf16) with
// preferred_element_type=float32, then astype).
template <class W>
__global__ void __launch_bounds__(P_NT) embed_kernel(
    const W* __restrict__ wd, const W* __restrict__ soft, int V, int Ed,
    int R, W* __restrict__ emb) {
  __shared__ float Ws[P_RT][KT + 1];
  __shared__ float Xs[P_BT][KT + 1];
  constexpr int NR = P_RT / P_TR, NB = P_BT / P_TB;
  const int e0 = blockIdx.x * P_RT, r0 = blockIdx.y * P_BT;
  const int tid = threadIdx.x, tr = tid % NR, tb = tid / NR;

  float acc[P_TR][P_TB];
  tile_dot<P_RT, P_BT, P_TR, P_TB, ProjRows, W>(
      ProjRows{e0, Ed}, wd, static_cast<const W*>(nullptr), soft,
      static_cast<const W*>(nullptr), V, 0, r0, R, acc, Ws, Xs);
#pragma unroll
  for (int i = 0; i < P_TR; ++i) {
    const int e = e0 + tr + i * NR;
#pragma unroll
    for (int j = 0; j < P_TB; ++j) {
      const int r = r0 + tb + j * NB;
      if (e < Ed && r < R) store_as(emb, (size_t)r * Ed + e, acc[i][j]);
    }
  }
}

// The launch plan the wrapper computed (kernels/decode_sample.py:
// persistent_plan): blocks, units per block, resident (0/1), projection
// batch chunk (8, 16, 32 or 64) and dynamic shared-memory bytes.
struct Plan {
  int blocks, upb, resident, pb, smem;
};

unsigned long long* g_prof = nullptr;  // gic_decode_set_profile

// layer_ptrs: dense, (w_ih, w_hh, b_ih, b_hh) per layer; quantized (Q),
// (wq, its scales, bias) per layer.
template <bool Q, class W>
cudaError_t run(DecodeParams<W> p, const void* const* layer_ptrs,
                const int* plan_in, cudaStream_t s) {
  const Plan plan{plan_in[0], plan_in[1], plan_in[2], plan_in[3],
                  plan_in[4]};
  if (p.nl < 1 || p.nl > MAX_NL || plan.upb < 1 || plan.upb > MAX_UNITS ||
      (long long)plan.blocks * plan.upb < p.H ||
      (plan.pb != 8 && plan.pb != 16 && plan.pb != 32 && plan.pb != 64))
    return cudaErrorInvalidValue;
  const int want = (int)sizeof(float) *
                   (POOL_FLOATS + (Q ? RING_FLOATS : 0) +
                    (plan.resident ? resident_floats(p.nl, p.E, p.H, plan.upb)
                                   : 0));
  if (plan.smem != want) return cudaErrorInvalidValue;
  for (int l = 0; l < p.nl; ++l) {
    if constexpr (Q) {
      p.wq[l] = static_cast<const int8_t*>(layer_ptrs[3 * l]);
      p.wscale[l] = static_cast<const float*>(layer_ptrs[3 * l + 1]);
      p.b_ih[l] = layer_ptrs[3 * l + 2];
    } else {
      p.w_ih[l] = static_cast<const W*>(layer_ptrs[4 * l]);
      p.w_hh[l] = static_cast<const W*>(layer_ptrs[4 * l + 1]);
      p.b_ih[l] = layer_ptrs[4 * l + 2];
      p.b_hh[l] = layer_ptrs[4 * l + 3];
    }
  }
  p.upb = plan.upb;
  p.resident = plan.resident;
  p.pb = plan.pb;
  p.ntile = (p.V + P_RT - 1) / P_RT;
  p.Ep = pad4(p.E);
  p.Hp = pad4(p.H);
  p.prof = g_prof;
  if (p.Hp != p.H) {  // the pad columns of h are read (times zero weights)
    const cudaError_t err = cudaMemsetAsync(
        p.h, 0, sizeof(float) * 2 * p.nl * p.B * p.Hp, s);
    if (err != cudaSuccess) return err;
  }
  return launch_persistent(decode_persistent_kernel<Q, W>, p, p.barrier,
                           plan.blocks, NT, (size_t)plan.smem, s);
}

// W-typed pointers arrive as const void* (float or bfloat16 storage).
template <class W>
DecodeParams<W> base_params(const void* feats, const void* embed,
                            const void* w_proj, const void* b_proj, int B,
                            int E, int H, int V, int nl, int T, float* x,
                            float* h, float* c, float* pmax, int* pidx,
                            unsigned int* barrier, int32_t* ids) {
  DecodeParams<W> p = {};
  p.x_init = static_cast<const W*>(feats);
  p.embed = static_cast<const W*>(embed);
  p.w_proj = static_cast<const W*>(w_proj);
  p.b_proj = b_proj;
  p.B = B;
  p.E = E;
  p.H = H;
  p.V = V;
  p.nl = nl;
  p.T = T;
  p.x = x;
  p.h = h;
  p.c = c;
  p.pmax = pmax;
  p.pidx = pidx;
  p.barrier = barrier;
  p.ids = ids;
  p.temp = 1.f;
  return p;
}

// Greedy / serve.  Carried state (each pointer may be null): h0, c0
// [nl, B, H] and x0 [B, E] in place of h = c = 0 and x = feats; hT, cT
// [nl, B, H] and xT [B, E] receive the state after the last step.
// Outputs: ids, lps [B, T].
template <class W>
int decode_serve(const void* feats, const void* embed, const void* w_proj,
                 const void* b_proj, const void* const* layer_ptrs, int B,
                 int E, int H, int V, int nl, int T, const void* h0,
                 const float* c0, const void* x0, float* x, float* h,
                 float* c, float* pmax, int* pidx, float* psum, int32_t* ids,
                 float* lps, void* hT, float* cT, void* xT, const int* plan,
                 unsigned int* barrier, void* stream) {
  DecodeParams<W> p = base_params<W>(x0 != nullptr ? x0 : feats, embed,
                                     w_proj, b_proj, B, E, H, V, nl, T, x, h,
                                     c, pmax, pidx, barrier, ids);
  p.h0 = static_cast<const W*>(h0);
  p.c0 = c0;
  p.psum = psum;
  p.lps = lps;
  p.hT = static_cast<W*>(hT);
  p.cT = cT;
  p.xT = static_cast<W*>(xT);
  return run<false>(p, layer_ptrs, plan, static_cast<cudaStream_t>(stream));
}

// Mode pretrain: the greedy decode from (0, 0, feats) with the logits
// [T, B, V] of every step and no log-probabilities.
template <class W>
int decode_pretrain(const void* feats, const void* embed, const void* w_proj,
                    const void* b_proj, const void* const* layer_ptrs, int B,
                    int E, int H, int V, int nl, int T, float* x, float* h,
                    float* c, float* pmax, int* pidx, float* psum,
                    int32_t* ids, void* logits, const int* plan,
                    unsigned int* barrier, void* stream) {
  DecodeParams<W> p = base_params<W>(feats, embed, w_proj, b_proj, B, E, H, V,
                                     nl, T, x, h, c, pmax, pidx, barrier,
                                     ids);
  p.psum = psum;
  p.logits = static_cast<W*>(logits);
  return run<false>(p, layer_ptrs, plan, static_cast<cudaStream_t>(stream));
}

// The Gumbel-softmax sample with BPTT residuals.  Noise: u_in [T, B, V]
// when not null, else Philox keyed by `seed`; the uniforms used are copied
// to u_out [T, B, V] when it is not null.  Scratch statistics psmax /
// psidx / pzmax / pzsum [B, ntile]; zbuf [B, V] float32 (bfloat16 only,
// else null).  Outputs: ids [B, T], soft [T, B, V], hs/cs [T, nl, B, H],
// gates [T, nl, B, 4H].
template <class W>
int decode_sample_resid(
    const void* feats, const void* embed, const void* w_proj,
    const void* b_proj, const void* const* layer_ptrs, int B, int E, int H,
    int V, int nl, int T, float temp, unsigned long long seed,
    const float* u_in, float* u_out, float* x, float* h, float* c,
    float* psmax, int* psidx, float* pzmax, float* pzsum, float* zbuf,
    int32_t* ids, void* soft, void* hs, void* cs, void* gates,
    const int* plan, unsigned int* barrier, void* stream) {
  if (is_bf16<W> && zbuf == nullptr) return cudaErrorInvalidValue;
  DecodeParams<W> p = base_params<W>(feats, embed, w_proj, b_proj, B, E, H, V,
                                     nl, T, x, h, c, psmax, psidx, barrier,
                                     ids);
  p.sample = 1;
  p.temp = temp;
  p.seed = seed;
  p.u_in = u_in;
  p.u_out = u_out;
  p.pzmax = pzmax;
  p.pzsum = pzsum;
  p.zbuf = zbuf;
  p.soft = static_cast<W*>(soft);
  p.hs = static_cast<W*>(hs);
  p.cs = static_cast<W*>(cs);
  p.gates = static_cast<W*>(gates);
  return run<false>(p, layer_ptrs, plan, static_cast<cudaStream_t>(stream));
}

// Mode sample: ids = argmax(logits + g) and the noise g [T, B, V] (W).
template <class W>
int decode_sample_noise(const void* feats, const void* embed,
                        const void* w_proj, const void* b_proj,
                        const void* const* layer_ptrs, int B, int E, int H,
                        int V, int nl, int T, unsigned long long seed,
                        const float* u_in, float* x, float* h, float* c,
                        float* psmax, int* psidx, int32_t* ids, void* noise,
                        const int* plan, unsigned int* barrier,
                        void* stream) {
  DecodeParams<W> p = base_params<W>(feats, embed, w_proj, b_proj, B, E, H, V,
                                     nl, T, x, h, c, psmax, psidx, barrier,
                                     ids);
  p.sample = 1;
  p.seed = seed;
  p.u_in = u_in;
  p.noise = static_cast<W*>(noise);
  return run<false>(p, layer_ptrs, plan, static_cast<cudaStream_t>(stream));
}

template <class W>
int decode_qserve(const void* feats, const void* const* layer_ptrs,
                  const int8_t* pq, const float* ps, const float* pb,
                  const int8_t* eq, const float* es, int bits, int B, int E,
                  int H, int V, int R_emb, int nl, int T, const void* h0,
                  const float* c0, const void* x0, float* x, float* h,
                  float* c, float* pmax, int* pidx, float* psum, int32_t* ids,
                  float* lps, void* hT, float* cT, void* xT, const int* plan,
                  unsigned int* barrier, void* stream) {
  if (bits != 8 && bits != 4) return cudaErrorInvalidValue;
  DecodeParams<W> p = base_params<W>(x0 != nullptr ? x0 : feats, nullptr,
                                     nullptr, pb, B, E, H, V, nl, T, x, h, c,
                                     pmax, pidx, barrier, ids);
  p.pq = pq;
  p.pscale = ps;
  p.eq = eq;
  p.escale = es;
  p.bits = bits;
  p.r_emb = R_emb;
  p.h0 = static_cast<const W*>(h0);
  p.c0 = c0;
  p.psum = psum;
  p.lps = lps;
  p.hT = static_cast<W*>(hT);
  p.cT = cT;
  p.xT = static_cast<W*>(xT);
  return run<true>(p, layer_ptrs, plan, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Vocabulary rows per projection tile: the wrapper sizes the per-tile
// scratch ([B, ceil(V / tile)] per statistic) with it.
int gic_proj_tile(void) { return P_RT; }

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The current device's SM count and opt-in shared memory per block, for
// the wrapper's launch plan.
int gic_device_limits(int* n_sm, int* smem_optin) {
  return device_limits(n_sm, smem_optin);
}

// From now on the decode kernel adds its block 0's phase clocks (cycles:
// resident load, layer phases, barrier waits, projection, row combine)
// into prof [5] (device memory, zeroed by the caller); null turns it off.
int gic_decode_set_profile(unsigned long long* prof) {
  g_prof = prof;
  return 0;
}

// Registers per thread and spilled bytes of the persistent kernel, dense
// (quantized = 0) or quantized (1), float32 (bf16 = 0) or bfloat16 (1).
int gic_decode_kernel_attrs(int quantized, int bf16_, int* regs,
                            int* local_bytes) {
  cudaFuncAttributes a;
  const void* k =
      quantized ? (bf16_ ? (const void*)decode_persistent_kernel<true, bf16>
                         : (const void*)decode_persistent_kernel<true, float>)
                : (bf16_ ? (const void*)decode_persistent_kernel<false, bf16>
                         : (const void*)decode_persistent_kernel<false, float>);
  const cudaError_t err = cudaFuncGetAttributes(&a, k);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// Every entry point below is one cooperative launch of the persistent
// kernel on `stream` (sample_embed: and one embed_kernel launch).
// layer_ptrs holds 4*nl device pointers: w_ih [4H, In], w_hh [4H, H],
// b_ih and b_hh [4H] per layer; plan the five ints of Plan; barrier
// one device unsigned int.  Scratch: x [B, Ep], h [2, nl, B, Hp] (rows
// padded to 4 floats), c [nl, B, H], the per-tile statistics
// [B, ceil(V / 64)].  bf16 = 1 (every mode, and qserve):
// the weights, the biases of the dense decode, feats, h0, x0 and the
// outputs logits, noise, soft, emb, hs, cs, gates, hT and xT are bfloat16
// (the bfloat16 instantiation); the scratch, c0, cT, lps and the uniforms
// stay float32.  Returns 0 or the first CUDA error code
// (cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident);
// nothing synchronises.

int gic_decode_serve(const void* feats, const void* embed,
                     const void* w_proj, const void* b_proj,
                     const void* const* layer_ptrs, int B, int E, int H,
                     int V, int nl, int T, int bf16_, const void* h0,
                     const float* c0, const void* x0, float* x, float* h,
                     float* c, float* pmax, int* pidx, float* psum,
                     int32_t* ids, float* lps, void* hT, float* cT, void* xT,
                     const int* plan, unsigned int* barrier, void* stream) {
  return (bf16_ ? decode_serve<bf16> : decode_serve<float>)(
      feats, embed, w_proj, b_proj, layer_ptrs, B, E, H, V, nl, T, h0, c0,
      x0, x, h, c, pmax, pidx, psum, ids, lps, hT, cT, xT, plan, barrier,
      stream);
}

int gic_decode_pretrain(const void* feats, const void* embed,
                        const void* w_proj, const void* b_proj,
                        const void* const* layer_ptrs, int B, int E, int H,
                        int V, int nl, int T, int bf16_, float* x, float* h,
                        float* c, float* pmax, int* pidx, float* psum,
                        int32_t* ids, void* logits, const int* plan,
                        unsigned int* barrier, void* stream) {
  return (bf16_ ? decode_pretrain<bf16> : decode_pretrain<float>)(
      feats, embed, w_proj, b_proj, layer_ptrs, B, E, H, V, nl, T, x, h, c,
      pmax, pidx, psum, ids, logits, plan, barrier, stream);
}

int gic_decode_sample_resid(
    const void* feats, const void* embed, const void* w_proj,
    const void* b_proj, const void* const* layer_ptrs, int B, int E, int H,
    int V, int nl, int T, int bf16_, float temp, unsigned long long seed,
    const float* u_in, float* u_out, float* x, float* h, float* c,
    float* psmax, int* psidx, float* pzmax, float* pzsum, float* zbuf,
    int32_t* ids, void* soft, void* hs, void* cs, void* gates,
    const int* plan, unsigned int* barrier, void* stream) {
  return (bf16_ ? decode_sample_resid<bf16> : decode_sample_resid<float>)(
      feats, embed, w_proj, b_proj, layer_ptrs, B, E, H, V, nl, T, temp, seed,
      u_in, u_out, x, h, c, psmax, psidx, pzmax, pzsum, zbuf, ids, soft, hs,
      cs, gates, plan, barrier, stream);
}

// Mode sample: the Gumbel-max decode, ids = argmax(logits + g) per step,
// and the noise g [T, B, V]; no soft sample, no residuals.  bf16 = 1: the
// weights, their biases and feats bfloat16, the scores float32 and the
// noise rounded to bfloat16 (the TPU kernel's out_refs[1] in the compute
// dtype); the uniforms stay float32.
int gic_decode_sample(const void* feats, const void* embed,
                      const void* w_proj, const void* b_proj,
                      const void* const* layer_ptrs, int B, int E, int H,
                      int V, int nl, int T, int bf16_,
                      unsigned long long seed, const float* u_in, float* x,
                      float* h, float* c, float* psmax, int* psidx,
                      int32_t* ids, void* noise, const int* plan,
                      unsigned int* barrier, void* stream) {
  return (bf16_ ? decode_sample_noise<bf16> : decode_sample_noise<float>)(
      feats, embed, w_proj, b_proj, layer_ptrs, B, E, H, V, nl, T, seed,
      u_in, x, h, c, psmax, psidx, ids, noise, plan, barrier, stream);
}

// Mode sample_embed: sample_resid, then emb [T*B, Ed] = soft @ wd^T with
// wd [Ed, V] (one embed_kernel launch over all rows).  bf16 = 1: as
// gic_decode_sample_resid's bfloat16 instantiation (zbuf [B, V] float32
// required), with wd and emb bfloat16.
int gic_decode_sample_embed(
    const void* feats, const void* embed, const void* w_proj,
    const void* b_proj, const void* const* layer_ptrs, int B, int E, int H,
    int V, int nl, int T, int bf16_, float temp, unsigned long long seed,
    const float* u_in, const void* wd, int Ed, float* x, float* h, float* c,
    float* psmax, int* psidx, float* pzmax, float* pzsum, float* zbuf,
    int32_t* ids, void* soft, void* hs, void* cs, void* gates, void* emb,
    const int* plan, unsigned int* barrier, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      (bf16_ ? decode_sample_resid<bf16> : decode_sample_resid<float>)(
          feats, embed, w_proj, b_proj, layer_ptrs, B, E, H, V, nl, T, temp,
          seed, u_in, nullptr, x, h, c, psmax, psidx, pzmax, pzsum, zbuf, ids,
          soft, hs, cs, gates, plan, barrier, stream);
  if (err != 0) return err;
  const int R = T * B;
  const dim3 grid((Ed + P_RT - 1) / P_RT, (R + P_BT - 1) / P_BT);
  if (bf16_)
    embed_kernel<bf16><<<grid, P_NT, 0, s>>>(
        static_cast<const bf16*>(wd), static_cast<const bf16*>(soft), V, Ed,
        R, static_cast<bf16*>(emb));
  else
    embed_kernel<float><<<grid, P_NT, 0, s>>>(
        static_cast<const float*>(wd), static_cast<const float*>(soft), V, Ed,
        R, static_cast<float*>(emb));
  return cudaGetLastError();
}

// Serve on a weight-only quantized decoder (ops/quantize.py layout):
// layer_ptrs holds 3*nl device pointers, per layer the payload (int8
// [In+H, 4H], or packed [(In+H)/2, 4H]), its scale [4H] and the bias
// b_ih + b_hh [4H]; pq / ps / pb the projection (int8 [H, V], or packed
// [H/2, V]), its scale [V] and bias [V]; eq / es the embedding (int8
// [V, E], or packed [R_emb, E]) and its scale [E]; bits 8 or 4; the
// scales and biases float32.  bf16 = 1: the compute dtype is bfloat16
// (the TPU kernel's `x_ref.dtype`): every dequantized weight is rounded
// to bfloat16, feats, h0, x0, hT and xT are bfloat16; c0, cT and lps stay
// float32.  The rest as gic_decode_serve (plan: kernels/decode_sample.py:
// persistent_plan(..., quantized=True), whose shared memory holds the
// byte ring too).  cudaErrorInvalidValue for other bits.
int gic_decode_qserve(const void* feats, const void* const* layer_ptrs,
                      const int8_t* pq, const float* ps, const float* pb,
                      const int8_t* eq, const float* es, int bits, int bf16_,
                      int B, int E, int H, int V, int R_emb, int nl, int T,
                      const void* h0, const float* c0, const void* x0,
                      float* x, float* h, float* c, float* pmax, int* pidx,
                      float* psum, int32_t* ids, float* lps, void* hT,
                      float* cT, void* xT, const int* plan,
                      unsigned int* barrier, void* stream) {
  return (bf16_ ? decode_qserve<bf16> : decode_qserve<float>)(
      feats, layer_ptrs, pq, ps, pb, eq, es, bits, B, E, H, V, R_emb, nl, T,
      h0, c0, x0, x, h, c, pmax, pidx, psum, ids, lps, hT, cT, xT, plan,
      barrier, stream);
}

}  // extern "C"
