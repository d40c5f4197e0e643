// Backward of the fused sample -> discriminator-embedding decode (mode
// sample_embed) for Hopper (sm_90a), float32: the generator side.
//
// Replaces: gan_image_captioning_tpu/kernels/decode_sample.py, function
// `_embed_bwd_kernel` (launched by `decode_sample_embed_bwd`).  With R = T*B
// rows r = (t, b), the forward's soft sample soft [R, V] and top-layer
// hidden states h_top [R, H], the cotangent d_emb [R, Ed] of
// emb = soft @ wd^T, wd [Ed, V] and the projection w_proj [V, H]:
//   d_soft   = d_emb @ wd                                   [R, V]
//   d_logits = temp * soft * (d_soft - sum_v(d_soft * soft)) [R, V]
//   dWp      = h_top^T @ d_logits                           [H, V]
//   dbp      = sum_r d_logits                               [V]
//   d_htop   = d_logits @ w_proj                            [R, H]
//
// The TPU kernel walks time on its sequential grid, one step per grid
// index, accumulating dWp and dbp in VMEM.  No step depends on another, so
// here the R rows are one batch.
//
// What bounds it on this card.  At the training width (R = 2304, V = 11008,
// H = 512, Ed = 64) the three products are 2*R*V*(Ed + 2H) = 55.2 GFLOP:
// 0.82 ms at 67 TFLOP/s float32 without the tensor cores, against about
// 0.15 GB of inputs and outputs (0.045 ms).  So it is bound by operations,
// and a float32 SIMT product cannot beat cuBLAS's own (about 35 TFLOP/s).
//
// What this design does about it.  Every product runs on the tensor cores
// in 3xTF32 (mma.sync.m16n8k8): each float32 operand x is split into
// big = tf32(x) and small = tf32(x - big), and a*b is summed as
// a_small*b_big + a_big*b_small + a_big*b_big, float32 accumulate: three
// TF32 products (3 x 55.2 GFLOP at 495 TFLOP/s is 0.335 ms) with the
// precision of float32 operands (x is cut, not rounded, to its TF32 big
// part: one logic op; the error stays under 2^-20 |x| per operand).
// The tensor cores truncate (round toward
// zero) as they accumulate, which over K = 11008 would bias the sums, so
// each K tile of 32 is summed into a fresh accumulator and added to the
// running one with a rounded float32 add.  mma.sync, not wgmma: TF32
// wgmma reads K-major operands only, and dWp's operands (h_top and
// d_logits, K = R) are both R-major; mma.sync's fragments are loaded by
// the threads from tiles in any layout.  Tiles arrive by cp.async in a
// 3-stage ring (16-byte copies where every row is 16-byte aligned, else
// 4-byte copies); shared tiles are padded so every fragment load is free
// of bank conflicts.  Six launches in one C call:
//   1. se = soft @ wd^T [R, Ed], split over V into fixed partials (so
//      d_logits's row sum inner[r] = d_emb[r] . se[r] reads soft once
//      and d_soft never has to be written to be summed);
//   2. inner_kernel: inner[r], each sum in a fixed order;
//   3. d_logits = temp * soft * (d_emb @ wd - inner), written once from
//      the product's epilogue;
//   4. dWp = h_top^T @ d_logits; the blocks of the first H tile also sum
//      their d_logits tiles' columns in row order: dbp;
//   5. d_htop = d_logits @ w_proj, split over V (its 72 output tiles are
//      under one wave of 132 SMs) into partials;
//   6. reduce_kernel: d_htop, the partials summed in split order.
// No float atomics: every sum runs in a fixed order, and two calls on the
// same inputs give the same bits.  The splits and the scratch layout come
// from the wrapper's plan (decode_sample.embed_bwd_plan); the C side
// recomputes what it relies on and refuses a plan that does not match.
//
// bfloat16 (--dtype bfloat16, the TPU kernel under dt = bfloat16): h_top,
// soft, d_emb, w_proj and wd are bfloat16; d_soft, inner and d_logits are
// float32, and d_logits is rounded to bfloat16 (dl) before the two
// products that read it, as the TPU kernel's dl_c; dbp sums the float32
// d_logits; dWp and dbp come back float32, d_htop bfloat16.  bfloat16
// goes to the tensor cores as it is (no 3xTF32 split), float32 sums, each
// K tile summed into a fresh accumulator and added to the running one
// with a float32 add, as above.  At the training width the four products
// (d_soft = d_emb @ wd included) are 58.5 GFLOP: 0.059 ms at 989 TFLOP/s,
// against 0.09 GB of bfloat16 inputs and outputs (0.027 ms): bound by the
// operations.  What this design does about it:
//   * se, dWp and d_htop run on wgmma (gemm_wgmma_kernel): two
//     warpgroups a block, each 64 rows x (64, 192 or 2 x 128) columns;
//     stages of K = 64 arrive by 16-byte cp.async into a 4-deep ring of
//     128-byte-swizzled panels that wgmma reads through shared memory
//     descriptors, K-major (soft, dl as A; wd as B) or M- / N-major
//     (bfloat16 wgmma transposes: dWp's R-major h_top and dl, d_htop's
//     w_proj), so no operand is copied transposed and no fragment passes
//     through the registers.  Per stage a warpgroup issues its four k16
//     products into the fresh accumulator (scale-d 0 first), waits and
//     adds it to the running sum.
//   * Tiles sized for the card: dWp 128 x 192 (232 blocks, under two
//     waves), d_htop 128 x 256 split over V into one wave (3 splits, 108
//     blocks), se 128 x 64 two blocks an SM (14 splits, 252 blocks): a
//     split past one wave only adds partial sums to write and reduce.
//   * d_soft (K = Ed) on mma.sync m16n8k16 inside the d_logits pass
//     (fragments by ldmatrix, .trans for wd): a block keeps its d_emb rows
//     and walks DLB_CT column tiles, the next tile's wd and soft landing
//     by cp.async while this one is written; dl leaves through shared memory
//     in 16-byte rows, with per 64-row tile the float32 column sums of
//     d_logits, which dWp's blocks of the first H tile add up in row-tile
//     order: dbp costs no launch of its own.
// Six launches in one C call:
//   1. the se partials = soft @ wd^T, split over V;
//   2. inner_kernel: inner[r];
//   3. d_logits_bf16_kernel: dl and the column sums;
//   4. dWp = h_top^T @ dl, and dbp;
//   5. the d_htop partials = dl @ w_proj, split over V;
//   6. reduce_kernel: d_htop, the partials in split order, rounded once.
// Rows that are not 16-byte aligned (H, V or Ed not a multiple of 8) are
// staged element by element into the same layouts (a right path for small
// shapes).  What holds it back: the products' tiles come from L2 at
// about 4 TB/s, and a fresh accumulator beside the running one (twice
// the registers) caps a block's tile at 128 x 256, so dWp and d_htop are
// bound by those loads; dl makes a round trip through device memory
// between launches 3 and 4-5.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

using gic::bf16;
using gic::to_f;

namespace {

constexpr int STAGES = 3, R_NT = 256;
// The tiles (M x N x K) of the two products split over K = V: se and
// d_htop.  The wrapper's plan (decode_sample.EB_SE_TILE, EB_HTOP_TILE)
// chooses the splits from the same numbers; split_ok refuses a chunk that
// is not a whole number of these K tiles.
constexpr int SE_BM = 128, SE_BN = 64, SE_BK = 32;
constexpr int HT_BM = 128, HT_BN = 128, HT_BK = 64;

struct GemmArgs {
  const float* A;  // [M, K] (lda) or, A_KM, [K, M]
  const float* B;  // [K, N] (ldb) or, B_NK, [N, K]
  int lda, ldb, M, N, K, k_chunk;
  float* C;        // [splits][M, ldc]
  int ldc;
  size_t split_stride;
  float* colsum;       // COLSUM: [N], from the blocks of M tile 0
  int m_fast;          // neighbouring blocks walk M (1) or N (0) tiles
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (0-16) from src, zero-filling the rest of 16.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A thread's share of copying ROWS x COLS tiles (COLS contiguous) of a
// row-major matrix into shared memory of row stride SLD, one tile per K
// step.  K_ROWS: the tiles' rows run along K (their columns along M or N);
// else their columns do.  A thread copies IT pieces of W floats, RSTEP
// rows apart; its addresses and the M / N bounds are worked out once, K's
// bound on each tile (zeros past k_end).  VEC: 16-byte pieces (ld, the
// base and every piece 16-byte aligned).
template <int ROWS, int COLS, int SLD, int NT, bool VEC, bool K_ROWS>
struct TileCopy {
  static constexpr int W = VEC ? 4 : 1, CH = COLS / W;
  static constexpr int IT = ROWS * CH / NT, RSTEP = NT / CH;
  static_assert(NT % CH == 0 && ROWS * CH % NT == 0, "tile copy shape");
  const float* g;    // the matrix: a valid address for empty pieces
  const float* src;  // this thread's first piece at k_begin
  int ld, dst, kpos;
  unsigned fixed;    // K_ROWS: bytes of each piece inside N; else a bit
                     // per piece whose row is inside M / N

  __device__ __forceinline__ TileCopy(const float* g_, int ld_, int f0,
                                      int f_lim, int k_begin)
      : g(g_), ld(ld_) {
    const int rr = threadIdx.x / CH, cc = threadIdx.x % CH * W;
    dst = rr * SLD + cc;
    if (K_ROWS) {
      src = g + (size_t)(k_begin + rr) * ld + f0 + cc;
      fixed = 4 * max(0, min(W, f_lim - f0 - cc));
      kpos = rr;
    } else {
      src = g + (size_t)(f0 + rr) * ld + k_begin + cc;
      fixed = 0;
#pragma unroll
      for (int it = 0; it < IT; ++it)
        if (f0 + rr + it * RSTEP < f_lim) fixed |= 1u << it;
      kpos = cc;
    }
  }

  // The tile kt_off floats of K past k_begin; `left` of K remain there.
  __device__ __forceinline__ void copy(float* s, int kt_off, int left) const {
    const float* base = K_ROWS ? src + (size_t)kt_off * ld : src + kt_off;
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      int bytes;
      if (K_ROWS) {
        bytes = kpos + it * RSTEP < left ? (int)fixed : 0;
      } else {
        const int kl = left - kpos;
        bytes = fixed >> it & 1u ? 4 * max(0, min(W, kl)) : 0;
      }
      const float* p = bytes ? base + (size_t)it * RSTEP * ld : g;
      float* d = s + dst + it * RSTEP * SLD;
      if (VEC)
        cp_async16(d, p, bytes);
      else
        cp_async4(d, p, bytes);
    }
  }
};

// x = big + small: big is x cut to TF32 (its low 13 bits cleared),
// small = x - big exactly, passed with all its bits: the tensor cores read
// a TF32 operand's top 19 bits and ignore the rest, so small is cut to
// TF32 there (|small| < 2^-10 |x|: an error under 2^-20 |x|).  One logic
// op and one float add: no conversion instructions.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a * b (ZERO: d = a * b).  Not volatile: the compiler may interleave
// independent products.
template <bool ZERO = false>
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

template <int BM, int BN, int BK, bool A_KM, bool B_NK>
struct Tiles {
  static constexpr int ALD = A_KM ? BM + 8 : BK + 4;   // conflict-free
  static constexpr int BLD = B_NK ? BK + 4 : BN + 8;   // fragment loads
  static constexpr int A_STAGE = A_KM ? BK * ALD : BM * ALD;
  static constexpr int B_STAGE = B_NK ? BN * BLD : BK * BLD;
  static constexpr int BYTES = 4 * STAGES * (A_STAGE + B_STAGE);
};

// C = A @ B over the block's K chunk, in 3xTF32.  A block of
// (BM/WM)*(BN/WN) warps owns a BM x BN tile of one split; a warp owns
// WM x WN, as (WM/16) x (WN/8) mma tiles; MINB blocks share an SM.  Grid:
// splits * tiles, the splits outermost.
template <int BM, int BN, int BK, int WM, int WN, int MINB, bool A_KM,
          bool B_NK, bool COLSUM, bool VEC>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, MINB)
    gemm_3xtf32_kernel(GemmArgs g) {
  constexpr int NT = (BM / WM) * (BN / WN) * 32, MI = WM / 16, NJ = WN / 8;
  using Ti = Tiles<BM, BN, BK, A_KM, B_NK>;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + STAGES * Ti::A_STAGE;

  const int mt = (g.M + BM - 1) / BM, nt = (g.N + BN - 1) / BN;
  const int tiles = mt * nt, split = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int tm = g.m_fast ? tile % mt : tile / nt;
  const int tn = g.m_fast ? tile / mt : tile % nt;
  const int m0 = tm * BM, n0 = tn * BN;
  const int k_begin = split * g.k_chunk;
  const int k_end = min(g.K, k_begin + g.k_chunk);
  const int n_kt = (k_end - k_begin + BK - 1) / BK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = (warp % (BM / WM)) * WM, wn = (warp / (BM / WM)) * WN;

  using ACopy = TileCopy<A_KM ? BK : BM, A_KM ? BM : BK, Ti::ALD, NT, VEC,
                         A_KM>;
  using BCopy = TileCopy<B_NK ? BN : BK, B_NK ? BK : BN, Ti::BLD, NT, VEC,
                         !B_NK>;
  const ACopy a_copy(g.A, g.lda, m0, g.M, k_begin);
  const BCopy b_copy(g.B, g.ldb, n0, g.N, k_begin);
  auto load_stage = [&](int kt, int slot) {
    const int left = k_end - k_begin - kt * BK;
    a_copy.copy(As + slot * Ti::A_STAGE, kt * BK, left);
    b_copy.copy(Bs + slot * Ti::B_STAGE, kt * BK, left);
  };

  float acc[MI][NJ][4], part[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  float colsum = 0.f;
  const bool sums = COLSUM && tm == 0 && tid < BN;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_kt) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < n_kt)
      load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const float* as = As + (kt % STAGES) * Ti::A_STAGE;
    const float* bs = Bs + (kt % STAGES) * Ti::B_STAGE;
    if (sums) {  // rows past K are zeros
#pragma unroll 8
      for (int k = 0; k < BK; ++k) colsum += bs[k * Ti::BLD + tid];
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ab[MI][4], asm_[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = wm + i * 16 + gq + (c & 1) * 8;
          const int k = kk + tq + (c >> 1) * 4;
          split_tf32(A_KM ? as[k * Ti::ALD + m] : as[m * Ti::ALD + k],
                     ab[i][c], asm_[i][c]);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = wn + j * 8 + gq;
        uint32_t bb[2], bsm[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int k = kk + tq + c * 4;
          split_tf32(B_NK ? bs[n * Ti::BLD + k] : bs[k * Ti::BLD + n], bb[c],
                     bsm[c]);
        }
        // the small terms first; MI independent tiles between two
        // products into the same one
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          if (kk == 0)  // the tile's first product starts its sum
            mma_tf32<true>(part[i][j], asm_[i], bb[0], bb[1]);
          else
            mma_tf32(part[i][j], asm_[i], bb[0], bb[1]);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
          mma_tf32(part[i][j], ab[i], bsm[0], bsm[1]);
#pragma unroll
        for (int i = 0; i < MI; ++i)
          mma_tf32(part[i][j], ab[i], bb[0], bb[1]);
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];
  }
  cp_async_wait<0>();

  if (sums && n0 + tid < g.N) g.colsum[n0 + tid] = colsum;
  // a thread holds columns n, n + 1 of rows r and r + 8 of each mma tile:
  // float2 stores where the rows are 16-byte aligned (VEC)
  float* C = g.C + (size_t)split * g.split_stride;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + i * 16 + gq + h * 8;
        const int n = n0 + wn + j * 8 + tq * 2;
        if (r >= g.M) continue;
        const size_t at = (size_t)r * g.ldc + n;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (VEC && n + 1 < g.N) {
          *reinterpret_cast<float2*>(C + at) = make_float2(v0, v1);
        } else {
          if (n < g.N) C[at] = v0;
          if (n + 1 < g.N) C[at + 1] = v1;
        }
      }
}

// d_logits = temp * soft * (d_emb @ wd - inner), float32 FMAs (K = Ed is
// short: the product is 6 % of the work, and the pass is bound by the
// bytes of soft read and d_logits written).  A block owns DL_BM rows x
// DL_BN columns; a thread 4 rows x 8 columns (two float4 runs 64 apart),
// each a fmaf chain over e ascending from 0.  VEC: float4 global accesses.
constexpr int DL_BM = 64, DL_BN = 128, DL_BE = 32, DL_NT = 256;

template <bool VEC>
__global__ void __launch_bounds__(DL_NT) d_logits_kernel(
    const float* __restrict__ d_emb, const float* __restrict__ wd,
    const float* __restrict__ soft, const float* __restrict__ inner,
    int R, int V, int Ed, float temp, float* __restrict__ d_logits) {
  __shared__ __align__(16) float es[DL_BE][DL_BM + 4];  // d_emb^T chunk
  __shared__ __align__(16) float ws[DL_BE][DL_BN];      // wd chunk
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * DL_BM, n0 = blockIdx.x * DL_BN;
  float acc[4][8] = {};
  for (int e0 = 0; e0 < Ed; e0 += DL_BE) {
    for (int i = tid; i < DL_BM * DL_BE; i += DL_NT) {
      const int m = i / DL_BE, e = i % DL_BE;
      es[e][m] = m0 + m < R && e0 + e < Ed
                     ? d_emb[(size_t)(m0 + m) * Ed + e0 + e] : 0.f;
    }
    if (VEC) {
      for (int i = tid; i < DL_BE * DL_BN / 4; i += DL_NT) {
        const int e = i / (DL_BN / 4), n = (i % (DL_BN / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e0 + e < Ed && n0 + n < V)  // V % 4 == 0: whole float4s
          v = *reinterpret_cast<const float4*>(wd + (size_t)(e0 + e) * V +
                                               n0 + n);
        *reinterpret_cast<float4*>(&ws[e][n]) = v;
      }
    } else {
      for (int i = tid; i < DL_BE * DL_BN; i += DL_NT) {
        const int e = i / DL_BN, n = i % DL_BN;
        ws[e][n] = e0 + e < Ed && n0 + n < V
                       ? wd[(size_t)(e0 + e) * V + n0 + n] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int e = 0; e < DL_BE; ++e) {
      const float4 a = *reinterpret_cast<const float4*>(&es[e][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[e][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[e][64 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= R) continue;
    const float in = inner[r];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      const size_t at = (size_t)r * V + n;
      if (VEC && n + 3 < V) {
        const float4 sv = *reinterpret_cast<const float4*>(soft + at);
        const float* a = acc[i] + h * 4;
        *reinterpret_cast<float4*>(d_logits + at) = make_float4(
            temp * sv.x * (a[0] - in), temp * sv.y * (a[1] - in),
            temp * sv.z * (a[2] - in), temp * sv.w * (a[3] - in));
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n + c < V)
            d_logits[at + c] = temp * soft[at + c] * (acc[i][h * 4 + c] - in);
      }
    }
  }
}

// inner[r] = sum_e d_emb[r, e] * (sum_s part[s, r, e]): one warp per row,
// the splits in order, lanes over e, then a fixed shuffle tree.  d_emb in
// T (float, or bfloat16 widened).
template <class T>
__global__ void __launch_bounds__(R_NT) inner_kernel(
    const float* __restrict__ part, int splits, const T* __restrict__ d_emb,
    int R, int Ed, float* __restrict__ inner) {
  const int r = blockIdx.x * (R_NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  float acc = 0.f;
  for (int e = lane; e < Ed; e += 32) {
    float se = 0.f;
    for (int s = 0; s < splits; ++s) se += part[((size_t)s * R + r) * Ed + e];
    acc = fmaf(to_f(d_emb[(size_t)r * Ed + e]), se, acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) inner[r] = acc;
}

// out[i] = sum_s part[s * n + i], the splits in order, stored as T (a
// bfloat16 out rounded once).
template <class T>
__global__ void __launch_bounds__(R_NT) reduce_kernel(
    const float* __restrict__ part, int splits, size_t n,
    T* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * R_NT + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * n + i];
  gic::store_as(out, i, acc);
}

// ---------------------------------------------------------------- bfloat16

// The bfloat16 products: raw 16-bit words A [M, K] or, A_MN, [K, M]; B
// [K, N] or, B_NK, [N, K]; C float32 as GemmArgs's.  dbp: the dWp launch's
// blocks of M tile 0 also sum, per column, the d_logits pass's column sums
// colpart [row_tiles, N] in row-tile order into dbp [N].
struct GemmArgs16 {
  const uint16_t* A;
  const uint16_t* B;
  int lda, ldb, M, N, K, k_chunk;
  float* C;
  int ldc;
  size_t split_stride;
  int m_fast;
  const float* colpart;
  int row_tiles;
  float* dbp;
};

// The d_logits pass's d_soft product (mma.sync): BF_FOLD, the K summed
// into a fresh accumulator before it is added to the running sum.
// scripts/embed_bwd_variants.py builds and times other values of it and
// of the WG_* and DLB_* constants below.
constexpr int BF_FOLD = 64;
static_assert(BF_FOLD % 16 == 0, "fresh accumulators over whole products");

// A ROWS x COLS tile (COLS contiguous in global, row stride ld) at (row0,
// col0) into s (row stride LD), zeros past row_lim / col_lim.  VEC: 16-byte
// cp.async copies (8 words; ld, the base and col_lim multiples of 8 words),
// zero-filled past the limits, left in flight for the caller's group;
// else element by element, stored at once.
template <int ROWS, int COLS, int LD, int NT, bool VEC>
__device__ __forceinline__ void copy_tile16(uint16_t* s, const uint16_t* g,
                                            int ld, int row0, int row_lim,
                                            int col0, int col_lim) {
  if constexpr (VEC) {
    constexpr int CH = COLS / 8;
    static_assert(ROWS * CH % NT == 0, "tile copy shape");
#pragma unroll
    for (int it = 0; it < ROWS * CH / NT; ++it) {
      const int i = threadIdx.x + it * NT;
      const int r = i / CH, c = i % CH * 8;
      const bool ok = row0 + r < row_lim && col0 + c < col_lim;
      cp_async16(s + r * LD + c,
                 ok ? g + (size_t)(row0 + r) * ld + col0 + c : g,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      s[r * LD + c] = row0 + r < row_lim && col0 + c < col_lim
                          ? g[(size_t)(row0 + r) * ld + col0 + c]
                          : (uint16_t)0;
    }
  }
}

// Four 8 x 8 matrices of 16-bit words from shared memory, one row address
// a lane (lanes 8j .. 8j + 7: matrix j); TRANS: each transposed.
template <bool TRANS>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const uint16_t* p) {
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

// The m16n8k16 A fragment of rows m0 .. m0 + 15, columns k0 .. k0 + 15 of
// a [M][K] tile of row stride ld (register c: row gq + 8 (c & 1), columns
// 2 tq + 8 (c >> 1) and the next).
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint16_t* s,
                                       int ld, int m0, int k0, int lane) {
  const int r = lane & 7, j = lane >> 3;
  ldsm4<false>(a, s + (m0 + r + 8 * (j & 1)) * ld + k0 + 8 * (j >> 1));
}

// The B fragments of columns n0 .. n0 + 7 (b[0], b[1]) and n0 + 8 .. n0 +
// 15 (b[2], b[3]) at k0 .. k0 + 15 (register c of a column: rows 2 tq + 8 c
// and the next, column gq): from a [K][N] tile transposed by ldmatrix, or
// from an [N][K] one (B_NK) as stored.
template <bool B_NK, int LD>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const uint16_t* s,
                                       int n0, int k0, int lane) {
  const int r = lane & 7, j = lane >> 3;
  if constexpr (B_NK)
    ldsm4<false>(b, s + (n0 + r + 8 * (j >> 1)) * LD + k0 + 8 * (j & 1));
  else
    ldsm4<true>(b, s + (k0 + r + 8 * (j & 1)) * LD + n0 + 8 * (j >> 1));
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  const bf16 h = __float2bfloat16_rn(x);
  return *reinterpret_cast<const uint16_t*>(&h);
}

// d += a * b in bfloat16 with a float32 accumulator (ZERO: d = a * b).
template <bool ZERO = false>
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if (ZERO)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d_logits = temp * soft * (d_emb @ wd - inner) from bfloat16 d_emb, wd
// and soft: d_soft on the tensor cores (mma.sync m16n8k16; K = Ed, in
// fresh accumulators of BF_FOLD), then per entry the float32 expression of
// the float32 kernel; dl written rounded to bfloat16, and per column tile
// the block's float32 column sums of d_logits over its DLB_BM rows (each
// thread's rows in order, then a fixed shuffle tree over the 8 row groups
// of a warp, then the two warps of a column in order) into colpart [row
// tile, V].  A block owns DLB_BM rows and DLB_CT neighbouring column tiles
// of DLB_BN: its d_emb rows are staged once (fragments by ldmatrix), and
// the next tile's wd and soft land by cp.async while this one is
// multiplied and written (two buffers); the soft tile is overwritten in
// place by dl, which leaves in 16-byte rows.  Grid (column tile groups,
// row tiles); dynamic shared memory dlb_smem(Ed).
constexpr int DLB_BM = 64;   // the rows of a column-sum tile (EB_DL_ROWS)
constexpr int DLB_BN = 128;
constexpr int DLB_WM = 32;
constexpr int DLB_WN = 32;
constexpr int DLB_CT = 4;    // column tiles a block
constexpr int DLB_MINB = 2;  // blocks an SM (launch bounds)
constexpr int DLB_NT = (DLB_BM / DLB_WM) * (DLB_BN / DLB_WN) * 32;
constexpr int DLB_SLD = DLB_BN + 8;  // soft / dl and wd rows (words)

// Ed padded to whole k16 steps, and a d_emb row of it (words)
__host__ __device__ inline int dlb_ek(int Ed) { return (Ed + 15) / 16 * 16; }
__host__ __device__ inline int dlb_eld(int Ed) { return dlb_ek(Ed) + 8; }
// bytes: the d_emb tile, then two buffers of (wd tile, soft tile)
__host__ __device__ inline int dlb_smem(int Ed) {
  return 2 * (DLB_BM * dlb_eld(Ed) +
              2 * (dlb_ek(Ed) * DLB_SLD + DLB_BM * DLB_SLD));
}

template <bool VEC>
__global__ void __launch_bounds__(DLB_NT, DLB_MINB) d_logits_bf16_kernel(
    const uint16_t* __restrict__ d_emb, const uint16_t* __restrict__ wd,
    const uint16_t* __restrict__ soft, const float* __restrict__ inner,
    int R, int V, int Ed, float temp, uint16_t* __restrict__ dl,
    float* __restrict__ colpart) {
  constexpr int MI = DLB_WM / 16, NJ = DLB_WN / 8;
  extern __shared__ __align__(16) uint16_t smem16[];
  __shared__ float cs[DLB_BM / DLB_WM][DLB_BN];
  const int ek = dlb_ek(Ed), eld = dlb_eld(Ed);
  uint16_t* const es = smem16;                    // d_emb [DLB_BM][eld]
  uint16_t* const buf0 = es + DLB_BM * eld;       // wd [ek][SLD], soft
  const int buf_words = ek * DLB_SLD + DLB_BM * DLB_SLD;
  const int m0 = blockIdx.y * DLB_BM;
  const int c0 = blockIdx.x * DLB_CT;
  const int n_ct = min(DLB_CT, (V + DLB_BN - 1) / DLB_BN - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = (warp % (DLB_BM / DLB_WM)) * DLB_WM;
  const int wn = (warp / (DLB_BM / DLB_WM)) * DLB_WN;

  // a column tile's wd rows (zeros past Ed up to ek) and soft tile
  auto stage = [&](int c, int b) {
    uint16_t* ws = buf0 + b * buf_words;
    uint16_t* ss = ws + ek * DLB_SLD;
    const int n0 = (c0 + c) * DLB_BN;
    for (int e0 = 0; e0 < ek; e0 += 16)  // whole copies of 16 rows
      copy_tile16<16, DLB_BN, DLB_SLD, DLB_NT, VEC>(
          ws + e0 * DLB_SLD, wd, V, e0, Ed, n0, V);
    copy_tile16<DLB_BM, DLB_BN, DLB_SLD, DLB_NT, VEC>(ss, soft, V, m0, R,
                                                      n0, V);
  };
  // the block's d_emb rows and the first tile, one group; each later
  // tile's group is issued one tile ahead
  if constexpr (VEC) {
    const int ch = ek / 8;
    for (int i = tid; i < DLB_BM * ch; i += DLB_NT) {
      const int r = i / ch, c = i % ch * 8;
      const bool ok = m0 + r < R && c < Ed;
      cp_async16(es + r * eld + c,
                 ok ? d_emb + (size_t)(m0 + r) * Ed + c : d_emb,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < DLB_BM * ek; i += DLB_NT) {
      const int r = i / ek, c = i % ek;
      es[r * eld + c] = m0 + r < R && c < Ed
                            ? d_emb[(size_t)(m0 + r) * Ed + c]
                            : (uint16_t)0;
    }
  }
  stage(0, 0);
  cp_async_commit();
  float rin[MI][2];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + i * 16 + gq + h * 8;
      rin[i][h] = r < R ? inner[r] : 0.f;
    }

  for (int c = 0; c < n_ct; ++c) {
    const int b = c & 1;
    if (c + 1 < n_ct) stage(c + 1, b ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile c (and d_emb) landed
    uint16_t* const ws = buf0 + b * buf_words;
    uint16_t* const ss = ws + ek * DLB_SLD;

    float acc[MI][NJ][4], part[MI][NJ][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    for (int k0 = 0; k0 < ek; k0 += 16) {
      uint32_t a[MI][4], bb[NJ / 2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        frag_a(a[i], es, eld, wm + i * 16, k0, lane);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp)
        frag_b<false, DLB_SLD>(bb[jp], ws, wn + jp * 16, k0, lane);
      const bool fresh = k0 % BF_FOLD == 0;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const uint32_t b0 = bb[j >> 1][2 * (j & 1)];
          const uint32_t b1 = bb[j >> 1][2 * (j & 1) + 1];
          if (fresh)
            mma_bf16<true>(part[i][j], a[i], b0, b1);
          else
            mma_bf16(part[i][j], a[i], b0, b1);
        }
      if ((k0 + 16) % BF_FOLD == 0 || k0 + 16 >= ek) {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
      }
    }

    float csum[NJ][2] = {};
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wm + i * 16 + gq + h * 8;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            uint16_t& w = ss[rl * DLB_SLD + wn + j * 8 + tq * 2 + e];
            const float sv = __uint_as_float((uint32_t)w << 16);
            const float d = temp * sv * (acc[i][j][2 * h + e] - rin[i][h]);
            w = (uint16_t)bf16_bits(d);   // zero past R and V: soft is 0
            csum[j][e] += d;
          }
      }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = csum[j][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (gq == 0) cs[wm / DLB_WM][wn + j * 8 + tq * 2 + e] = v;
      }
    __syncthreads();  // dl and the warps' column sums are in
    const int n0 = (c0 + c) * DLB_BN;
    if (tid < DLB_BN && n0 + tid < V) {
      float sum = 0.f;
#pragma unroll
      for (int y = 0; y < DLB_BM / DLB_WM; ++y) sum += cs[y][tid];
      colpart[(size_t)blockIdx.y * V + n0 + tid] = sum;
    }
    if constexpr (VEC) {
      constexpr int CH = DLB_BN / 8;
      for (int i = tid; i < DLB_BM * CH; i += DLB_NT) {
        const int r = i / CH, q = i % CH * 8;
        if (m0 + r < R && n0 + q < V)
          *reinterpret_cast<uint4*>(dl + (size_t)(m0 + r) * V + n0 + q) =
              *reinterpret_cast<const uint4*>(ss + r * DLB_SLD + q);
      }
    } else {
      for (int i = tid; i < DLB_BM * DLB_BN; i += DLB_NT) {
        const int r = i / DLB_BN, q = i % DLB_BN;
        if (m0 + r < R && n0 + q < V)
          dl[(size_t)(m0 + r) * V + n0 + q] = ss[r * DLB_SLD + q];
      }
    }
    __syncthreads();  // buffer b and cs are free for the tile after next
  }
}

// d (+)= A B for one warpgroup: m64n128k16, bfloat16 operands from shared
// memory (descriptors da, db), float32 sums in d; ACC 0: d = A B (a fresh
// sum).  TA / TB: the operand is stored M- / N-major (transposed).
template <int ACC, int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(ACC), "n"(TA), "n"(TB));
}

template <int ACC, int TA, int TB>
__device__ __forceinline__ void wgmma_m64n192(float (&d)[96], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "n"(ACC), "n"(TA), "n"(TB));
}

template <int ACC, int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(ACC), "n"(TA), "n"(TB));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Shared memory written by the threads (cp.async, stores) made visible to
// the tensor cores' reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The wgmma tiles: panels of 64 columns x `rows` rows of 128 bytes, 16-byte
// chunks swizzled within each 8-row group (chunk ^ row % 8: the 128-byte
// swizzle), each panel 1024-byte aligned.  WG_BK: K a stage (64).
constexpr int WG_BK = 64;
// dWp's and d_htop's wgmma width (128 or 192 columns), the products a
// warpgroup runs per stage one after another (a block's tile is 128 x
// WG_*_N * WG_*_HALVES), and their rings' stages
constexpr int WG_DWP_N = 192;
constexpr int WG_DWP_HALVES = 1;
constexpr int WG_DWP_STAGES = 4;
constexpr int WG_HT_N = 128;
constexpr int WG_HT_HALVES = 2;
constexpr int WG_HT_STAGES = 4;
constexpr int WG_SE_STAGES = 4;

__device__ __forceinline__ int sw128(int r, int c, int rows) {
  return (c >> 6) * rows * 128 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
         ((c & 7) << 1);
}

// The shared memory descriptor of a 128-byte-swizzled operand at smem
// address `addr`: leading and stride byte offsets lbo, sbo.
__device__ __forceinline__ uint64_t wg_desc(unsigned addr, unsigned lbo,
                                            unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         (uint64_t)((lbo & 0x3FFFFu) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFFu) >> 4) << 32 | (uint64_t)1 << 62;
}

// A ROWS x COLS tile (COLS contiguous in global, row stride ld) at (row0,
// col0) into the swizzled panels at s, zeros past row_lim / col_lim: by
// 16-byte cp.async (VEC), else element by element.
template <int ROWS, int COLS, int NT, bool VEC>
__device__ __forceinline__ void copy_sw128(unsigned char* s,
                                           const uint16_t* g, int ld,
                                           int row0, int row_lim, int col0,
                                           int col_lim) {
  if constexpr (VEC) {
    constexpr int CH = COLS / 8;
    static_assert(ROWS * CH % NT == 0, "tile copy shape");
#pragma unroll
    for (int it = 0; it < ROWS * CH / NT; ++it) {
      const int i = threadIdx.x + it * NT;
      const int r = i / CH, c = i % CH * 8;
      const bool ok = row0 + r < row_lim && col0 + c < col_lim;
      cp_async16(s + sw128(r, c, ROWS),
                 ok ? g + (size_t)(row0 + r) * ld + col0 + c : g,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      *reinterpret_cast<uint16_t*>(s + sw128(r, c, ROWS)) =
          row0 + r < row_lim && col0 + c < col_lim
              ? g[(size_t)(row0 + r) * ld + col0 + c]
              : (uint16_t)0;
    }
  }
}

// C = A @ B over the block's K chunk on wgmma: two warpgroups, each 64
// rows of the block's 128 and HALVES x WN columns; A [M, K] or, A_MN,
// [K, M]; B [K, N] (N-major: the transposed wgmma operand).  Stages of
// WG_BK arrive by cp.async in a ring of STAGES; per stage and half a
// warpgroup issues its four k16 products into a fresh accumulator (part,
// the first with scale-d 0), waits for them and adds part to the running
// sum with float32 adds (the tensor cores truncate as they accumulate).
// Grid: splits * tiles, the splits outermost; neighbouring blocks walk M
// (m_fast) or N tiles.  DBP: the blocks of M tile 0 also write dbp
// (GemmArgs16).
template <int WN, int HALVES, int STAGES, bool A_MN, bool B_NK, bool VEC,
          bool DBP>
__global__ void __launch_bounds__(256, 1) gemm_wgmma_kernel(GemmArgs16 g) {
  constexpr int BM = 128, BN = WN * HALVES, NT = 256, NR = WN / 2;
  static_assert(WN == 64 || WN == 128 || WN == 192, "wgmma widths");
  constexpr int A_BYTES = BM * WG_BK * 2, B_BYTES = WG_BK * BN * 2;
  constexpr int STAGE = A_BYTES + B_BYTES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) &
                                                   1023)) & 1023);
  const int mt = (g.M + BM - 1) / BM, nt = (g.N + BN - 1) / BN;
  const int tiles = mt * nt, split = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int tm = g.m_fast ? tile % mt : tile / nt;
  const int tn = g.m_fast ? tile / mt : tile % nt;
  const int m0 = tm * BM, n0 = tn * BN;
  const int k_begin = split * g.k_chunk;
  const int k_end = min(g.K, k_begin + g.k_chunk);
  const int n_kt = (k_end - k_begin + WG_BK - 1) / WG_BK;
  const int tid = threadIdx.x, wg = tid >> 7;

  auto load_stage = [&](int kt, int slot) {
    const int k0 = k_begin + kt * WG_BK;
    unsigned char* as = smem + slot * STAGE;
    if constexpr (A_MN)   // [K rows][M]: two 64-column panels
      copy_sw128<WG_BK, BM, NT, VEC>(as, g.A, g.lda, k0, k_end, m0, g.M);
    else                  // [M rows][K]: one panel
      copy_sw128<BM, WG_BK, NT, VEC>(as, g.A, g.lda, m0, g.M, k0, k_end);
    if constexpr (B_NK)   // [N rows][K]: one panel
      copy_sw128<BN, WG_BK, NT, VEC>(as + A_BYTES, g.B, g.ldb, n0, g.N, k0,
                                     k_end);
    else                  // [K rows][N]: BN / 64 panels
      copy_sw128<WG_BK, BN, NT, VEC>(as + A_BYTES, g.B, g.ldb, k0, k_end,
                                     n0, g.N);
  };

  float acc[HALVES][NR], part[NR];
#pragma unroll
  for (int c = 0; c < NR; ++c) part[c] = 0.f;
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int c = 0; c < NR; ++c) acc[h][c] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_kt) load_stage(s, s);
    cp_async_commit();
  }
  const unsigned base = smem_u32(smem);
  constexpr unsigned PANEL = WG_BK * 128;  // an MN-major panel's bytes
  // MN-major: leading byte offset the next 64 columns' panel, stride
  // byte offset the next 8 rows of K
  constexpr unsigned LBO_MN = PANEL, SBO_MN = 1024;
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // stage kt landed; every warpgroup is done with kt - 1
    if (kt + STAGES - 1 < n_kt)
      load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const unsigned sa = base + (kt % STAGES) * STAGE;
    const unsigned sb = sa + A_BYTES;
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < WG_BK / 16; ++s) {
        const uint64_t da =
            A_MN ? wg_desc(sa + wg * PANEL + s * 2048, LBO_MN, SBO_MN)
                 : wg_desc(sa + wg * 64 * 128 + s * 32, 16, 1024);
        const uint64_t db =
            B_NK ? wg_desc(sb + h * WN * 128 + s * 32, 16, 1024)
                 : wg_desc(sb + h * (WN / 64) * PANEL + s * 2048, LBO_MN,
                           SBO_MN);
        constexpr int TA = A_MN ? 1 : 0, TB = B_NK ? 0 : 1;
        if constexpr (WN == 64) {
          if (s == 0)
            wgmma_m64n64<0, TA, TB>(part, da, db);
          else
            wgmma_m64n64<1, TA, TB>(part, da, db);
        } else if constexpr (WN == 128) {
          if (s == 0)
            wgmma_m64n128<0, TA, TB>(part, da, db);
          else
            wgmma_m64n128<1, TA, TB>(part, da, db);
        } else {
          if (s == 0)
            wgmma_m64n192<0, TA, TB>(part, da, db);
          else
            wgmma_m64n192<1, TA, TB>(part, da, db);
        }
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int c = 0; c < NR; ++c) acc[h][c] += part[c];
    }
  }
  cp_async_wait<0>();

  if (DBP && tm == 0 && tid < BN && n0 + tid < g.N) {
    float sum = 0.f;  // the row tiles in order
    for (int rt = 0; rt < g.row_tiles; ++rt)
      sum += g.colpart[(size_t)rt * g.N + n0 + tid];
    g.dbp[n0 + tid] = sum;
  }
  // a thread's entries: warp w of its warpgroup holds rows 16 w .. + 15 of
  // the warpgroup's 64; register 4 b + 2 h + e is row gq + 8 h, column
  // 8 b + 2 tq + e
  const int lane = tid & 31, w = (tid >> 5) & 3, gq = lane >> 2, tq = lane & 3;
  float* C = g.C + (size_t)split * g.split_stride;
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int b = 0; b < WN / 8; ++b)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m0 + wg * 64 + w * 16 + gq + hh * 8;
        const int n = n0 + h * WN + b * 8 + tq * 2;
        if (r >= g.M) continue;
        const size_t at = (size_t)r * g.ldc + n;
        const float v0 = acc[h][4 * b + 2 * hh], v1 = acc[h][4 * b + 2 * hh + 1];
        if (VEC && n + 1 < g.N) {
          *reinterpret_cast<float2*>(C + at) = make_float2(v0, v1);
        } else {
          if (n < g.N) C[at] = v0;
          if (n + 1 < g.N) C[at + 1] = v1;
        }
      }
}

template <int WN, int HALVES, int STAGES, bool A_MN, bool B_NK, bool DBP>
cudaError_t gemm_wg(const GemmArgs16& g, int splits, bool vec,
                    cudaStream_t s) {
  constexpr int BN = WN * HALVES;
  constexpr int bytes = STAGES * (128 * WG_BK * 2 + WG_BK * BN * 2) + 1024;
  static_assert(bytes <= 227 * 1024, "ring past an H100's shared memory");
  const void* kernel =
      vec ? (const void*)gemm_wgmma_kernel<WN, HALVES, STAGES, A_MN, B_NK,
                                           true, DBP>
          : (const void*)gemm_wgmma_kernel<WN, HALVES, STAGES, A_MN, B_NK,
                                           false, DBP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int tiles = ((g.M + 127) / 128) * ((g.N + BN - 1) / BN);
  const dim3 grid(tiles * splits);
  if (vec)
    gemm_wgmma_kernel<WN, HALVES, STAGES, A_MN, B_NK, true, DBP>
        <<<grid, 256, bytes, s>>>(g);
  else
    gemm_wgmma_kernel<WN, HALVES, STAGES, A_MN, B_NK, false, DBP>
        <<<grid, 256, bytes, s>>>(g);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, int WM, int WN, int MINB, bool A_KM,
          bool B_NK, bool COLSUM>
cudaError_t gemm(const GemmArgs& g, int splits, bool vec, cudaStream_t s) {
  constexpr int NT = (BM / WM) * (BN / WN) * 32;
  constexpr int bytes = Tiles<BM, BN, BK, A_KM, B_NK>::BYTES;
  static_assert(bytes <= 227 * 1024, "tiles past an H100's shared memory");
  const void* kernel =
      vec ? (const void*)gemm_3xtf32_kernel<BM, BN, BK, WM, WN, MINB, A_KM,
                                            B_NK, COLSUM, true>
          : (const void*)gemm_3xtf32_kernel<BM, BN, BK, WM, WN, MINB, A_KM,
                                            B_NK, COLSUM, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int tiles = ((g.M + BM - 1) / BM) * ((g.N + BN - 1) / BN);
  const dim3 grid(tiles * splits);
  if (vec)
    gemm_3xtf32_kernel<BM, BN, BK, WM, WN, MINB, A_KM, B_NK, COLSUM,
                       true><<<grid, NT, bytes, s>>>(g);
  else
    gemm_3xtf32_kernel<BM, BN, BK, WM, WN, MINB, A_KM, B_NK, COLSUM,
                       false><<<grid, NT, bytes, s>>>(g);
  return cudaGetLastError();
}

// A split of K into `splits` chunks of `chunk` (a multiple of the
// product's K tile bk) that covers K exactly once: every chunk starts
// below K.
bool split_ok(int K, int splits, int chunk, int bk) {
  return splits >= 1 && chunk >= bk && chunk % bk == 0 &&
         (size_t)splits * chunk >= (size_t)K &&
         (size_t)(splits - 1) * chunk < (size_t)K;
}

size_t pad4(size_t n) { return (n + 3) / 4 * 4; }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}


// The float32 backward (the six launches of the header).
int embed_bwd_f32(const float* h_top, const float* soft, const float* d_emb,
                  const float* w_proj, const float* wd, int R, int H, int V,
                  int Ed, float temp, const int* plan, float* scratch,
                  float* dwp, float* dbp, float* d_htop, cudaStream_t s) {
  const int s0 = plan[0], c0 = plan[1], s3 = plan[2], c3 = plan[3];
  const size_t scratch_floats = (size_t)plan[4];
  float* d_logits = scratch;
  float* inner = d_logits + pad4((size_t)R * V);
  float* part0 = inner + pad4(R);
  float* part3 = part0 + pad4((size_t)s0 * R * Ed);
  const size_t need = (size_t)(part3 - scratch) +
                      (s3 > 1 ? (size_t)s3 * R * H : 0);
  if (need > scratch_floats) return cudaErrorInvalidValue;
  const bool vec = H % 4 == 0 && V % 4 == 0 && Ed % 4 == 0 &&
                   aligned16(h_top) && aligned16(soft) && aligned16(d_emb) &&
                   aligned16(w_proj) && aligned16(wd) && aligned16(scratch);

  // 1. se partials = soft @ wd^T, split over V
  GemmArgs g{};
  g.A = soft, g.lda = V, g.B = wd, g.ldb = V;
  g.M = R, g.N = Ed, g.K = V, g.k_chunk = c0;
  g.C = part0, g.ldc = Ed, g.split_stride = (size_t)R * Ed, g.m_fast = 1;
  cudaError_t err = gemm<SE_BM, SE_BN, SE_BK, 32, 32, 2, false, true,
                         false>(g, s0, vec, s);
  if (err != cudaSuccess) return err;
  // 2. inner[r]
  inner_kernel<float><<<(R + R_NT / 32 - 1) / (R_NT / 32), R_NT, 0, s>>>(
      part0, s0, d_emb, R, Ed, inner);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 3. d_logits
  const dim3 dl_grid((V + DL_BN - 1) / DL_BN, (R + DL_BM - 1) / DL_BM);
  if (vec)
    d_logits_kernel<true><<<dl_grid, DL_NT, 0, s>>>(d_emb, wd, soft, inner,
                                                    R, V, Ed, temp, d_logits);
  else
    d_logits_kernel<false><<<dl_grid, DL_NT, 0, s>>>(
        d_emb, wd, soft, inner, R, V, Ed, temp, d_logits);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 4. dWp = h_top^T @ d_logits, and dbp
  g = GemmArgs{};
  g.A = h_top, g.lda = H, g.B = d_logits, g.ldb = V;
  g.M = H, g.N = V, g.K = R, g.k_chunk = R;
  g.C = dwp, g.ldc = V, g.colsum = dbp, g.m_fast = 1;
  err = gemm<128, 128, 64, 64, 32, 1, true, false, true>(g, 1, vec, s);
  if (err != cudaSuccess) return err;
  // 5. d_htop (partials) = d_logits @ w_proj, split over V
  g = GemmArgs{};
  g.A = d_logits, g.lda = V, g.B = w_proj, g.ldb = H;
  g.M = R, g.N = H, g.K = V, g.k_chunk = c3;
  g.C = s3 > 1 ? part3 : d_htop, g.ldc = H;
  g.split_stride = (size_t)R * H, g.m_fast = 0;
  err = gemm<HT_BM, HT_BN, HT_BK, 64, 32, 1, false, false, false>(g, s3,
                                                                  vec, s);
  if (err != cudaSuccess || s3 == 1) return err;
  // 6. d_htop
  const size_t n = (size_t)R * H;
  reduce_kernel<float><<<(unsigned)((n + R_NT - 1) / R_NT), R_NT, 0, s>>>(
      part3, s3, n, d_htop);
  return cudaGetLastError();
}

// The bfloat16 backward (the six launches of the header).  Scratch: dl
// [R, V] bfloat16 (in pad4(ceil(R*V / 2)) floats), inner [R], the se
// partials [s0, R, Ed], the column sums [ceil(R / DLB_BM), V] and the d_htop
// partials [s3, R, H], each from a multiple of 4 floats.
int embed_bwd_bf16(const bf16* h_top, const bf16* soft, const bf16* d_emb,
                   const bf16* w_proj, const bf16* wd, int R, int H, int V,
                   int Ed, float temp, const int* plan, float* scratch,
                   float* dwp, float* dbp, bf16* d_htop, cudaStream_t s) {
  const int s0 = plan[0], c0 = plan[1], s3 = plan[2], c3 = plan[3];
  const size_t scratch_floats = (size_t)plan[4];
  const int row_tiles = (R + DLB_BM - 1) / DLB_BM;
  uint16_t* dl = reinterpret_cast<uint16_t*>(scratch);
  float* inner = scratch + pad4(((size_t)R * V + 1) / 2);
  float* part0 = inner + pad4(R);
  float* colpart = part0 + pad4((size_t)s0 * R * Ed);
  float* part3 = colpart + pad4((size_t)row_tiles * V);
  const size_t need = (size_t)(part3 - scratch) + (size_t)s3 * R * H;
  if (need > scratch_floats) return cudaErrorInvalidValue;
  const bool vec = H % 8 == 0 && V % 8 == 0 && Ed % 8 == 0 &&
                   aligned16(h_top) && aligned16(soft) && aligned16(d_emb) &&
                   aligned16(w_proj) && aligned16(wd) && aligned16(scratch);
  const auto u16 = [](const bf16* p) {
    return reinterpret_cast<const uint16_t*>(p);
  };

  // 1. se partials = soft @ wd^T, split over V
  GemmArgs16 g{};
  g.A = u16(soft), g.lda = V, g.B = u16(wd), g.ldb = V;
  g.M = R, g.N = Ed, g.K = V, g.k_chunk = c0;
  g.C = part0, g.ldc = Ed, g.split_stride = (size_t)R * Ed, g.m_fast = 1;
  cudaError_t err =
      gemm_wg<64, 1, WG_SE_STAGES, false, true, false>(g, s0, vec, s);
  if (err != cudaSuccess) return err;
  // 2. inner[r]
  inner_kernel<bf16><<<(R + R_NT / 32 - 1) / (R_NT / 32), R_NT, 0, s>>>(
      part0, s0, d_emb, R, Ed, inner);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 3. dl and the column sums of d_logits
  const int dl_smem = dlb_smem(Ed);
  if (dl_smem > 227 * 1024) return cudaErrorInvalidValue;  // Ed past ~280
  const void* dl_kernel = vec ? (const void*)d_logits_bf16_kernel<true>
                              : (const void*)d_logits_bf16_kernel<false>;
  if ((err = cudaFuncSetAttribute(dl_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  dl_smem)) != cudaSuccess)
    return err;
  const int col_tiles = (V + DLB_BN - 1) / DLB_BN;
  const dim3 dl_grid((col_tiles + DLB_CT - 1) / DLB_CT, row_tiles);
  if (vec)
    d_logits_bf16_kernel<true><<<dl_grid, DLB_NT, dl_smem, s>>>(
        u16(d_emb), u16(wd), u16(soft), inner, R, V, Ed, temp, dl, colpart);
  else
    d_logits_bf16_kernel<false><<<dl_grid, DLB_NT, dl_smem, s>>>(
        u16(d_emb), u16(wd), u16(soft), inner, R, V, Ed, temp, dl, colpart);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 4. dWp = h_top^T @ dl; the blocks of the first H tile sum dbp
  g = GemmArgs16{};
  g.A = u16(h_top), g.lda = H, g.B = dl, g.ldb = V;
  g.M = H, g.N = V, g.K = R, g.k_chunk = R;
  g.C = dwp, g.ldc = V, g.m_fast = 1;
  g.colpart = colpart, g.row_tiles = row_tiles, g.dbp = dbp;
  err = gemm_wg<WG_DWP_N, WG_DWP_HALVES, WG_DWP_STAGES, true, false,
                  true>(g, 1, vec, s);
  if (err != cudaSuccess) return err;
  // 5. d_htop partials = dl @ w_proj, split over V
  g = GemmArgs16{};
  g.A = dl, g.lda = V, g.B = u16(w_proj), g.ldb = H;
  g.M = R, g.N = H, g.K = V, g.k_chunk = c3;
  g.C = part3, g.ldc = H, g.split_stride = (size_t)R * H, g.m_fast = 0;
  err = gemm_wg<WG_HT_N, WG_HT_HALVES, WG_HT_STAGES, false, false,
                  false>(g, s3, vec, s);
  if (err != cudaSuccess) return err;
  // 6. d_htop, rounded once
  const size_t n = (size_t)R * H;
  reduce_kernel<bf16><<<(unsigned)((n + R_NT - 1) / R_NT), R_NT, 0, s>>>(
      part3, s3, n, d_htop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The generator-side backward of mode sample_embed on `stream`, R = T*B
// rows: h_top [R, H], soft [R, V], d_emb [R, Ed], w_proj [V, H], wd [Ed, V]
// in; dwp [H, V], dbp [V], d_htop [R, H] out.  bf16 = 1: every input and
// d_htop bfloat16, dwp and dbp float32 (the bfloat16 instantiation).  plan
// = (se splits, se chunk, d_htop splits, d_htop chunk, scratch floats)
// from decode_sample.embed_bwd_plan; scratch as embed_bwd_f32 /
// embed_bwd_bf16 lay it out.  Returns 0 or the first CUDA error code
// (cudaErrorInvalidValue for a plan that does not cover K or a scratch too
// small); nothing synchronises.
int gic_decode_embed_bwd(const void* h_top, const void* soft,
                         const void* d_emb, const void* w_proj,
                         const void* wd, int R, int H, int V, int Ed,
                         int bf16_, float temp, const int* plan,
                         float* scratch, float* dwp, float* dbp,
                         void* d_htop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 1 || H < 1 || V < 1 || Ed < 1 ||
      !split_ok(V, plan[0], plan[1], SE_BK) ||
      !split_ok(V, plan[2], plan[3], HT_BK))
    return cudaErrorInvalidValue;
  if (bf16_)
    return embed_bwd_bf16(
        static_cast<const bf16*>(h_top), static_cast<const bf16*>(soft),
        static_cast<const bf16*>(d_emb), static_cast<const bf16*>(w_proj),
        static_cast<const bf16*>(wd), R, H, V, Ed, temp, plan, scratch, dwp,
        dbp, static_cast<bf16*>(d_htop), s);
  return embed_bwd_f32(
      static_cast<const float*>(h_top), static_cast<const float*>(soft),
      static_cast<const float*>(d_emb), static_cast<const float*>(w_proj),
      static_cast<const float*>(wd), R, H, V, Ed, temp, plan, scratch, dwp,
      dbp, static_cast<float*>(d_htop), s);
}

}  // extern "C"
