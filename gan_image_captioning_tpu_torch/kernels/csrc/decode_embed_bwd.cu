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

#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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
// the splits in order, lanes over e, then a fixed shuffle tree.
__global__ void __launch_bounds__(R_NT) inner_kernel(
    const float* __restrict__ part, int splits, const float* __restrict__ d_emb,
    int R, int Ed, float* __restrict__ inner) {
  const int r = blockIdx.x * (R_NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  float acc = 0.f;
  for (int e = lane; e < Ed; e += 32) {
    float se = 0.f;
    for (int s = 0; s < splits; ++s) se += part[((size_t)s * R + r) * Ed + e];
    acc = fmaf(d_emb[(size_t)r * Ed + e], se, acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) inner[r] = acc;
}

// out[i] = sum_s part[s * n + i], the splits in order.
__global__ void __launch_bounds__(R_NT) reduce_kernel(
    const float* __restrict__ part, int splits, size_t n,
    float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * R_NT + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * n + i];
  out[i] = acc;
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

}  // namespace

extern "C" {

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The generator-side backward of mode sample_embed on `stream`, R = T*B
// rows: h_top [R, H], soft [R, V], d_emb [R, Ed], w_proj [V, H], wd [Ed, V]
// in; dwp [H, V], dbp [V], d_htop [R, H] out.  plan = (se splits, se
// chunk, d_htop splits, d_htop chunk, scratch floats) from
// decode_sample.embed_bwd_plan; scratch holds d_logits [R, V], inner [R],
// the se partials [splits, R, Ed] and, when split, the d_htop partials
// [splits, R, H], each from a multiple of 4 floats.  Returns 0 or the
// first CUDA error code (cudaErrorInvalidValue for a plan that does not
// cover K or a scratch too small); nothing synchronises.
int gic_decode_embed_bwd(const float* h_top, const float* soft,
                         const float* d_emb, const float* w_proj,
                         const float* wd, int R, int H, int V, int Ed,
                         float temp, const int* plan, float* scratch,
                         float* dwp, float* dbp, float* d_htop,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int s0 = plan[0], c0 = plan[1], s3 = plan[2], c3 = plan[3];
  const size_t scratch_floats = (size_t)plan[4];
  if (R < 1 || H < 1 || V < 1 || Ed < 1 || !split_ok(V, s0, c0, SE_BK) ||
      !split_ok(V, s3, c3, HT_BK))
    return cudaErrorInvalidValue;
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
  inner_kernel<<<(R + R_NT / 32 - 1) / (R_NT / 32), R_NT, 0, s>>>(
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
  reduce_kernel<<<(unsigned)((n + R_NT - 1) / R_NT), R_NT, 0, s>>>(
      part3, s3, n, d_htop);
  return cudaGetLastError();
}

}  // extern "C"
