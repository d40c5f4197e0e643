// Fused Gumbel-softmax sampler for Hopper (sm_90a), float32.
//
// Replaces: gan_image_captioning_tpu/kernels/gumbel_sample.py, function
// `_kernel` (launched by `fused_gumbel_sample`).  For logits [B, V]:
//   u ~ U[0, 1) per (b, v): Philox keyed by the seed, counter (v, b, step, 0)
//       (philox_uniform in decode_common.cuh, the stream of the sample_resid
//       decode at its step `step`), or read from `u_in`
//   g = -log(-log(u + 1e-10) + 1e-10) ;  x = (logits + g) * temp
//   soft[b] = softmax(x[b]) ;  ids[b] = argmax(x[b])  (first index on ties)
// ids come from x, not from soft, as in the TPU kernel: a soft row can
// round two different x to the same probability.  The sum and the product
// are rounded separately (__fadd_rn, __fmul_rn), as PyTorch's eager
// `(logits + g) * temp` does, and the logs are full-precision logf, so x,
// and with it ids, are the same bits whatever the tiling.
//
// What bounds it on this card.  Bytes: one read of the logits and one write
// of soft, 8 bytes per element (16 with u_in / u_out): at B = 64 and
// V = 11008 that is 5.6 MB, 1.7 us at 3.35 TB/s.  Instructions: Philox's
// ten rounds, two logs, an exp and a multiply come to about 170
// per element, 4 us over the card's 132 SMs at that shape: the kernel is
// bound by instruction issue and latency, so what matters is that every
// SM has warps, and that no element is computed or read twice.
//
// What this design does about it.
//   * A row is split over a cluster of S CTAs (S <= 8, the portable
//     limit), launched by cudaLaunchKernelEx with a cluster dimension:
//     CTA `rank` takes the columns [rank*chunk, (rank+1)*chunk).  The plan
//     (gumbel_sample.gumbel_plan, checked here by plan_for) picks S from
//     (B, V) so that B*S CTAs cover the SMs; the threads and each thread's
//     VPT groups of 4 columns follow from the chunk.
//   * A thread reads its logits once (16-byte loads where V % 4 == 0, a
//     column per thread otherwise), keeps each element's x in registers,
//     replaces it by exp(x - max) (one expf per element), and writes soft
//     once: no pass reads x back from memory.
//   * Each CTA takes its own maximum and first index at it, and its sum of
//     exp(x - its maximum); the cluster combines the three in one exchange
//     through distributed shared memory (cooperative_groups::
//     this_cluster(), map_shared_rank): each CTA folds the ranks' values
//     in rank order, rescaling each rank's sum to the row's maximum, so
//     every CTA gets the same bits and two calls are bit-equal; no float
//     atomics, one cluster barrier.  soft is e times one factor a CTA.
//     A split arrive/wait cluster barrier keeps every CTA's shared memory
//     alive until the last peer has read it.
//   * Small V (<= G_ROW_MAX_V, e.g. the histogram's [2^18, 16]) takes no
//     cluster: a warp per row, G_ROWS rows a CTA, shuffles only.
// What holds it now ([64, 11008], H100): not that instruction count.
// Fed uniforms (no Philox) take nearly as long as the draw, and 1 to 8
// CTAs a row move the time by under a third: a launch, a round trip to
// memory and the reductions and cluster barrier in turn set it.  PERF.md
// gives the times.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"

using namespace gic;
namespace cg = cooperative_groups;

namespace {

constexpr int G_MAX_CLUSTER = 8;           // the portable cluster size
constexpr int G_NT = 256, G_NT_MAX = 512;  // threads of a cluster CTA
constexpr int G_VPT_MAX = 8;               // groups of 4 columns a thread
constexpr int G_ROW_NT = 256, G_ROWS = G_ROW_NT / 32;  // a warp per row
constexpr int G_ROW_MAX_V = 32 * 4 * G_VPT_MAX;

__device__ __forceinline__ float gumbel_x(float logit, float u, float temp) {
  const float g = -logf(-logf(u + GUMBEL_EPS) + GUMBEL_EPS);
  return __fmul_rn(__fadd_rn(logit, g), temp);
}

// (m, i): a maximum and the first column reaching it; folds in (m2, i2).
// A NaN never compares, so it is skipped, as fmaxf skips it.
__device__ __forceinline__ void fold(float& m, int& i, float m2, int i2) {
  if (m2 > m || (m2 == m && i2 < i)) {
    m = m2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_fold(float& m, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    fold(m, i, __shfl_xor_sync(0xffffffffu, m, off),
         __shfl_xor_sync(0xffffffffu, i, off));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Column of element (i, j) of thread t among nt over the slice starting at
// c0: VEC, group i*nt + t of 4 neighbouring columns (one 16-byte access);
// else column (4i + j)*nt + t (neighbouring threads on neighbouring
// columns).
template <bool VEC>
__device__ __forceinline__ int col_of(int i, int j, int c0, int nt, int t) {
  return VEC ? c0 + 4 * (i * nt + t) + j : c0 + (4 * i + j) * nt + t;
}

// This thread's elements of row b's slice [c0, c1): x into registers, and
// (m, first) over them.
template <int VPT, bool VEC>
__device__ __forceinline__ void draw(
    float (&x)[4 * VPT], const float* __restrict__ logits,
    const float* __restrict__ u_in, float* __restrict__ u_out, size_t base,
    int b, int c0, int c1, int nt, int t, float temp, uint64_t seed,
    int step, float& m, int& first) {
  m = -INFINITY;
  first = INT_MAX;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (VEC) {
      const int c = col_of<true>(i, 0, c0, nt, t);
      if (c >= c1) continue;  // the slice ends on a group of 4
      const float4 l4 = *reinterpret_cast<const float4*>(logits + base + c);
      float4 u4;
      if (u_in != nullptr)
        u4 = *reinterpret_cast<const float4*>(u_in + base + c);
      else
        u4 = make_float4(philox_uniform(seed, step, b, c),
                         philox_uniform(seed, step, b, c + 1),
                         philox_uniform(seed, step, b, c + 2),
                         philox_uniform(seed, step, b, c + 3));
      if (u_out != nullptr) *reinterpret_cast<float4*>(u_out + base + c) = u4;
      const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
      const float uv[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[4 * i + j] = gumbel_x(lv[j], uv[j], temp);
        fold(m, first, x[4 * i + j], c + j);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col_of<false>(i, j, c0, nt, t);
        if (c >= c1) continue;
        const float u = u_in != nullptr ? u_in[base + c]
                                        : philox_uniform(seed, step, b, c);
        if (u_out != nullptr) u_out[base + c] = u;
        x[4 * i + j] = gumbel_x(logits[base + c], u, temp);
        fold(m, first, x[4 * i + j], c);
      }
    }
  }
}

// x -> exp(x - M) in place over the thread's elements; their sum.
template <int VPT, bool VEC>
__device__ __forceinline__ float exps(float (&x)[4 * VPT], int c0, int c1,
                                      int nt, int t, float M) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (col_of<VEC>(i, j, c0, nt, t) < c1) {
        x[4 * i + j] = expf(x[4 * i + j] - M);
        s += x[4 * i + j];
      }
    }
  }
  return s;
}

// soft = e * scale over the thread's elements (scale: 1 / sum, or a CTA's
// share of the row's sum).
template <int VPT, bool VEC>
__device__ __forceinline__ void store(const float (&e)[4 * VPT],
                                      float* __restrict__ soft, size_t base,
                                      int c0, int c1, int nt, int t,
                                      float scale) {
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (VEC) {
      const int c = col_of<true>(i, 0, c0, nt, t);
      if (c < c1)
        *reinterpret_cast<float4*>(soft + base + c) =
            make_float4(e[4 * i] * scale, e[4 * i + 1] * scale,
                        e[4 * i + 2] * scale, e[4 * i + 3] * scale);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col_of<false>(i, j, c0, nt, t);
        if (c < c1) soft[base + c] = e[4 * i + j] * scale;
      }
    }
  }
}

// barrier.cluster split in two: after a CTA's last read of its peers'
// shared memory, and before it exits
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A cluster of S CTAs per row (gridDim.x = B*S, cluster dimension S):
// CTA `rank` of row blockIdx.x / S takes the columns [rank*chunk,
// min(V, (rank+1)*chunk)).  Each CTA finds its own maximum m_c (and first
// index), its elements' e = exp(x - m_c) and their sum s_c; one cluster
// exchange then gives every CTA the row's maximum M and first index, and
// sum = sum_r s_r * exp(m_r - M) in rank order; soft = e * exp(m_c - M) /
// sum.  A CTA whose slice has no finite maximum (every x -inf) adds 0;
// a row without one gives NaN, as softmax does.
template <int VPT, bool VEC>
__global__ void __launch_bounds__(G_NT_MAX) gumbel_cluster_kernel(
    const float* __restrict__ logits, int V, int chunk, float temp,
    unsigned long long seed, int step, const float* __restrict__ u_in,
    float* __restrict__ u_out, float* __restrict__ soft,
    int32_t* __restrict__ ids) {
  __shared__ float warp_m[G_NT_MAX / 32], warp_s[G_NT_MAX / 32];
  __shared__ int warp_i[G_NT_MAX / 32];
  __shared__ float cta_m, cta_s;  // read by the cluster's CTAs
  __shared__ int cta_i;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / S, t = threadIdx.x, nt = blockDim.x;
  const int lane = t % 32, warp = t / 32, nw = nt / 32;
  const int c0 = rank * chunk, c1 = min(V, c0 + chunk);
  const size_t base = (size_t)b * V;

  float x[4 * VPT], m;
  int first;
  draw<VPT, VEC>(x, logits, u_in, u_out, base, b, c0, c1, nt, t, temp, seed,
                 step, m, first);
  warp_fold(m, first);
  if (lane == 0) {
    warp_m[warp] = m;
    warp_i[warp] = first;
  }
  __syncthreads();
  m = warp_m[0];
  first = warp_i[0];
  for (int w = 1; w < nw; ++w) fold(m, first, warp_m[w], warp_i[w]);
  const float s = warp_sum(
      exps<VPT, VEC>(x, c0, c1, nt, t, m == -INFINITY ? 0.f : m));
  if (lane == 0) warp_s[warp] = s;
  __syncthreads();
  if (t == 0) {
    float sc = warp_s[0];
    for (int w = 1; w < nw; ++w) sc += warp_s[w];
    cta_m = m;
    cta_i = first;
    cta_s = sc;
  }
  cluster.sync();
  float M = -INFINITY, mr[G_MAX_CLUSTER], sr[G_MAX_CLUSTER];
  int I = INT_MAX;
#pragma unroll
  for (int r = 0; r < G_MAX_CLUSTER; ++r) {
    if (r >= S) break;
    mr[r] = *cluster.map_shared_rank(&cta_m, r);
    sr[r] = *cluster.map_shared_rank(&cta_s, r);
    fold(M, I, mr[r], *cluster.map_shared_rank(&cta_i, r));
  }
  cluster_arrive();  // this CTA reads no peer any more
  float sum = 0.f;
#pragma unroll
  for (int r = 0; r < G_MAX_CLUSTER; ++r)
    if (r < S && mr[r] != -INFINITY) sum += sr[r] * expf(mr[r] - M);
  if (rank == 0 && t == 0) ids[b] = I == INT_MAX ? 0 : I;
  store<VPT, VEC>(x, soft, base, c0, c1, nt, t,
                  (m == -INFINITY ? 0.f : expf(m - M)) / sum);
  cluster_wait();  // nor does any peer read this CTA's cta_m / cta_s
}

// A warp per row, G_ROWS rows a CTA, the whole row of V <= G_ROW_MAX_V.
template <int VPT, bool VEC>
__global__ void __launch_bounds__(G_ROW_NT) gumbel_rows_kernel(
    const float* __restrict__ logits, int B, int V, float temp,
    unsigned long long seed, int step, const float* __restrict__ u_in,
    float* __restrict__ u_out, float* __restrict__ soft,
    int32_t* __restrict__ ids) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * G_ROWS + threadIdx.x / 32;
  if (b >= B) return;  // warp-uniform
  const size_t base = (size_t)b * V;
  float x[4 * VPT], m;
  int first;
  draw<VPT, VEC>(x, logits, u_in, u_out, base, b, 0, V, 32, lane, temp, seed,
                 step, m, first);
  warp_fold(m, first);
  if (lane == 0) ids[b] = first == INT_MAX ? 0 : first;
  const float total = warp_sum(exps<VPT, VEC>(x, 0, V, 32, lane, m));
  store<VPT, VEC>(x, soft, base, 0, V, 32, lane, 1.f / total);
}

// The launch of (B, V) with S CTAs a row (gumbel_sample.gumbel_plan's
// formula, S given): the CTAs' threads, each thread's groups of 4 columns
// (a power of two), rows a CTA, columns a CTA's slice, CTAs.  False where S
// cannot run: outside 1..G_MAX_CLUSTER, an empty CTA, or more than G_NT_MAX
// threads of G_VPT_MAX groups a CTA.
struct Plan {
  int threads, vecs, rows, chunk, ctas;
};

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

bool plan_for(int B, int V, int S, Plan* p) {
  const int groups = (V + 3) / 4;
  if (B < 1 || V < 1 || S < 1 || S > G_MAX_CLUSTER) return false;
  if (S == 1 && V <= G_ROW_MAX_V) {
    *p = {G_ROW_NT, pow2_at_least((groups + 31) / 32), G_ROWS, V,
          (B + G_ROWS - 1) / G_ROWS};
    return true;
  }
  const int per_cta = (groups + S - 1) / S, chunk = 4 * per_cta;
  if ((long)(S - 1) * chunk >= V) return false;
  int threads = min(G_NT, 32 * ((per_cta + 31) / 32));
  if ((per_cta + threads - 1) / threads > G_VPT_MAX) threads = G_NT_MAX;
  const int vecs = (per_cta + threads - 1) / threads;
  if (vecs > G_VPT_MAX) return false;
  *p = {threads, pow2_at_least(vecs), 1, chunk, B * S};
  return true;
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int VPT, bool VEC>
cudaError_t launch(const Plan& p, int S, const float* logits, int B, int V,
                   float temp, unsigned long long seed, int step,
                   const float* u_in, float* u_out, float* soft, int32_t* ids,
                   cudaStream_t st) {
  if (p.rows > 1) {
    gumbel_rows_kernel<VPT, VEC><<<p.ctas, p.threads, 0, st>>>(
        logits, B, V, temp, seed, step, u_in, u_out, soft, ids);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gumbel_cluster_kernel<VPT, VEC>, logits, V,
                            p.chunk, temp, seed, step, u_in, u_out, soft, ids);
}

template <bool VEC>
cudaError_t launch_vecs(const Plan& p, int S, const float* logits, int B,
                        int V, float temp, unsigned long long seed, int step,
                        const float* u_in, float* u_out, float* soft,
                        int32_t* ids, cudaStream_t st) {
  switch (p.vecs) {
#define GIC_VPT(N)                                                          \
  case N:                                                                   \
    return launch<N, VEC>(p, S, logits, B, V, temp, seed, step, u_in, u_out, \
                          soft, ids, st);
    GIC_VPT(1) GIC_VPT(2) GIC_VPT(4) GIC_VPT(8)
#undef GIC_VPT
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// logits [B, V] -> soft [B, V], ids [B] on `stream`.  Noise: u_in [B, V]
// when not null, else Philox of (seed, step); the uniforms used go to u_out
// [B, V] when it is not null.  cluster, threads, vecs, rows, chunk, ctas:
// the wrapper's plan (gumbel_sample.gumbel_plan); a launch whose plan is not
// plan_for(B, V, cluster) is refused (cudaErrorInvalidValue), and so is
// one the card refuses (the cluster launch's own error).  16-byte accesses
// where V % 4 == 0 and every pointer is 16-byte aligned.  Returns 0 or the
// CUDA error code of the launch; nothing synchronises.
int gic_gumbel_sample(const float* logits, int B, int V, float temp,
                      unsigned long long seed, int step, const float* u_in,
                      float* u_out, float* soft, int32_t* ids, int cluster,
                      int threads, int vecs, int rows, int chunk, int ctas,
                      void* stream) {
  Plan p;
  if (!plan_for(B, V, cluster, &p) || p.threads != threads ||
      p.vecs != vecs || p.rows != rows || p.chunk != chunk || p.ctas != ctas)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = V % 4 == 0 && aligned16(logits) && aligned16(u_in) &&
                   aligned16(u_out) && aligned16(soft);
  return vec ? launch_vecs<true>(p, cluster, logits, B, V, temp, seed, step,
                                 u_in, u_out, soft, ids, st)
             : launch_vecs<false>(p, cluster, logits, B, V, temp, seed, step,
                                  u_in, u_out, soft, ids, st);
}

}  // extern "C"
