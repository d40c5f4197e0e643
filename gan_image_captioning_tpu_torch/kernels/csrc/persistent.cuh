// What the persistent (one launch per call) kernels share: the grid-wide
// barrier, the loads of data that other blocks wrote earlier in the same
// launch, and the cooperative launch with its occupancy check and its
// dynamic shared-memory opt-in.
//
// A persistent kernel runs a whole time loop in one launch: one block per
// SM, each owning a fixed slice of the work (and of the weights, which it
// keeps in shared memory across steps), with a grid barrier between
// dependent phases.  That is only correct when every block is resident at
// once, so the launch is cooperative (cudaLaunchCooperativeKernel refuses
// a grid that cannot be co-resident) and launch_persistent checks the
// occupancy itself first: a grid that does not fit is an error, never a
// host loop.
//
// The barrier is a hand-written counter: each block's thread 0 releases the
// block's writes (__threadfence), adds one to the counter and spins with
// acquire loads until the counter reaches the barrier's target (the number
// of blocks times the barriers passed so far).  The counter is set to zero
// before each launch (cudaMemsetAsync on the launch's stream).  It needs
// no relocatable device code, unlike cooperative_groups' grid sync.
//
// Data written by another block in the same launch is read with ld.cg
// (L2, not the SM's L1 or the read-only path): an L1 line cached from an
// earlier step would otherwise be stale.

#pragma once

#include <cuda_runtime.h>

#include "bf16.cuh"

namespace gic {

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Every thread of every block calls it, the same number of times.  `target`
// is the block's count of barriers passed times gridDim.x (start at 0).
__device__ __forceinline__ void grid_barrier(unsigned int* counter,
                                             unsigned int& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (ld_acquire(counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// A float that another block wrote before the last grid barrier.
__device__ __forceinline__ float ld_shared_global(const float* p) {
  return __ldcg(p);
}
__device__ __forceinline__ int ld_shared_global(const int* p) {
  return __ldcg(p);
}

// The K-tile stage both persistent kernels use: PT_NT threads; a pool of
// slots in shared memory, each holding one K tile of the rows a product
// needs (row stride kt + 4 floats, so a float4 per lane along k
// reads without bank conflicts beyond the minimum), filled by cp.async so
// that the next tiles are in flight while the block works on the current
// one.  The tile is as wide as the slot allows (tile_k): every tile costs
// a wait and a __syncthreads, so few rows (a small batch) get wide tiles.
constexpr int PT_NT = 256, PT_KT = 32;

__host__ __device__ inline int kpad(int k) {
  return (k + PT_KT - 1) / PT_KT * PT_KT;
}

__host__ __device__ inline int pad4(int k) { return (k + 3) / 4 * 4; }

// The widest K tile, 32 * 2^i dividing kpad(k), whose `rows` rows fit in
// `slot` floats (at least 32).
__host__ __device__ inline int tile_k(int rows, int slot, int k) {
  const int kp = kpad(k);
  int kt = PT_KT;
  while (kp % (2 * kt) == 0 && rows * (2 * kt + 4) <= slot) kt *= 2;
  return kt;
}

// 16 bytes global -> shared through L2 only (.cg: data another block wrote
// in this launch is never read from a stale L1 line), or 4 bytes (.ca:
// only for read-only inputs whose rows are not 16-byte aligned).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A row-major matrix read by the stage: row R, column k at p[R * stride +
// k] for k < cols (zeros past cols, and for a null p); aligned: stride and
// p are multiples of 4 elements, so whole 16-byte chunks are copied.
// bf16: p holds bfloat16 (a read-only input of a bfloat16 instantiation):
// its 4 columns are loaded (8 bytes when aligned) and widened into the
// same float slot, without cp.async.
struct Seg {
  const void* p;
  int stride, cols;
  bool aligned;
  bool bf16 = false;
};

// Four columns [k, k + 4) of row R of `s` into dst (16-byte aligned).
__device__ __forceinline__ void stage_chunk(float* dst, const Seg& s, int R,
                                           int k, bool row_ok) {
  if (!row_ok || s.p == nullptr || k >= s.cols) {
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  if (s.bf16) {
    const __nv_bfloat16* src =
        static_cast<const __nv_bfloat16*>(s.p) + (size_t)R * s.stride + k;
    float4 v;
    if (s.aligned) {
      v = ld4_bf16(src);
    } else {
      v.x = __bfloat162float(src[0]);
      v.y = k + 1 < s.cols ? __bfloat162float(src[1]) : 0.f;
      v.z = k + 2 < s.cols ? __bfloat162float(src[2]) : 0.f;
      v.w = k + 3 < s.cols ? __bfloat162float(src[3]) : 0.f;
    }
    *reinterpret_cast<float4*>(dst) = v;
    return;
  }
  const float* src = static_cast<const float*>(s.p) + (size_t)R * s.stride + k;
  if (s.aligned) {
    cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (k + q < s.cols)
      cp_async4(dst + q, src + q);
    else
      dst[q] = 0.f;
  }
}

// One K tile [k0, k0 + kt) of `rows` rows of the concatenation [a | b]
// (a taking the first wa columns, a multiple of 4) into buf (row stride
// kt + 4), issued without waiting: tile row r is matrix row row_of(r),
// or zeros where that is negative.
template <class RowOf>
__device__ __forceinline__ void stage_rows(float* buf, int kt, int rows,
                                           RowOf row_of, const Seg& a,
                                           int wa, const Seg& b, int k0) {
  const int shift = __ffs(kt / 4) - 1;  // kt / 4 is a power of two
  for (int c = threadIdx.x; c < (rows << shift); c += PT_NT) {
    const int r = c >> shift, k = k0 + (c & ((1 << shift) - 1)) * 4;
    const int R = row_of(r);
    float* dst = buf + r * (kt + 4) + (k - k0);
    if (k < wa)
      stage_chunk(dst, a, R, k, R >= 0);
    else
      stage_chunk(dst, b, R, k - wa, R >= 0);
  }
}

// One K tile [k0, k0 + kt) of `rows` rows of the bfloat16 matrix of `s`
// (every column from it) into buf (row stride kt + 4 floats), loaded and
// widened by the issuing thread (no cp.async): 8 columns a load, 16 bytes
// where the rows are 16-byte aligned, stored as two float4 (else two
// stage_chunk); zeros past the columns and where row_of is negative.
template <class RowOf>
__device__ __forceinline__ void stage_rows_bf16(float* buf, int kt, int rows,
                                                RowOf row_of, const Seg& s,
                                                int k0) {
  const int shift = __ffs(kt / 8) - 1;  // kt / 8 is a power of two
  const bool wide = s.aligned && s.stride % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(s.p) % 16 == 0;
  for (int c = threadIdx.x; c < (rows << shift); c += PT_NT) {
    const int r = c >> shift, k = k0 + (c & ((1 << shift) - 1)) * 8;
    const int R = row_of(r);
    float* dst = buf + r * (kt + 4) + (k - k0);
    if (wide && R >= 0 && k + 8 <= s.cols) {
      float v[8];
      ld8_bf16(static_cast<const __nv_bfloat16*>(s.p) + (size_t)R * s.stride +
                   k,
               v);
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(v[4], v[5], v[6], v[7]);
    } else {
      stage_chunk(dst, s, R, k, R >= 0);
      stage_chunk(dst + 4, s, R, k + 4, R >= 0);
    }
  }
}

// Rows [r0, r0 + n) of a matrix with nr rows (negative past nr).
struct RowRange {
  int r0, nr;
  __device__ int operator()(int r) const { return r0 + r < nr ? r0 + r : -1; }
};

// The K pipeline of one product: tiles [0, ntiles) issued DEPTH - 1 ahead,
// issue(i, slot) into slot (i mod DEPTH) of the pool (slot_floats each),
// compute(it, slot) once tile `it` has landed.
template <int DEPTH, class Issue, class Compute>
__device__ __forceinline__ void k_pipeline(float* pool, int slot_floats,
                                           int ntiles, Issue issue,
                                           Compute compute) {
  for (int i = 0; i < DEPTH - 1; ++i) {
    if (i < ntiles) issue(i, pool + i * slot_floats);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<DEPTH - 2>();
    __syncthreads();
    const int nx = it + DEPTH - 1;
    if (nx < ntiles) issue(nx, pool + (nx % DEPTH) * slot_floats);
    cp_async_commit();
    compute(it, pool + (it % DEPTH) * slot_floats);
  }
  cp_async_wait<0>();
  __syncthreads();  // the pool is free again
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc = fmaf over the four k of one float4, ascending.
__device__ __forceinline__ float fma4(float4 w, float4 x, float acc) {
  acc = fmaf(w.x, x.x, acc);
  acc = fmaf(w.y, x.y, acc);
  acc = fmaf(w.z, x.z, acc);
  return fmaf(w.w, x.w, acc);
}

// The card's SM count and the dynamic shared memory a block may opt into.
inline cudaError_t device_limits(int* n_sm, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(smem_optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// One cooperative launch of `kernel` (a __global__ taking one parameter
// struct P by value) on `s`, after zeroing the barrier counter.  Returns
// cudaErrorCooperativeLaunchTooLarge when `blocks` blocks of `threads`
// threads and `smem` bytes cannot all be resident at once.
template <class P>
inline cudaError_t launch_persistent(void (*kernel)(P), const P& params,
                                     unsigned int* counter, int blocks,
                                     int threads, size_t smem,
                                     cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int n_sm = 0, optin = 0, per_sm = 0;
  err = device_limits(&n_sm, &optin);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (blocks < 1 || per_sm * n_sm < blocks)
    return cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(counter, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return err;
  P copy = params;
  void* args[] = {&copy};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(blocks), dim3(threads), args, smem,
                                     s);
}

}  // namespace gic
