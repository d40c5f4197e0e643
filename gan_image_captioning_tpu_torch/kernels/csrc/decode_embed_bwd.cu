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
// here the R rows are one batch, in four launches inside one C call:
//   1. gemm_kernel: d_soft into the scratch buffer d_logits [R, V];
//   2. softmax_bwd_kernel: one block per row, the row sum in a fixed tree
//      order, then d_logits in place;
//   3. gemm_kernel (A transposed): dWp, each entry a sum over the R rows in
//      row order inside one block (no atomics, no split), and
//      colsum_kernel: dbp, each column summed in row order by one thread;
//   4. gemm_kernel: d_htop.
//
// What bounds it on this card.  At the training width (R = 2304, V = 11008,
// H = 512, Ed = 64) the three products are 2*R*V*(Ed + 2H) = 55.2 GFLOP:
// 0.82 ms at 67 TFLOP/s float32 without the tensor cores, against about
// 0.15 GB of inputs and outputs (0.045 ms).  The scratch d_logits (101 MB)
// is written twice and read three times more.  The products are a plain
// shared-memory SGEMM (64 x 64 tiles, 4 x 4 per thread); wgmma, a fused
// first pass and keeping d_logits on chip are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int G_NT = (BM / TM) * (BN / TN);  // 256 threads
constexpr int S_NT = 256;                    // softmax_bwd threads per row

// C [M, N] = A @ B with B [K, N] row-major and A [M, K] row-major, or, when
// A_T, A stored transposed as [K, M] row-major.  Every entry is a sum over
// k in ascending order, in one thread, which owns rows ty + i * 16 and
// columns tx + j * 16 of the block's tile (neighbouring threads, neighbouring
// columns: no bank conflicts in Bs, coalesced stores).  Edges read zeros.
template <bool A_T>
__global__ void __launch_bounds__(G_NT) gemm_kernel(
    const float* __restrict__ A, const float* __restrict__ Bm, int M, int N,
    int K, float* __restrict__ C) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  constexpr int NX = BN / TN, NY = BM / TM;
  const int tid = threadIdx.x, tx = tid % NX, ty = tid / NX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BK * BM; e += G_NT) {
      int kk, mm;
      if (A_T) {  // coalesced along m
        kk = e / BM;
        mm = e % BM;
      } else {    // coalesced along k
        kk = e % BK;
        mm = e / BK;
      }
      const int m = m0 + mm, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < K)
        v = A_T ? A[(size_t)k * M + m] : A[(size_t)m * K + k];
      As[kk][mm] = v;
    }
    for (int e = tid; e < BK * BN; e += G_NT) {
      const int kk = e / BN, nn = e % BN, k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < N) ? Bm[(size_t)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * NY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * NX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * NY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * NX;
      if (n < N) C[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// One block per row r: d[r] (d_soft on entry) becomes
// temp * soft * (d_soft - sum_v(d_soft * soft)).  The row sum: per thread
// over v = tid, tid + S_NT, ..., then a tree over the threads.
__global__ void __launch_bounds__(S_NT) softmax_bwd_kernel(
    const float* __restrict__ soft, float* __restrict__ d, int V,
    float temp) {
  __shared__ float part[S_NT];
  const int tid = threadIdx.x;
  const float* srow = soft + (size_t)blockIdx.x * V;
  float* drow = d + (size_t)blockIdx.x * V;
  float acc = 0.f;
  for (int v = tid; v < V; v += S_NT) acc = fmaf(drow[v], srow[v], acc);
  part[tid] = acc;
  __syncthreads();
  for (int s = S_NT / 2; s > 0; s >>= 1) {
    if (tid < s) part[tid] += part[tid + s];
    __syncthreads();
  }
  const float inner = part[0];
  for (int v = tid; v < V; v += S_NT)
    drow[v] = temp * srow[v] * (drow[v] - inner);
}

// out[n] = sum_r x[r, n], rows in ascending order, one thread per column.
__global__ void colsum_kernel(const float* __restrict__ x, int R, int N,
                              float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc = 0.f;
  for (int r = 0; r < R; ++r) acc += x[(size_t)r * N + n];
  out[n] = acc;
}

template <bool A_T>
cudaError_t gemm(const float* A, const float* Bm, int M, int N, int K,
                 float* C, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<A_T><<<grid, G_NT, 0, s>>>(A, Bm, M, N, K, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The generator-side backward of mode sample_embed on `stream`, R = T*B
// rows: h_top [R, H], soft [R, V], d_emb [R, Ed], w_proj [V, H], wd [Ed, V]
// in; scratch d_logits [R, V]; dwp [H, V], dbp [V], d_htop [R, H] out.
// Returns 0 or the first CUDA error code; nothing synchronises.
int gic_decode_embed_bwd(const float* h_top, const float* soft,
                         const float* d_emb, const float* w_proj,
                         const float* wd, int R, int H, int V, int Ed,
                         float temp, float* d_logits, float* dwp, float* dbp,
                         float* d_htop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = gemm<false>(d_emb, wd, R, V, Ed, d_logits, s);
  if (err != cudaSuccess) return err;
  softmax_bwd_kernel<<<R, S_NT, 0, s>>>(soft, d_logits, V, temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = gemm<true>(h_top, d_logits, H, V, R, dwp, s);
  if (err != cudaSuccess) return err;
  colsum_kernel<<<(V + 255) / 256, 256, 0, s>>>(d_logits, R, V, dbp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gemm<false>(d_logits, w_proj, R, H, V, d_htop, s);
}

}  // extern "C"
