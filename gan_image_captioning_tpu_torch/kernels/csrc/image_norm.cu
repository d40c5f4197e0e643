// Device-side image normalization for Hopper (sm_90a): uint8 -> float32,
// or bfloat16 (the bfloat16 instantiation, `--dtype bfloat16`: the same
// float32 affine map, each result rounded once to bfloat16, as the TPU
// kernel's `.astype(out_ref.dtype)`).
//
// Replaces: gan_image_captioning_tpu/kernels/image_norm.py, function
// `_kernel` (launched by `normalize_images`).  For u8 [B, 3, H, W]:
//   out[b, c, y, x] = u8[b, c, y, x] * scale[c] + shift[c]
// with scale = 1 / (255 std[c]) and shift = -mean[c] / std[c], computed in
// double by the wrapper and rounded to float32, as the TPU kernel takes them.
// The product and the sum are rounded separately (__fmul_rn, __fadd_rn):
// nvcc may not contract them into one FMA, so the result is bit-equal to
// the plain version's `u8.float() * scale + shift`.
//
// What bounds it on this card.  Five bytes per element (one read, four
// written) and two operations: at B = 64 and 3 x 256 x 256 that is 62.9 MB,
// 18.8 us at 3.35 TB/s.  Bytes.  bfloat16: three bytes per element (37.7
// MB, 11.3 us).
//
// What this design does about it.  It is the simple version: one thread
// per four elements, one 4-byte uchar4 load and one 16-byte float4 store,
// neighbouring threads on neighbouring addresses, so every warp moves whole
// 128-byte lines.  The channel comes from the flat index; a group of four
// that spans two planes (H*W % 4 != 0) takes each element's own channel.
// bfloat16 stores the four as 8 bytes (two bfloat162).
// The last N % 4 elements are a scalar tail in one thread.  An input that
// is not 4-byte aligned (a view at an odd offset) takes a scalar kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

using gic::bf16;

constexpr int NT = 256;

struct Affine {
  float scale[3], shift[3];
};

__device__ __forceinline__ float norm(unsigned char v, int c, const Affine& a) {
  return __fadd_rn(__fmul_rn(static_cast<float>(v), a.scale[c]), a.shift[c]);
}

__device__ __forceinline__ int channel(long long e, long long hw) {
  return static_cast<int>((e / hw) % 3);
}

template <class T>
__global__ void image_norm_vec_kernel(const uchar4* __restrict__ in4,
                                      const unsigned char* __restrict__ in,
                                      T* __restrict__ out, long long n,
                                      long long hw, Affine a) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = n / 4;
  if (g < n4) {
    const uchar4 v = in4[g];
    const long long e = 4 * g;
    const int c0 = channel(e, hw);
    float4 r;
    if ((e + 3) / hw == e / hw) {  // one plane: one channel
      r = make_float4(norm(v.x, c0, a), norm(v.y, c0, a), norm(v.z, c0, a),
                      norm(v.w, c0, a));
    } else {
      r = make_float4(norm(v.x, c0, a), norm(v.y, channel(e + 1, hw), a),
                      norm(v.z, channel(e + 2, hw), a),
                      norm(v.w, channel(e + 3, hw), a));
    }
    gic::st4w(out + 4 * g, r);
  } else if (g == n4) {
    for (long long e = 4 * n4; e < n; ++e)
      gic::store_as(out, e, norm(in[e], channel(e, hw), a));
  }
}

template <class T>
__global__ void image_norm_scalar_kernel(const unsigned char* __restrict__ in,
                                         T* __restrict__ out, long long n,
                                         long long hw, Affine a) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) gic::store_as(out, e, norm(in[e], channel(e, hw), a));
}

template <class T>
int image_norm(const unsigned char* u8, T* out, long long n, int hw,
               const Affine& a, cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(u8) & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const long long threads = n / 4 + 1;  // the last one runs the tail
    const unsigned blocks = (unsigned)((threads + NT - 1) / NT);
    image_norm_vec_kernel<T><<<blocks, NT, 0, s>>>(
        reinterpret_cast<const uchar4*>(u8), u8, out, n, hw, a);
  } else {
    const unsigned blocks = (unsigned)((n + NT - 1) / NT);
    image_norm_scalar_kernel<T><<<blocks, NT, 0, s>>>(u8, out, n, hw, a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// u8 [B, 3, H, W] contiguous -> out of the same shape (16-byte aligned, as
// torch allocates it), float32, or bfloat16 when bf16 = 1, on `stream`.
// Returns 0 or the CUDA error code of the launch; nothing synchronises.
int gic_image_norm(const unsigned char* u8, void* out, long long n, int hw,
                   float scale0, float scale1, float scale2, float shift0,
                   float shift1, float shift2, int bf16_, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Affine a = {{scale0, scale1, scale2}, {shift0, shift1, shift2}};
  if (bf16_) return image_norm(u8, static_cast<bf16*>(out), n, hw, a, s);
  return image_norm(u8, static_cast<float*>(out), n, hw, a, s);
}

}  // extern "C"
