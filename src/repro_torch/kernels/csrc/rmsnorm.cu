// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rmsnorm_rows in
// src/repro/kernels/rmsnorm/kernel.py (wrapper rmsnorm_fused in ops.py):
// y = x * rsqrt(mean(x^2) + eps) * scale per row, the math in fp32 and the
// result cast back to x's type.
//
// Bound: bytes.  Each row is read and written once (R*D*2*sizeof(x) plus
// the fp32 scale); the arithmetic is a few operations per element.  The
// design therefore spends nothing on compute and keeps the row traffic at
// one read and one write of device memory: one CTA per row, 16-byte
// vector loads where the row length allows them (D*sizeof(x) % 16 == 0 and
// aligned pointers), scalar loads otherwise, the sum of squares reduced in
// fp32 across the CTA, then the scaled write.  The second pass re-reads the
// row, which a CTA has just touched and finds in L1/L2.  A row of D <= 256
// (bf16) or D <= 128 (fp32) gets a CTA of one warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the CTA; every thread gets the total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kMaxThreads / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    float t = lane < nw ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) total = t;
  }
  __syncthreads();
  return total;
}

// VEC elements per 16-byte access; VEC == 1 is the scalar path.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    T* __restrict__ y, int D, float eps) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  float ss = 0.f;
  if constexpr (VEC > 1) {
    const int n = D / VEC;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      uint4 u = reinterpret_cast<const uint4*>(xr)[i];
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f(t[e]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float f = to_f(xr[i]);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(block_sum(ss) / static_cast<float>(D) + eps);
  if constexpr (VEC > 1) {
    const int n = D / VEC;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      uint4 u = reinterpret_cast<const uint4*>(xr)[i];
      const T* t = reinterpret_cast<const T*>(&u);
      float s[VEC];
#pragma unroll
      for (int c = 0; c < VEC / 4; ++c) {
        const float4 s4 = reinterpret_cast<const float4*>(scale + i * VEC)[c];
        s[4 * c] = s4.x;
        s[4 * c + 1] = s4.y;
        s[4 * c + 2] = s4.z;
        s[4 * c + 3] = s4.w;
      }
      uint4 o;
      T* ot = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ot[e] = from_f<T>(to_f(t[e]) * inv * s[e]);
      reinterpret_cast<uint4*>(yr)[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x)
      yr[i] = from_f<T>(to_f(xr[i]) * inv * scale[i]);
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* scale, void* y, int R, int D,
            float eps, cudaStream_t stream) {
  const int chunks = VEC > 1 ? D / VEC : D;
  int threads = ((chunks + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  rmsnorm_rows_kernel<T, VEC><<<R, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(y), D, eps);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// x, y: (R, D) contiguous rows of dtype (0 = float32, 1 = bfloat16);
// scale: (D,) float32.  Launches on `stream` and returns cudaGetLastError().
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* y, int R,
                           int D, float eps, int dtype, void* stream) {
  if (R <= 0 || D <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = dtype == 0 ? 4 : 2;
  const bool vec = (D * elem) % 16 == 0 && aligned16(x) && aligned16(y) &&
                   aligned16(scale);
  if (dtype == 0) {
    if (vec) launch<float, 4>(x, scale, y, R, D, eps, s);
    else launch<float, 1>(x, scale, y, R, D, eps, s);
  } else {
    if (vec) launch<__nv_bfloat16, 8>(x, scale, y, R, D, eps, s);
    else launch<__nv_bfloat16, 1>(x, scale, y, R, D, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}
