// Row-wise RMSNorm for Hopper: out[r, :] = x[r, :] * w / rms(x[r, :]).
//
// Replaces dllama_tpu/ops/pallas/rms_norm.py:_kernel (called by
// _rms_norm_2d), the TPU's fused RMSNorm, behind the same switch
// (ops/layers.RMS_NORM_IMPL, off by default).
//
// Semantics (those of ops/layers.rms_norm_plain): in f32, the mean of the
// squares of the row, plus eps, inverse square root, times the row and the
// f32 weight, one rounding to x's dtype.
//
// What bounds it on this card: device-memory bytes - each row is read once
// and written once (the weight is shared by every row and stays in cache),
// with a handful of operations per element. At a decode step (one row of
// 4096) the bound is ~0.01 us and the launch itself is the cost.
//
// What the design does about it: one block of 128 threads per row; each
// thread reads 8 neighbouring elements at a time with 16-byte loads (bf16:
// one load, f32: two), sums their squares in f32, and the block reduces the
// sums with warp shuffles and one shared-memory pass in a fixed order (the
// result repeats from run to run). The second pass reads the row again (from
// L1/L2, not device memory), scales it and writes it with 16-byte stores.
// The inverse square root is 1 / sqrtf (correctly rounded), not the
// approximate rsqrtf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 8;  // elements per thread per step (d % 8 == 0)

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(h);
    v[2 * i + 1] = __high2float(h);
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  alignas(16) __nv_bfloat16 h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rms_norm_kernel(
    const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out, int d,
    long long x_stride, float eps) {
  __shared__ float warp_sums[kThreads / 32];
  const T* xr = x + (size_t)blockIdx.x * x_stride;
  T* orow = out + (size_t)blockIdx.x * d;
  float v[kVec];
  float ss = 0.f;
  for (int i = threadIdx.x * kVec; i < d; i += kThreads * kVec) {
    load8(xr + i, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) ss = fmaf(v[e], v[e], ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
  const float inv = 1.0f / sqrtf(total / (float)d + eps);
  for (int i = threadIdx.x * kVec; i < d; i += kThreads * kVec) {
    float wv[kVec];
    load8(xr + i, v);
    load8(w + i, wv);
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = v[e] * inv * wv[e];
    store8(orow + i, v);
  }
}

}  // namespace

// x [rows, d] of dtype (0 = bf16, 1 = f32), rows x_stride elements apart
// (16-byte aligned); w f32 [d]; out [rows, d] contiguous in x's dtype;
// d % 8 == 0. Returns the CUDA error state after the launch (0 = success;
// -1 = unsupported dtype or d).
extern "C" int rms_norm(const void* x, const void* w, void* out, int rows, int d,
                        long long x_stride, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % kVec || rows <= 0) return -1;
  if (dtype == 0)
    rms_norm_kernel<__nv_bfloat16><<<rows, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(out), d, x_stride, eps);
  else if (dtype == 1)
    rms_norm_kernel<float><<<rows, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), d, x_stride, eps);
  else
    return -1;
  return (int)cudaGetLastError();
}
