// Row-wise RMSNorm for Hopper: out[r, :] = x[r, :] * w / rms(x[r, :]).
//
// Replaces dllama_tpu/ops/pallas/rms_norm.py:_kernel (called by
// _rms_norm_2d), the TPU's fused RMSNorm. The engines run it for every
// model norm where their kernels are CUDA (engine/kernel_select: --kernels
// auto on a card, or cuda); ops/layers.RMS_NORM_IMPL = "torch" keeps the
// plain norm there instead.
//
// Semantics (those of ops/layers.rms_norm_plain): in f32, the mean of the
// squares of the row, plus eps, inverse square root, times the row and the
// f32 weight, one rounding to x's dtype.
//
// What bounds it on this card: not bytes. A decode row of 4096 bf16 moves
// 8 KB in, 8 KB out and the 16 KB weight: ~0.01 us at 3.35 TB/s. What a
// launch costs is latency: the wait for the kernel before it (launch and
// gap), then a chain of dependent memory reads inside it.
//
// What the design does about it:
// - One pass, the row in registers. A thread holds VPT vectors of 8
//   neighbouring elements (the template parameter: 1, 2 or 4), vector v
//   of the row at thread v % threads, step v / threads, so a warp's loads are
//   neighbouring 16-byte loads. Every load of the row is issued before the
//   first is used; x is read from device memory once and written once.
// - The weight first. The thread's f32 weight slice does not depend on the
//   kernel before, so its loads are issued before griddepcontrol.wait.
// - Programmatic dependent launch. The host launches with
//   cudaLaunchKernelEx and the programmatic-stream-serialization attribute,
//   so the grid may start while its predecessor (on the path, the residual
//   add or the embedding gather) drains; griddepcontrol.wait holds the first
//   read of x until every write of the predecessor is visible. The kernel
//   does not trigger its own dependents early: no kernel after it is
//   launched with the attribute.
// - Geometry from the host (ops/rms_norm.geometry): threads a row (a
//   multiple of 32, at most 512) and vectors a thread (4 at the widths of
//   Llama-3.1-8B and Mixtral: 128 threads hold a row of 4096 exactly; 1 at
//   the golden fixture's 64). One block a row: a block that walked two or
//   four rows of a 256-row chunk, its weight slice loaded once, was slower
//   (fewer blocks than SMs; PERF.md §6). Weight and row take 16
//   registers a vector a thread; a block of 1024 threads leaves 64
//   registers a thread, too few for 4 vectors, so the one-pass instances
//   stop at 512 threads of 4 vectors (d <= 16,384).
// - A fixed reduction order: each thread sums its squares in vector order,
//   the warp by a butterfly of shuffles (every lane ends with the same
//   bits), the warps in order through shared memory, so the result repeats
//   from run to run.
// - Above that the looped instance reads a row twice, the second time from
//   cache.
// The inverse square root is 1 / sqrtf (correctly rounded), not the
// approximate rsqrtf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;  // elements a vector (d % 8 == 0)
constexpr int kMaxThreads = 1024;  // the looped instance's block
constexpr int kOnePassThreads = 512;  // the one-pass instances' largest block
constexpr int kMaxWarps = kMaxThreads / 32;

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

// griddepcontrol (sm_90): wait for the grids this one depends on.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The sum of v over the block (one row's threads, a multiple of 32), the
// same bits in every thread.
__device__ __forceinline__ float row_sum(float v) {
  __shared__ float sums[kMaxWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (blockDim.x == 32) return v;
  if (threadIdx.x % 32 == 0) sums[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
  const int warps = blockDim.x / 32;
  for (int i = 0; i < warps; ++i) total += sums[i];
  return total;
}

// A row's VPT vectors of this thread into registers, 0 past the row's end.
template <int VPT, typename T>
__device__ __forceinline__ void load_row(const T* row, int nvec, float (&v)[VPT][kVec]) {
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = i * blockDim.x + threadIdx.x;
    if (c < nvec) {
      load8(row + (size_t)c * kVec, v[i]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[i][e] = 0.f;
    }
  }
}

// Block r normalizes row r.
template <typename T, int VPT>
__global__ void __launch_bounds__(kOnePassThreads) rms_norm_kernel(
    const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out, int d,
    long long x_stride, float eps) {
  const int nvec = d / kVec;
  float wv[VPT][kVec];
  load_row<VPT>(w, nvec, wv);
  grid_dependency_wait();
  const int r = blockIdx.x;
  float xv[VPT][kVec];
  load_row<VPT>(x + (size_t)r * x_stride, nvec, xv);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i)
#pragma unroll
    for (int e = 0; e < kVec; ++e) ss = fmaf(xv[i][e], xv[i][e], ss);
  const float inv = 1.0f / sqrtf(row_sum(ss) / (float)d + eps);
  T* orow = out + (size_t)r * d;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = i * blockDim.x + threadIdx.x;
    if (c < nvec) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) xv[i][e] = xv[i][e] * inv * wv[i][e];
      store8(orow + (size_t)c * kVec, xv[i]);
    }
  }
}

// Rows wider than kOnePassThreads * 4 vectors: two passes over each row, the
// second from cache. Block r normalizes row r.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) rms_norm_looped_kernel(
    const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out, int d,
    long long x_stride, float eps) {
  const int nvec = d / kVec;
  grid_dependency_wait();
  const int r = blockIdx.x;
  const T* xr = x + (size_t)r * x_stride;
  float v[kVec], wv[kVec];
  float ss = 0.f;
  for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
    load8(xr + (size_t)c * kVec, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) ss = fmaf(v[e], v[e], ss);
  }
  const float inv = 1.0f / sqrtf(row_sum(ss) / (float)d + eps);
  T* orow = out + (size_t)r * d;
  for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
    load8(xr + (size_t)c * kVec, v);
    load8(w + (size_t)c * kVec, wv);
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = v[e] * inv * wv[e];
    store8(orow + (size_t)c * kVec, v);
  }
}

template <typename T>
cudaError_t launch(const cudaLaunchConfig_t* cfg, int vpt, const void* x, const void* w,
                   void* out, int d, long long x_stride, float eps) {
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  T* ot = static_cast<T*>(out);
  switch (vpt) {
    case 0:
      return cudaLaunchKernelEx(cfg, rms_norm_looped_kernel<T>, xt, wt, ot, d, x_stride, eps);
    case 1:
      return cudaLaunchKernelEx(cfg, rms_norm_kernel<T, 1>, xt, wt, ot, d, x_stride, eps);
    case 2:
      return cudaLaunchKernelEx(cfg, rms_norm_kernel<T, 2>, xt, wt, ot, d, x_stride, eps);
    default:
      return cudaLaunchKernelEx(cfg, rms_norm_kernel<T, 4>, xt, wt, ot, d, x_stride, eps);
  }
}

}  // namespace

// x [rows, d] of dtype (0 = bf16, 1 = f32), rows x_stride elements apart
// (16-byte aligned); w f32 [d]; out [rows, d] contiguous in x's dtype;
// d % 8 == 0. One block a row; the geometry (ops/rms_norm.geometry):
// `threads` a block (a multiple of 32; at most 512 for vpt 1, 2 or 4 with
// vpt * threads * 8 >= d, at most 1024 for vpt 0, the looped instance).
// Returns the CUDA error state after the launch (0 = success; -1 =
// unsupported dtype, width or geometry).
extern "C" int rms_norm(const void* x, const void* w, void* out, int rows, int d,
                        long long x_stride, float eps, int dtype, int threads, int vpt,
                        void* stream) {
  const bool one_pass = vpt == 1 || vpt == 2 || vpt == 4;
  if (d <= 0 || d % kVec || rows <= 0 || threads <= 0 || threads % 32 ||
      !(one_pass || vpt == 0) || threads > (one_pass ? kOnePassThreads : kMaxThreads) ||
      (one_pass && (long long)vpt * threads * kVec < d))
    return -1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (dtype == 0)
    err = launch<__nv_bfloat16>(&cfg, vpt, x, w, out, d, x_stride, eps);
  else if (dtype == 1)
    err = launch<float>(&cfg, vpt, x, w, out, d, x_stride, eps);
  else
    return -1;
  const cudaError_t last = cudaGetLastError();  // read, and cleared, either way
  return (int)(err != cudaSuccess ? err : last);
}
