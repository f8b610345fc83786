// Q40 decode product on the CUDA cores, in one fixed order: out[m, n] =
// x[m, k] @ W[k, n], m <= 16. The `loopdot` style of the ops wrapper
// (STYLE = "loopdot").
//
// Replaces dllama_tpu/ops/pallas/q40_matmul.py:_loopdot_kernel (called by
// _loopdot_call). On the TPU that kernel is the most lowering-conservative
// form of blockdot's math: nb plain [m, 32] x [32, tn] dots of exact codes,
// unrolled, no batched dot and no masking. Its counterpart here is the most
// conservative kernel: CUDA cores only, no shared memory, no split-k. Each
// thread owns one output column for all m rows and walks the 32-row blocks
// of k in ascending order; per block it forms the 32-term dot of the x row
// with the exact codes q - 8 (k ascending: the low nibbles of the block's 16
// packed rows, then the high ones), then adds the f16 scale (widened
// exactly) times that partial to its f32 sum. One sum order, whatever the
// card or the launch.
//
// What bounds it on this card: device-memory bytes (0.5625 bytes a weight),
// but the design does nothing about it: n threads, one per column, each
// reading its column's 16 bytes a block, and x from the cache (16-byte
// loads, the same address across a warp). Narrow weights (wk/wv, n = 1024:
// eight blocks) leave most SMs idle. It is kept slow on purpose, as the
// reference point of the fast forms.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void widen8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __low2float(h[e]);
    f[2 * e + 1] = __high2float(h[e]);
  }
}

template <int M, typename TO>
__global__ void __launch_bounds__(kThreads) q40_loopdot_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
    const __half* __restrict__ scales, TO* __restrict__ out, int m, int k, int n) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= n) return;
  float acc[M];
#pragma unroll
  for (int r = 0; r < M; ++r) acc[r] = 0.f;
  const int nkb = k / 32;
  for (int kb = 0; kb < nkb; ++kb) {
    float c[32];  // the block's exact codes, k ascending
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t byte = __ldg(packed + ((size_t)kb * 16 + j) * n + col);
      c[j] = q40_code(byte & 15u);
      c[j + 16] = q40_code(byte >> 4);
    }
    const float s = __half2float(__ldg(scales + (size_t)kb * n + col));
#pragma unroll
    for (int r = 0; r < M; ++r) {
      if (r >= m) break;
      const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * k + kb * 32);
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float xv[8];
        widen8(__ldg(xr + q), xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(xv[e], c[q * 8 + e], part);
      }
      acc[r] = fmaf(s, part, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r >= m) break;
    store(out + (size_t)r * n + col, acc[r]);
  }
}

template <typename TO>
void launch(const void* x, const void* packed, const void* scales, void* out, int m, int k,
            int n, cudaStream_t st) {
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* pp = static_cast<const uint8_t*>(packed);
  const auto* sp = static_cast<const __half*>(scales);
  auto* o = static_cast<TO*>(out);
  if (m <= 1)
    q40_loopdot_kernel<1, TO><<<grid, kThreads, 0, st>>>(xp, pp, sp, o, m, k, n);
  else if (m <= 4)
    q40_loopdot_kernel<4, TO><<<grid, kThreads, 0, st>>>(xp, pp, sp, o, m, k, n);
  else if (m <= 8)
    q40_loopdot_kernel<8, TO><<<grid, kThreads, 0, st>>>(xp, pp, sp, o, m, k, n);
  else
    q40_loopdot_kernel<16, TO><<<grid, kThreads, 0, st>>>(xp, pp, sp, o, m, k, n);
}

}  // namespace

// x bf16 [m, k] (m <= 16, 16-byte aligned, k % 32 == 0); packed u8 [k/2, n];
// scales f16 [k/32, n]; out [m, n] in bf16 (out_f32 == 0) or f32. Returns
// the CUDA error state after the launch (0 = success).
extern "C" int q40_loopdot(const void* x, const void* packed, const void* scales, void* out,
                           int m, int k, int n, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    launch<float>(x, packed, scales, out, m, k, n, st);
  else
    launch<__nv_bfloat16>(x, packed, scales, out, m, k, n, st);
  return (int)cudaGetLastError();
}
