// The kernel benchmark's legacy f32-FMA Q40 product (variant B of
// dllama_tpu_torch/experiments/kbench.py): out[m, n] = x[m, k] @ W[k, n] in
// f32 for any m, with W dequantized as w = f * s - 8 * s from the unsigned
// nibble f and an f32 scale s.
//
// Replaces experiments/kbench.py:_kernel_b (called through make_call), the
// TPU benchmark's f32 variant: codes widened to f32, the dequant as one
// multiply and one subtract per weight, an f32 dot with no bf16 rounding.
//
// What bounds it on this card: f32 operations on the CUDA cores once m is
// large (2*m*k*n of them, at 67 TFLOP/s), device-memory bytes at decode row
// counts (k*n/2 nibbles plus k*n/8 bytes of f32 scales). What the design does:
// a tiled CUDA-core GEMM. A block of 256 threads owns a 64 x 64 output tile
// and walks k one 32-row Q40 block at a time: it stages the x rows (widened
// to f32) and the dequantized 32 x 64 weight tile in shared memory, then each
// thread accumulates a 4 x 4 micro-tile from registers. The dequant is kept
// out of fused multiply-adds (__fmul_rn / __fsub_rn) so it rounds as the
// plain version does. No split-k and no double buffering: this is a
// benchmark's reference point, not a path of the system.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32;  // BK: one Q40 block
constexpr int kThreads = 256;             // 16 x 16 threads, 4 x 4 outputs each

template <typename TX>
__device__ __forceinline__ float widen(TX v);
template <>
__device__ __forceinline__ float widen<float>(float v) { return v; }
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TX>
__global__ void __launch_bounds__(kThreads) kbench_fma_f32_kernel(
    const TX* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scales, float* __restrict__ out, int m, int k, int n) {
  __shared__ __align__(16) float xs[BK][BM + 4];  // k-major: xs[kk][row]
  __shared__ __align__(16) float ws[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nkb = k / BK;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    // x tile: 64 rows x 32 dims, 8 per thread, stored transposed
#pragma unroll
    for (int q = 0; q < (BM * BK) / kThreads; ++q) {
      const int i = tid + q * kThreads;
      const int r = i / BK, c = i % BK;
      const int gr = row0 + r;
      xs[c][r] = gr < m ? widen<TX>(x[(size_t)gr * k + kb * BK + c]) : 0.f;
    }
    // weight tile: packed row j of the block holds dims j (low nibble) and
    // j + 16 (high nibble); 16 rows x 64 columns, 4 per thread
#pragma unroll
    for (int q = 0; q < (16 * BN) / kThreads; ++q) {
      const int i = tid + q * kThreads;
      const int j = i / BN, c = i % BN;
      const int gc = col0 + c;
      float lo = 0.f, hi = 0.f;
      if (gc < n) {
        const uint32_t byte = packed[((size_t)kb * 16 + j) * n + gc];
        const float s = scales[(size_t)kb * n + gc];
        const float s8 = 8.f * s;  // exact
        lo = __fsub_rn(__fmul_rn((float)(byte & 15u), s), s8);
        hi = __fsub_rn(__fmul_rn((float)(byte >> 4), s), s8);
      }
      ws[j][c] = lo;
      ws[j + 16][c] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= m) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx * 4 + j;
      if (gc < n) out[(size_t)gr * n + gc] = acc[i][j];
    }
  }
}

}  // namespace

// x [m, k] in bf16 (x_f32 == 0) or f32, k % 32 == 0; packed u8 [k/2, n];
// scales f32 [k/32, n]; out f32 [m, n]. Returns the CUDA error state after
// the launch (0 = success).
extern "C" int kbench_fma_f32(const void* x, const void* packed, const void* scales,
                              void* out, int m, int k, int n, int x_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const auto* pp = static_cast<const uint8_t*>(packed);
  const auto* sp = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  if (x_f32)
    kbench_fma_f32_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), pp, sp, o, m, k, n);
  else
    kbench_fma_f32_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), pp, sp, o, m, k, n);
  return (int)cudaGetLastError();
}
