// Device helpers shared by the kernels in this directory. Included by each
// source, never built alone; build.py hashes it into every library's name,
// so a change here rebuilds them all.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The exact signed code q - 8 of a Q40 nibble q as f32: 2^23 has an ulp of
// exactly 1, so OR-ing q in gives 2^23 + q, and subtracting 2^23 + 8 is exact
// (Sterbenz). No int-to-float conversion.
__device__ __forceinline__ float q40_code(uint32_t nib) {
  return __uint_as_float(0x4B000000u | nib) - 8388616.0f;
}

// An f32 pair as three bf16x2 terms, t[0] + t[1] + t[2] == v exactly (for
// |v| >= 2^-110): each term is the bf16 rounding of what the terms before it
// left, and each remainder is exact in f32 (24 significant bits, 8 a term).
__device__ __forceinline__ void split_bf16x3(float2 v, uint32_t (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __float22bfloat162_rn(v);
    t[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    v = make_float2(v.x - f.x, v.y - f.y);
  }
}

// The second pass of every split-k product: out[i] = the sum over splits,
// in split order, of partial[split, i], for i < mn. No float atomics, so a
// result is the same from run to run.
template <typename TO>
__global__ void splitk_reduce(const float* __restrict__ partial, TO* __restrict__ out,
                              size_t mn, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float sum = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * mn + i];
  store(out + i, sum);
}

template <typename TO>
void launch_splitk_reduce(const float* partial, TO* out, size_t mn, int splits,
                          cudaStream_t st) {
  splitk_reduce<TO><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(partial, out, mn, splits);
}

}  // namespace
