// Q80 decode product for Hopper: out[m, n] = x[m, k] @ W[k, n], m <= 16.
//
// Replaces dllama_tpu/ops/pallas/q80_matmul.py:_blockdot_kernel (called by
// _blockdot_call), the TPU's decode-shaped Q80 kernel.
//
// What bounds it on this card: device-memory bytes. Each launch streams the
// layer's weights once: k*n bytes of int8 codes plus k*n/16 bytes of f16
// scales (1.0625 bytes per weight, 1.89x Q40's 0.5625); with m <= 16 the
// arithmetic is at most 32 operations per weight byte, far below the ~300 per
// byte where the card's compute would take over.
//
// What the design does about it (K1's design, q40_decode.cu, with the
// weight rows twice as wide):
//  * A thread owns 4 neighbouring output columns, so each k row of codes it
//    reads is one aligned 32-bit load and a warp reads 128 contiguous bytes
//    of the row; the 32 rows of one block are 32 independent loads in flight
//    per thread. The scales of a 32-row block are one 64-bit load.
//  * Codes stay exact: each int8 byte, -128 included, is sign-extended and
//    converted to f32 exactly. Per 32-row block the kernel forms the partial
//    dot y[kb] = x_kb . codes_kb in f32, then applies the f16 scale (widened
//    exactly by __half2float) to that partial, not to each weight, as the
//    TPU blockdot does: out = sum_kb s[kb] * y[kb]. The row sums stay in f32
//    registers.
//  * k is split into runs of four 32-row blocks (128 rows), each its own
//    split, whatever n is: wq at k = 4096 gets 32 splits x 16 column blocks,
//    enough two-warp blocks to cover the memory latency even where n is
//    narrow (wk/wv: n = 1024 fills only 4 column blocks). Unlike K1, the
//    count depends on k alone, so a column's sum has the same order in any
//    weight: wq/wk/wv and w1/w3 give bit-equal columns when fused into
//    wqkv/w13 (--fuse-weights). The price is the f32 partials, 8 bytes per
//    split and output (written, then read), 6 % of the weight bytes at m = 1.
//    Split-k partials are reduced by a second pass in a fixed order, with no
//    float atomics, so greedy output is the same from run to run.
//  * x is staged in shared memory as f32, 256 input dims at a time.
//  * A ragged n (or a weight whose rows are not 4-byte aligned) takes a
//    byte-wise load path with the columns past n masked.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kCols = 4;                          // output columns per thread
constexpr int kColsPerBlock = kThreads * kCols;   // 256
constexpr int kChunkBlocks = 8;                   // 32-row blocks of x staged at once

// Signed code of byte c (0..3) of a little-endian word, exactly.
__device__ __forceinline__ float code_f32(uint32_t w, int c) {
  return (float)((int32_t)(w << (24 - 8 * c)) >> 24);
}

template <int M, typename TO>
__global__ void __launch_bounds__(kThreads) q80_decode_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
    const __half* __restrict__ scales, float* __restrict__ partial,
    TO* __restrict__ out, int m, int k, int n, int kb_per_split, int aligned) {
  __shared__ float xs[M][kChunkBlocks * 32];
  const int col0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int nkb = k / 32;
  const int kb0 = blockIdx.y * kb_per_split;
  const int kb1 = min(nkb, kb0 + kb_per_split);
  const bool vec = aligned && ((n & 3) == 0) && (col0 + kCols <= n);

  float acc[M][kCols];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int kbc = kb0; kbc < kb1; kbc += kChunkBlocks) {
    const int kbe = min(kb1, kbc + kChunkBlocks);
    const int kx0 = kbc * 32;
    const int kxn = (kbe - kbc) * 32;
    __syncthreads();  // the previous chunk's reads of xs are done
    for (int i = threadIdx.x; i < M * kxn; i += kThreads) {
      const int r = i / kxn, c = i - r * kxn;
      xs[r][c] = r < m ? __bfloat162float(x[(size_t)r * k + kx0 + c]) : 0.f;
    }
    __syncthreads();
    if (col0 >= n) continue;
    for (int kb = kbc; kb < kbe; ++kb) {
      uint32_t p[32];
      float s[kCols];
      const int8_t* crow = codes + (size_t)kb * 32 * n + col0;
      const __half* srow = scales + (size_t)kb * n + col0;
      if (vec) {
#pragma unroll
        for (int j = 0; j < 32; ++j)
          p[j] = __ldg(reinterpret_cast<const uint32_t*>(crow + (size_t)j * n));
        const uint2 sv = __ldg(reinterpret_cast<const uint2*>(srow));
        const __half2 s01 = *reinterpret_cast<const __half2*>(&sv.x);
        const __half2 s23 = *reinterpret_cast<const __half2*>(&sv.y);
        s[0] = __low2float(s01);
        s[1] = __high2float(s01);
        s[2] = __low2float(s23);
        s[3] = __high2float(s23);
      } else {  // ragged right edge, n not a multiple of 4, or unaligned rows
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          uint32_t w = 0;
          for (int c = 0; c < kCols; ++c)
            if (col0 + c < n)
              w |= (uint32_t)(uint8_t)crow[(size_t)j * n + c] << (8 * c);
          p[j] = w;
        }
        for (int c = 0; c < kCols; ++c)
          s[c] = col0 + c < n ? __half2float(srow[c]) : 0.f;
      }
      const int xo = (kb - kbc) * 32;
#pragma unroll
      for (int r = 0; r < M; ++r) {
        float part[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float xv = xs[r][xo + j];
#pragma unroll
          for (int c = 0; c < kCols; ++c) part[c] = fmaf(code_f32(p[j], c), xv, part[c]);
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(s[c], part[c], acc[r][c]);
      }
    }
  }
  if (col0 >= n) return;
  const bool direct = gridDim.y == 1;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r >= m) break;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = col0 + c;
      if (col >= n) break;
      if (direct)
        store(out + (size_t)r * n + col, acc[r][c]);
      else
        partial[((size_t)blockIdx.y * m + r) * n + col] = acc[r][c];
    }
  }
}

template <typename TO>
void launch(const void* x, const void* codes, const void* scales, void* partial,
            void* out, int m, int k, int n, int splits, int kb_per_split,
            cudaStream_t st) {
  dim3 grid((n + kColsPerBlock - 1) / kColsPerBlock, splits);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* cp = static_cast<const int8_t*>(codes);
  const auto* sp = static_cast<const __half*>(scales);
  auto* part = static_cast<float*>(partial);
  auto* o = static_cast<TO*>(out);
  const int aligned = (reinterpret_cast<uintptr_t>(codes) % 4 == 0) &&
                      (reinterpret_cast<uintptr_t>(scales) % 8 == 0);
#define DLLAMA_Q80_DECODE(MM)                                                             \
  q80_decode_kernel<MM, TO><<<grid, kThreads, 0, st>>>(xp, cp, sp, part, o, m, k, n, \
                                                       kb_per_split, aligned)
  if (m <= 1)
    DLLAMA_Q80_DECODE(1);
  else if (m <= 2)
    DLLAMA_Q80_DECODE(2);
  else if (m <= 4)
    DLLAMA_Q80_DECODE(4);
  else if (m <= 8)
    DLLAMA_Q80_DECODE(8);
  else
    DLLAMA_Q80_DECODE(16);
#undef DLLAMA_Q80_DECODE
  if (splits > 1) {
    const size_t mn = (size_t)m * n;
    launch_splitk_reduce<TO>(part, o, mn, splits, st);
  }
}

}  // namespace

// x bf16 [m, k]; codes i8 [k, n]; scales f16 [k/32, n]; out [m, n] in bf16
// (out_f32 == 0) or f32; partial f32 [splits, m, n] (unused when splits ==
// 1), each split walking kb_per_split 32-row blocks. Returns the CUDA error
// state after the launches (0 = success).
extern "C" int q80_decode(const void* x, const void* codes, const void* scales,
                          void* partial, void* out, int m, int k, int n, int splits,
                          int kb_per_split, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    launch<float>(x, codes, scales, partial, out, m, k, n, splits, kb_per_split, st);
  else
    launch<__nv_bfloat16>(x, codes, scales, partial, out, m, k, n, splits, kb_per_split, st);
  return (int)cudaGetLastError();
}
