// Q40 decode product for Hopper: out[m, n] = x[m, k] @ W[k, n], m <= 16.
//
// Replaces dllama_tpu/ops/pallas/q40_matmul.py:_blockdot_kernel (called by
// _blockdot_call), the TPU's decode-shaped Q40 kernel.
//
// What bounds it on this card: device-memory bytes. Each launch streams the
// layer's packed weights once, k*n/2 bytes of nibbles plus k*n/16 bytes of
// f16 scales (0.5625 bytes per weight); with m <= 16 the arithmetic is at
// most 32 operations per weight byte, far below the ~300 per byte where the
// card's compute would take over.
//
// What the design does about it:
//  * A thread owns 4 neighbouring output columns, so each packed row it reads
//    is one aligned 32-bit load and a warp reads 128 contiguous bytes; the
//    scales of a 32-row block are one 64-bit load.
//  * Codes stay exact: a nibble q becomes q - 8 with one OR into the mantissa
//    of 2^23 and one subtraction (no int-to-float conversion). Per 32-row
//    block the kernel forms the partial dot of x with the exact codes, then
//    applies the f16 scale (widened exactly to f32) to that partial, as the
//    TPU blockdot does. The row sums stay in f32 registers.
//  * k is split across blocks so that about 16 blocks per SM are in
//    flight (two warps each at the default 256 columns a block), enough loads to cover the memory latency, even where n is narrow
//    (wk/wv: n = 1024 fills only 4 column blocks).
//    Split-k partials are reduced by a second pass in a fixed order, with no
//    float atomics, so greedy output is the same from run to run.
//  * x is staged in shared memory as f32, 256 input dims at a time.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kCols = 4;                          // output columns per thread
constexpr int kChunkBlocks = 8;                   // 32-row blocks of x staged at once

// THREADS * kCols output columns per block: 256 by default (64 threads);
// 128 and 512 are the BLOCKDOT_TN overrides of the ops wrapper.
template <int M, int THREADS, typename TO>
__global__ void __launch_bounds__(THREADS) q40_decode_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
    const __half* __restrict__ scales, float* __restrict__ partial,
    TO* __restrict__ out, int m, int k, int n, int kb_per_split) {
  __shared__ float xs[M][kChunkBlocks * 32];
  const int col0 = (blockIdx.x * THREADS + threadIdx.x) * kCols;
  const int nkb = k / 32;
  const int kb0 = blockIdx.y * kb_per_split;
  const int kb1 = min(nkb, kb0 + kb_per_split);
  const bool vec = ((n & 3) == 0) && (col0 + kCols <= n);

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
    for (int i = threadIdx.x; i < M * kxn; i += THREADS) {
      const int r = i / kxn, c = i - r * kxn;
      xs[r][c] = r < m ? __bfloat162float(x[(size_t)r * k + kx0 + c]) : 0.f;
    }
    __syncthreads();
    if (col0 >= n) continue;
    for (int kb = kbc; kb < kbe; ++kb) {
      uint32_t p[16];
      float s[kCols];
      const uint8_t* prow = packed + (size_t)kb * 16 * n + col0;
      const __half* srow = scales + (size_t)kb * n + col0;
      if (vec) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          p[j] = __ldg(reinterpret_cast<const uint32_t*>(prow + (size_t)j * n));
        const uint2 sv = __ldg(reinterpret_cast<const uint2*>(srow));
        const __half2 s01 = *reinterpret_cast<const __half2*>(&sv.x);
        const __half2 s23 = *reinterpret_cast<const __half2*>(&sv.y);
        s[0] = __low2float(s01);
        s[1] = __high2float(s01);
        s[2] = __low2float(s23);
        s[3] = __high2float(s23);
      } else {  // ragged right edge, or n not a multiple of 4
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          uint32_t w = 0;
          for (int c = 0; c < kCols; ++c)
            if (col0 + c < n) w |= (uint32_t)prow[(size_t)j * n + c] << (8 * c);
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
        for (int j = 0; j < 16; ++j) {
          const float xlo = xs[r][xo + j];
          const float xhi = xs[r][xo + 16 + j];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const uint32_t byte = p[j] >> (8 * c);
            part[c] = fmaf(q40_code(byte & 15u), xlo, part[c]);
            part[c] = fmaf(q40_code((byte >> 4) & 15u), xhi, part[c]);
          }
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

template <int THREADS, typename TO>
void launch(const void* x, const void* packed, const void* scales, void* partial,
            void* out, int m, int k, int n, int splits, int kb_per_split,
            cudaStream_t st) {
  dim3 grid((n + THREADS * kCols - 1) / (THREADS * kCols), splits);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* pp = static_cast<const uint8_t*>(packed);
  const auto* sp = static_cast<const __half*>(scales);
  auto* part = static_cast<float*>(partial);
  auto* o = static_cast<TO*>(out);
  if (m <= 1)
    q40_decode_kernel<1, THREADS, TO><<<grid, THREADS, 0, st>>>(xp, pp, sp, part, o, m, k, n, kb_per_split);
  else if (m <= 2)
    q40_decode_kernel<2, THREADS, TO><<<grid, THREADS, 0, st>>>(xp, pp, sp, part, o, m, k, n, kb_per_split);
  else if (m <= 4)
    q40_decode_kernel<4, THREADS, TO><<<grid, THREADS, 0, st>>>(xp, pp, sp, part, o, m, k, n, kb_per_split);
  else if (m <= 8)
    q40_decode_kernel<8, THREADS, TO><<<grid, THREADS, 0, st>>>(xp, pp, sp, part, o, m, k, n, kb_per_split);
  else
    q40_decode_kernel<16, THREADS, TO><<<grid, THREADS, 0, st>>>(xp, pp, sp, part, o, m, k, n, kb_per_split);
  if (splits > 1) {
    const size_t mn = (size_t)m * n;
    launch_splitk_reduce<TO>(part, o, mn, splits, st);
  }
}

template <typename TO>
int launch_cols(const void* x, const void* packed, const void* scales, void* partial,
                void* out, int m, int k, int n, int splits, int kb_per_split,
                int cols_per_block, cudaStream_t st) {
  switch (cols_per_block) {
    case 128:
      launch<32, TO>(x, packed, scales, partial, out, m, k, n, splits, kb_per_split, st);
      return 0;
    case 256:
      launch<64, TO>(x, packed, scales, partial, out, m, k, n, splits, kb_per_split, st);
      return 0;
    case 512:
      launch<128, TO>(x, packed, scales, partial, out, m, k, n, splits, kb_per_split, st);
      return 0;
  }
  return -1;  // a column tile the library was not built for
}

}  // namespace

// x bf16 [m, k]; packed u8 [k/2, n]; scales f16 [k/32, n]; out [m, n] in
// bf16 (out_f32 == 0) or f32; partial f32 [splits, m, n] (unused when
// splits == 1); cols_per_block 128, 256 or 512. Returns the CUDA error state
// after the launches (0 = success; -1 = a column tile not built).
extern "C" int q40_decode(const void* x, const void* packed, const void* scales,
                          void* partial, void* out, int m, int k, int n, int splits,
                          int kb_per_split, int out_f32, int cols_per_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bad = out_f32
      ? launch_cols<float>(x, packed, scales, partial, out, m, k, n, splits, kb_per_split,
                           cols_per_block, st)
      : launch_cols<__nv_bfloat16>(x, packed, scales, partial, out, m, k, n, splits,
                                   kb_per_split, cols_per_block, st);
  return bad ? bad : (int)cudaGetLastError();
}
