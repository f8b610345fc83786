// Q40 decode product on the tensor cores: out[m, n] = x[m, k] @ W[k, n],
// m <= 16. The `maskdot` style of the ops wrapper (STYLE = "maskdot").
//
// Replaces dllama_tpu/ops/pallas/q40_matmul.py:_maskdot_kernel (called by
// _maskdot_call). On the TPU that kernel expresses blockdot's per-block
// partial dots as ONE plain dot of a block-masked activation matrix against
// the exact codes on the matrix unit, accepting redundant multiply-adds.
// Here the same function runs on the tensor cores:
//
//  * per 32-row block of k, two mma.sync.m16n8k16 bf16 steps into a zeroed
//    f32 fragment: A is the x rows padded to 16 (the pad rows are the
//    redundant multiply-adds), B the exact codes q - 8, lossless in bf16;
//    bf16 x bf16 products are exact in f32, so the fragment holds the
//    block's partial dot y_b;
//  * then acc += s_b * y_b in f32, with the f16 scale widened exactly, as
//    blockdot applies the scale to the partial;
//  * k is split across blocks by ops.q40_matmul.maskdot_splits
//    and the f32 partials are summed by a second pass in split order: no
//    float atomics, so greedy output repeats from run to run.
//
// What bounds it on this card: device-memory bytes, as K1 (0.5625 bytes a
// weight, at most 32 operations a byte at m <= 16). What the design does
// about it: a block of 4 warps owns 128 columns; each chunk of 8 blocks of k
// (16 KB of nibbles, their scales and the x rows) is staged into shared
// memory with 16-byte loads, 128 contiguous bytes of a packed row per 8
// threads, all issued before the first is used. The tensor cores do the
// unpacked products; a thread unpacks only the 16 codes of its fragments
// per block. The weight is addressed through the free view packed[layer]
// of the stacked [L, k/2, n] array, as K1.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kColsPerBlock = kWarps * 32;  // 4 n8 tiles per warp
constexpr int kChunkBlocks = 8;             // 32-row blocks of k staged at once
constexpr int kChunkDims = kChunkBlocks * 32;
constexpr int kLdx = kChunkDims + 8;        // bf16 per staged x row (no bank conflicts)
constexpr int kLdp = kColsPerBlock + 16;    // bytes per staged packed row (16-byte aligned)

// Two codes as one bf16x2 register: `lo` in the low half (the lower k index).
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t lo, uint32_t hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(q40_code(lo), q40_code(hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// M: rows held (8 or 16); rows m..M-1 are zero.
template <int M, typename TO>
__global__ void __launch_bounds__(kThreads) q40_maskdot_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
    const __half* __restrict__ scales, float* __restrict__ partial,
    TO* __restrict__ out, int m, int k, int n, int kb_per_split) {
  __shared__ __align__(16) __nv_bfloat16 xs[M][kLdx];
  __shared__ __align__(16) uint8_t pk[kChunkBlocks][16][kLdp];
  __shared__ float ss[kChunkBlocks][kColsPerBlock];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * kColsPerBlock;
  const int nkb = k / 32;
  const int kb0 = blockIdx.y * kb_per_split;
  const int kb1 = min(nkb, kb0 + kb_per_split);
  const bool vec = (n % 16) == 0 && col0 + kColsPerBlock <= n;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int kbc = kb0; kbc < kb1; kbc += kChunkBlocks) {
    const int nbc = min(kb1, kbc + kChunkBlocks) - kbc;  // blocks in this chunk
    __syncthreads();  // the previous chunk's reads of shared memory are done
    // x rows: 16-byte loads of 8 bf16 (k % 32 == 0 keeps them aligned)
    for (int i = tid; i < M * (kChunkDims / 8); i += kThreads) {
      const int r = i / (kChunkDims / 8), c = (i % (kChunkDims / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < m && c < nbc * 32)
        v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * k + kbc * 32 + c));
      *reinterpret_cast<uint4*>(&xs[r][c]) = v;
    }
    if (vec) {
      uint4 p[kChunkBlocks];  // all of a thread's loads in flight at once
#pragma unroll
      for (int q = 0; q < kChunkBlocks; ++q) {
        const int i = tid + q * kThreads;  // (block, row, 16-byte column chunk)
        const int bi = i / 128, row = (i / 8) % 16, c = (i % 8) * 16;
        p[q] = bi < nbc ? __ldg(reinterpret_cast<const uint4*>(
                              packed + ((size_t)(kbc + bi) * 16 + row) * n + col0 + c))
                        : make_uint4(0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u);
      }
      const int sbi = tid / 16, sc = (tid % 16) * 8;
      uint4 sv = make_uint4(0u, 0u, 0u, 0u);
      if (sbi < nbc)
        sv = __ldg(reinterpret_cast<const uint4*>(scales + (size_t)(kbc + sbi) * n + col0 + sc));
#pragma unroll
      for (int q = 0; q < kChunkBlocks; ++q) {
        const int i = tid + q * kThreads;
        *reinterpret_cast<uint4*>(&pk[i / 128][(i / 8) % 16][(i % 8) * 16]) = p[q];
      }
      const __half2* h = reinterpret_cast<const __half2*>(&sv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ss[sbi][sc + 2 * e] = __low2float(h[e]);
        ss[sbi][sc + 2 * e + 1] = __high2float(h[e]);
      }
    } else {  // ragged right edge, or n not a multiple of 16: code 0, scale 0 outside
      for (int i = tid; i < kChunkBlocks * 16 * kColsPerBlock; i += kThreads) {
        const int bi = i / (16 * kColsPerBlock), row = (i / kColsPerBlock) % 16;
        const int c = i % kColsPerBlock;
        const bool in = bi < nbc && col0 + c < n;
        pk[bi][row][c] = in ? packed[((size_t)(kbc + bi) * 16 + row) * n + col0 + c]
                            : (uint8_t)0x88;
      }
      for (int i = tid; i < kChunkBlocks * kColsPerBlock; i += kThreads) {
        const int bi = i / kColsPerBlock, c = i % kColsPerBlock;
        ss[bi][c] = bi < nbc && col0 + c < n
                        ? __half2float(scales[(size_t)(kbc + bi) * n + col0 + c])
                        : 0.f;
      }
    }
    __syncthreads();

    for (int bi = 0; bi < nbc; ++bi) {
      // A fragments of the two k16 steps: rows g and g + 8, dims 2t, 2t+1,
      // 2t+8, 2t+9 of the block's first (step 0) and second (step 1) 16 dims
      uint32_t a[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int c = bi * 32 + s * 16 + 2 * t;
        a[s][0] = *reinterpret_cast<const uint32_t*>(&xs[g][c]);
        a[s][2] = *reinterpret_cast<const uint32_t*>(&xs[g][c + 8]);
        if constexpr (M > 8) {
          a[s][1] = *reinterpret_cast<const uint32_t*>(&xs[g + 8][c]);
          a[s][3] = *reinterpret_cast<const uint32_t*>(&xs[g + 8][c + 8]);
        } else {
          a[s][1] = a[s][3] = 0u;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = warp * 32 + j * 8;  // this n8 tile's first column
        // packed row r holds dim r (low nibble, step 0) and dim r + 16
        // (high nibble, step 1) of the block; B rows 2t, 2t+1, 2t+8, 2t+9
        const uint32_t p0 = pk[bi][2 * t][cl + g], p1 = pk[bi][2 * t + 1][cl + g];
        const uint32_t p2 = pk[bi][2 * t + 8][cl + g], p3 = pk[bi][2 * t + 9][cl + g];
        float y[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(y, a[0], codes_bf16x2(p0 & 15u, p1 & 15u), codes_bf16x2(p2 & 15u, p3 & 15u));
        mma_bf16(y, a[1], codes_bf16x2(p0 >> 4, p1 >> 4), codes_bf16x2(p2 >> 4, p3 >> 4));
        const float s0 = ss[bi][cl + 2 * t], s1 = ss[bi][cl + 2 * t + 1];
        acc[j][0] = fmaf(s0, y[0], acc[j][0]);  // row g
        acc[j][1] = fmaf(s1, y[1], acc[j][1]);
        acc[j][2] = fmaf(s0, y[2], acc[j][2]);  // row g + 8
        acc[j][3] = fmaf(s1, y[3], acc[j][3]);
      }
    }
  }

  const bool direct = gridDim.y == 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + (i >= 2 ? 8 : 0);
      const int col = col0 + warp * 32 + j * 8 + 2 * t + (i & 1);
      if (r >= m || col >= n) continue;
      if (direct)
        store(out + (size_t)r * n + col, acc[j][i]);
      else
        partial[((size_t)blockIdx.y * m + r) * n + col] = acc[j][i];
    }
  }
}

template <typename TO>
void launch(const void* x, const void* packed, const void* scales, void* partial,
            void* out, int m, int k, int n, int splits, int kb_per_split,
            cudaStream_t st) {
  dim3 grid((n + kColsPerBlock - 1) / kColsPerBlock, splits);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* pp = static_cast<const uint8_t*>(packed);
  const auto* sp = static_cast<const __half*>(scales);
  auto* part = static_cast<float*>(partial);
  auto* o = static_cast<TO*>(out);
  if (m <= 8)
    q40_maskdot_kernel<8, TO><<<grid, kThreads, 0, st>>>(xp, pp, sp, part, o, m, k, n, kb_per_split);
  else
    q40_maskdot_kernel<16, TO><<<grid, kThreads, 0, st>>>(xp, pp, sp, part, o, m, k, n, kb_per_split);
  if (splits > 1) {
    const size_t mn = (size_t)m * n;
    launch_splitk_reduce<TO>(part, o, mn, splits, st);
  }
}

}  // namespace

// x bf16 [m, k] (m <= 16, 16-byte aligned, k % 32 == 0); packed u8 [k/2, n];
// scales f16 [k/32, n]; out [m, n] in bf16 (out_f32 == 0) or f32; partial
// f32 [splits, m, n] (unused when splits == 1), each split walking
// kb_per_split 32-row blocks. Returns the CUDA error state after the
// launches (0 = success).
extern "C" int q40_maskdot(const void* x, const void* packed, const void* scales,
                           void* partial, void* out, int m, int k, int n, int splits,
                           int kb_per_split, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    launch<float>(x, packed, scales, partial, out, m, k, n, splits, kb_per_split, st);
  else
    launch<__nv_bfloat16>(x, packed, scales, partial, out, m, k, n, splits, kb_per_split, st);
  return (int)cudaGetLastError();
}
