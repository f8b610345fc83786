// Q40 prefill GEMM for Hopper: out[m, n] = x[m, k] @ W[k, n], m > 16.
//
// Replaces dllama_tpu/ops/pallas/q40_matmul.py:_deq_kernel (called by
// _deq_call, and by q40_matmul_2d), the TPU's prefill-shaped Q40 kernel.
//
// What bounds it on this card: tensor-core operations. At m >= 256 a
// product does 2*m*k*n operations against k*n*0.5625 weight bytes, more than
// the ~300 operations per byte at which the card's bf16 rate, not its
// memory, is the limit.
//
// What the design does about it: output tiles of 64 x 128 per block of 8
// warps, each warp 32 x 32 of f32 accumulators in nvcuda::wmma fragments
// (bf16 inputs, f32 accumulation on the tensor cores). Per step of 64 input
// dims (two Q40 blocks) the block stages its x tile and dequantizes the
// weight tile into shared memory: code q - 8 times the f32 scale, rounded
// once to bf16 — the same rounding as the plain version (dequantize, cast to
// the activation dtype, then an f32 dot), so only the order of the sums
// differs. The next step's global loads are issued into registers before the
// current step's products, so their latency hides behind the tensor-core
// work. Where the output tiles alone would leave SMs idle (a narrow n or a
// 32-row chunk), k is split across blocks and a second pass sums the f32
// partials in a fixed order. The epilogue rounds once, through shared
// memory. Not yet here: a TMA/cp.async ring and wgmma, which is where the
// remaining gap to the tensor-core bound lies.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 128, BK = 64;  // BK: two 32-row Q40 blocks
constexpr int kThreads = 256;              // 8 warps: 2 along m x 4 along n
constexpr int LDA = BK + 8;                // bf16 per shared row of the x tile
constexpr int LDB = BN + 8;                // bf16 per shared row of the weight tile
constexpr int LDC = BN + 4;                // f32 per shared row of the output tile
constexpr int kSmemAB = (BM * LDA + BK * LDB) * 2;
constexpr int kSmemC = BM * LDC * 4;
constexpr int kSmem = kSmemAB > kSmemC ? kSmemAB : kSmemC;

// One step's global data held in registers: two 8-element rows of the x
// tile, and for each of the two Q40 blocks one packed row of 8 columns with
// their 8 f16 scales.
struct Stage {
  uint4 a[2];
  uint2 p[2];
  uint4 s[2];
};

__device__ __forceinline__ void load_stage(Stage& st, const __nv_bfloat16* x,
                                           const uint8_t* packed, const __half* scales,
                                           int m, int k, int n, int row0, int col0,
                                           int step, int tid) {
  const int nkb = k / 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // x tile: rows ar and ar + 32, 8 dims from ac
    const int ar = tid / 8 + h * 32, ac = (tid % 8) * 8;
    const int gr = row0 + ar, gk = step * BK + ac;
    st.a[h] = (gr < m && gk < k)
                  ? *reinterpret_cast<const uint4*>(x + (size_t)gr * k + gk)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
  const int br = tid / 16, gc = col0 + (tid % 16) * 8;
#pragma unroll
  for (int qb = 0; qb < 2; ++qb) {  // weight tile: packed row br of block qb
    const int kb = step * 2 + qb;
    const uint8_t* prow = packed + ((size_t)kb * 16 + br) * n;
    const __half* srow = scales + (size_t)kb * n;
    if (kb < nkb && (n & 7) == 0 && gc + 8 <= n) {
      st.p[qb] = __ldg(reinterpret_cast<const uint2*>(prow + gc));
      st.s[qb] = __ldg(reinterpret_cast<const uint4*>(srow + gc));
    } else {  // ragged right edge, n not a multiple of 8, or past k
      alignas(8) uint8_t b[8];
      alignas(16) __half sh[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool in = kb < nkb && gc + i < n;
        b[i] = in ? prow[gc + i] : (uint8_t)0x88;  // code 0 outside
        sh[i] = in ? srow[gc + i] : __float2half(0.f);
      }
      st.p[qb] = *reinterpret_cast<const uint2*>(b);
      st.s[qb] = *reinterpret_cast<const uint4*>(sh);
    }
  }
}

__device__ __forceinline__ void store_stage(const Stage& st, __nv_bfloat16* As,
                                            __nv_bfloat16* Bs, int tid) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    *reinterpret_cast<uint4*>(As + (tid / 8 + h * 32) * LDA + (tid % 8) * 8) = st.a[h];
  const int br = tid / 16, bc = (tid % 16) * 8;
#pragma unroll
  for (int qb = 0; qb < 2; ++qb) {
    const uint32_t pw[2] = {st.p[qb].x, st.p[qb].y};
    const uint32_t sw[4] = {st.s[qb].x, st.s[qb].y, st.s[qb].z, st.s[qb].w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t byte = (pw[i / 4] >> (8 * (i % 4))) & 0xFFu;
      const __half2 h = *reinterpret_cast<const __half2*>(&sw[i / 2]);
      const float s = (i % 2) ? __high2float(h) : __low2float(h);
      // rows 32*qb + br and 32*qb + br + 16: the low and high nibble
      Bs[(qb * 32 + br) * LDB + bc + i] = __float2bfloat16(q40_code(byte & 15u) * s);
      Bs[(qb * 32 + br + 16) * LDB + bc + i] = __float2bfloat16(q40_code(byte >> 4) * s);
    }
  }
}

template <typename TO>
__global__ void __launch_bounds__(kThreads) q40_prefill_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
    const __half* __restrict__ scales, float* __restrict__ partial, TO* __restrict__ out,
    int m, int k, int n, int steps_per_split) {
  __shared__ __align__(128) unsigned char smem[kSmem];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int n_steps = (k + BK - 1) / BK;
  const int step0 = blockIdx.z * steps_per_split;
  const int step1 = min(n_steps, step0 + steps_per_split);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  Stage st;
  if (step0 < step1) load_stage(st, x, packed, scales, m, k, n, row0, col0, step0, tid);
  for (int step = step0; step < step1; ++step) {
    store_stage(st, As, Bs, tid);
    __syncthreads();
    if (step + 1 < step1)  // in flight while the tensor cores work
      load_stage(st, x, packed, scales, m, k, n, row0, col0, step + 1, tid);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  const bool direct = gridDim.z == 1;
  for (int i = tid; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= m || gc >= n) continue;
    if (direct)
      store(out + (size_t)gr * n + gc, Cs[r * LDC + c]);
    else
      partial[((size_t)blockIdx.z * m + gr) * n + gc] = Cs[r * LDC + c];
  }
}

template <typename TO>
void launch(const void* x, const void* packed, const void* scales, void* partial,
            void* out, int m, int k, int n, int splits, int steps_per_split,
            cudaStream_t st) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  auto* part = static_cast<float*>(partial);
  auto* o = static_cast<TO*>(out);
  q40_prefill_kernel<TO><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const __half*>(scales), part, o, m, k, n, steps_per_split);
  if (splits > 1) {
    const size_t mn = (size_t)m * n;
    launch_splitk_reduce<TO>(part, o, mn, splits, st);
  }
}

}  // namespace

// x bf16 [m, k] (16-byte aligned rows, k % 32 == 0); packed u8 [k/2, n];
// scales f16 [k/32, n]; out [m, n] in bf16 (out_f32 == 0) or f32; partial
// f32 [splits, m, n] for the split-k sums (unused when splits == 1), each
// split walking steps_per_split steps of 64 input dims. Returns the CUDA
// error state after the launches (0 = success).
extern "C" int q40_prefill(const void* x, const void* packed, const void* scales,
                           void* partial, void* out, int m, int k, int n, int splits,
                           int steps_per_split, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    launch<float>(x, packed, scales, partial, out, m, k, n, splits, steps_per_split, st);
  else
    launch<__nv_bfloat16>(x, packed, scales, partial, out, m, k, n, splits,
                          steps_per_split, st);
  return (int)cudaGetLastError();
}
