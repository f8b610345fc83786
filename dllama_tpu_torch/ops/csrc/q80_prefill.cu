// Q80 prefill GEMM for Hopper: out[m, n] = x[m, k] @ W[k, n], m > 16.
//
// Replaces dllama_tpu/ops/pallas/q80_matmul.py:_deq_kernel (called by
// _deq_call), the TPU's prefill-shaped Q80 kernel.
//
// What bounds it on this card: tensor-core operations at m >= 256 (2*m*k*n
// operations against k*n*1.0625 weight bytes, above the ~300 operations per
// byte where the card's bf16 rate, not its memory, is the limit), and
// device-memory bytes at a 32-row chunk.
//
// What the design does about it (K2's design, q40_prefill.cu, with int8
// codes in place of nibbles): output tiles of 64 x 128 per block of 8 warps,
// each warp 32 x 32 of f32 accumulators in nvcuda::wmma fragments (bf16
// inputs, f32 accumulation on the tensor cores). Per step of 64 input dims
// (two Q80 blocks) the block stages its x tile and dequantizes the weight
// tile into shared memory: the exact int8 code (-128 included) times the f32
// scale, rounded once to bf16 - the same rounding as the plain version
// (dequantize, cast to the activation dtype, then an f32 dot), so only the
// order of the sums differs. Each thread loads 8 neighbouring columns of 4
// code rows (64-bit loads: 16 threads cover a 128-byte row) and their 8
// scales of each block (128-bit loads). The next step's global loads are
// issued into registers before the current step's products, so their
// latency hides behind the tensor-core work. The products are summed in
// runs of 8 steps (512 input dims), each run from zero into its own
// fragments and then added to the block's total in k order. Where the
// output tiles alone would leave most SMs idle (a narrow n or a short
// chunk), every run is its own split and a second pass adds the runs' f32
// partials in the same order, so a column's sum is the same, bit for bit,
// split or not and whatever n is: wq/wk/wv and w1/w3 give the columns of
// their fused wqkv/w13 (--fuse-weights). A k that is an odd number of 32-row
// blocks gets a zero second block in its last step; a ragged n is masked.
// Not yet here: a TMA/cp.async ring and wgmma.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 128, BK = 64;  // BK: two 32-row Q80 blocks
constexpr int kRunSteps = 8;               // steps summed from zero per run
constexpr int kThreads = 256;              // 8 warps: 2 along m x 4 along n
constexpr int LDA = BK + 8;                // bf16 per shared row of the x tile
constexpr int LDB = BN + 8;                // bf16 per shared row of the weight tile
constexpr int LDC = BN + 4;                // f32 per shared row of the output tile
constexpr int kSmemAB = (BM * LDA + BK * LDB) * 2;
constexpr int kSmemC = BM * LDC * 4;
constexpr int kSmem = kSmemAB > kSmemC ? kSmemAB : kSmemC;

// One step's global data held in registers: two 8-element rows of the x
// tile; code rows br, br + 16, br + 32 and br + 48 of the 64-row step at 8
// columns; the 8 f16 scales of each of the two Q80 blocks.
struct Stage {
  uint4 a[2];
  uint2 c[4];
  uint4 s[2];
};

__device__ __forceinline__ void load_stage(Stage& st, const __nv_bfloat16* x,
                                           const int8_t* codes, const __half* scales,
                                           int m, int k, int n, int row0, int col0,
                                           int step, int tid, bool aligned) {
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
  const bool vec = aligned && (n & 7) == 0 && gc + 8 <= n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // code row br + 16 i of this step
    const int kr = step * BK + br + 16 * i;
    const int8_t* crow = codes + (size_t)kr * n;
    if (kr < k && vec) {
      st.c[i] = __ldg(reinterpret_cast<const uint2*>(crow + gc));
    } else {  // ragged right edge, unaligned rows, or past k
      alignas(8) int8_t b[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) b[e] = (kr < k && gc + e < n) ? crow[gc + e] : (int8_t)0;
      st.c[i] = *reinterpret_cast<const uint2*>(b);
    }
  }
#pragma unroll
  for (int qb = 0; qb < 2; ++qb) {  // the scales of block qb at the same 8 columns
    const int kb = step * 2 + qb;
    const __half* srow = scales + (size_t)kb * n;
    if (kb < nkb && vec) {
      st.s[qb] = __ldg(reinterpret_cast<const uint4*>(srow + gc));
    } else {
      alignas(16) __half sh[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sh[e] = (kb < nkb && gc + e < n) ? srow[gc + e] : __float2half(0.f);
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
  for (int i = 0; i < 4; ++i) {  // row br + 16 i lies in block i / 2
    const uint32_t cw[2] = {st.c[i].x, st.c[i].y};
    const uint4 sv = st.s[i / 2];
    const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
    alignas(16) __nv_bfloat16 row[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float code = (float)((int32_t)(cw[e / 4] << (24 - 8 * (e % 4))) >> 24);
      const __half2 h = *reinterpret_cast<const __half2*>(&sw[e / 2]);
      const float s = (e % 2) ? __high2float(h) : __low2float(h);
      row[e] = __float2bfloat16(code * s);
    }
    *reinterpret_cast<uint4*>(Bs + (br + 16 * i) * LDB + bc) =
        *reinterpret_cast<const uint4*>(row);
  }
}

template <typename TO>
__global__ void __launch_bounds__(kThreads) q80_prefill_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
    const __half* __restrict__ scales, float* __restrict__ partial, TO* __restrict__ out,
    int m, int k, int n, int steps_per_split, int aligned) {
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

  // acc: this run's products; total: the runs so far, added in k order
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2], total[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.f);
      wmma::fill_fragment(total[i][j], 0.f);
    }

  Stage st;
  if (step0 < step1)
    load_stage(st, x, codes, scales, m, k, n, row0, col0, step0, tid, aligned);
  for (int step = step0; step < step1; ++step) {
    store_stage(st, As, Bs, tid);
    __syncthreads();
    if (step + 1 < step1)  // in flight while the tensor cores work
      load_stage(st, x, codes, scales, m, k, n, row0, col0, step + 1, tid, aligned);
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
    if ((step + 1) % kRunSteps == 0 || step + 1 == step1) {  // the run ends here
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < total[i][j].num_elements; ++e) total[i][j].x[e] += acc[i][j].x[e];
          wmma::fill_fragment(acc[i][j], 0.f);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              total[i][j], LDC, wmma::mem_row_major);
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
void launch(const void* x, const void* codes, const void* scales, void* partial,
            void* out, int m, int k, int n, int splits, int steps_per_split,
            cudaStream_t st) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  auto* part = static_cast<float*>(partial);
  auto* o = static_cast<TO*>(out);
  const int aligned = (reinterpret_cast<uintptr_t>(codes) % 8 == 0) &&
                      (reinterpret_cast<uintptr_t>(scales) % 16 == 0);
  q80_prefill_kernel<TO><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const __half*>(scales), part, o, m, k, n, steps_per_split, aligned);
  if (splits > 1) {
    const size_t mn = (size_t)m * n;
    launch_splitk_reduce<TO>(part, o, mn, splits, st);
  }
}

}  // namespace

// x bf16 [m, k] (16-byte aligned rows, k % 32 == 0); codes i8 [k, n];
// scales f16 [k/32, n]; out [m, n] in bf16 (out_f32 == 0) or f32; partial
// f32 [splits, m, n] for the split-k sums (unused when splits == 1), each
// split walking steps_per_split steps of 64 input dims (a multiple of 8, or
// every step with one split). Returns the CUDA error state after the
// launches (0 = success).
extern "C" int q80_prefill(const void* x, const void* codes, const void* scales,
                           void* partial, void* out, int m, int k, int n, int splits,
                           int steps_per_split, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    launch<float>(x, codes, scales, partial, out, m, k, n, splits, steps_per_split, st);
  else
    launch<__nv_bfloat16>(x, codes, scales, partial, out, m, k, n, splits,
                          steps_per_split, st);
  return (int)cudaGetLastError();
}
