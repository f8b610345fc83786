// The kernel benchmark's bf16-weight reference product (variant D of
// dllama_tpu_torch/experiments/kbench.py): out[m, n] = x[m, k] @ W[k, n]
// with bf16 x and a bf16 (already dequantized) W, f32 accumulation and an
// f32 result, for any m.
//
// Replaces experiments/kbench.py:_kernel_d (called through make_call), the
// TPU benchmark's roofline reference for unquantized weights: a plain dot.
//
// What bounds it on this card: device-memory bytes at decode row counts (2
// bytes a weight, 3.6x a Q40 weight's), tensor-core operations at m >= ~300.
// What the design does: a hand-written tensor-core GEMM (it calls no
// library). A block of 8 warps owns a 64 x 128 output tile, each warp 32 x
// 32 of f32 accumulators in nvcuda::wmma fragments (bf16 x bf16 -> f32).
// The x and W tiles of one 32-row step of k go through a two-stage ring in
// shared memory filled by cp.async (16 bytes a thread and copy, the rows
// past m or n zero-filled by the copy itself), so step s+1's loads are in
// flight while the tensor cores work on step s. The epilogue goes through
// shared memory to mask the ragged edges. No split-k: at m = 8 the 112
// column tiles of an n = 14336 weight fill 112 of the 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 128, BK = 32;
constexpr int kThreads = 256;  // 8 warps: 2 along m x 4 along n
constexpr int kStages = 2;
constexpr int LDA = BK + 8;    // bf16 per shared row of an x tile
constexpr int LDB = BN + 8;    // bf16 per shared row of a W tile
constexpr int LDC = BN + 4;    // f32 per shared row of the output tile
constexpr int kTileA = BM * LDA, kTileB = BK * LDB;
constexpr int kSmemAB = kStages * (kTileA + kTileB) * 2;
constexpr int kSmemC = BM * LDC * 4;
constexpr int kSmem = kSmemAB > kSmemC ? kSmemAB : kSmemC;

// 16 bytes from global to shared; only `bytes` of them are read (0 or 16),
// the rest is zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of step `step` into ring slot (As, Bs).
__device__ __forceinline__ void load_step(__nv_bfloat16* As, __nv_bfloat16* Bs,
                                          const __nv_bfloat16* x, const __nv_bfloat16* w,
                                          int m, int k, int n, int row0, int col0, int step,
                                          int tid) {
  {  // x tile: 64 rows x 32 dims = 256 chunks of 8
    const int r = tid / 4, c = (tid % 4) * 8;
    const int gr = row0 + r, gk = step * BK + c;
    const bool in = gr < m && gk < k;
    cp_async16(As + r * LDA + c, in ? x + (size_t)gr * k + gk : x, in ? 16 : 0);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {  // W tile: 32 rows x 128 columns = 512 chunks of 8
    const int i = tid + q * kThreads;
    const int r = i / 16, c = (i % 16) * 8;
    const int gk = step * BK + r, gc = col0 + c;
    const bool in = gk < k && gc < n;
    cp_async16(Bs + r * LDB + c, in ? w + (size_t)gk * n + gc : w, in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads) kbench_bf16_gemm_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    float* __restrict__ out, int m, int k, int n) {
  __shared__ __align__(128) unsigned char smem[kSmem];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + kStages * kTileA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int n_steps = (k + BK - 1) / BK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load_step(As, Bs, x, w, m, k, n, row0, col0, 0, tid);
  cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    const int slot = step % kStages;
    if (step + 1 < n_steps)  // the next step's copies go out before this one's products
      load_step(As + (1 - slot) * kTileA, Bs + (1 - slot) * kTileB, x, w, m, k, n, row0, col0,
                step + 1, tid);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the newest group has landed: this step's tiles
    __syncthreads();
    const __nv_bfloat16* a_s = As + slot * kTileA;
    const __nv_bfloat16* b_s = Bs + slot * kTileB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], a_s + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], b_s + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // this slot is refilled by the next iteration's copies
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr < m && gc < n) out[(size_t)gr * n + gc] = Cs[r * LDC + c];
  }
}

}  // namespace

// x bf16 [m, k], w bf16 [k, n], both 16-byte aligned with k % 8 == 0 and
// n % 8 == 0; out f32 [m, n]. Returns the CUDA error state after the launch
// (0 = success).
extern "C" int kbench_bf16_gemm(const void* x, const void* w, void* out, int m, int k, int n,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kbench_bf16_gemm_kernel<<<grid, kThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                                     static_cast<const __nv_bfloat16*>(w),
                                                     static_cast<float*>(out), m, k, n);
  return (int)cudaGetLastError();
}
