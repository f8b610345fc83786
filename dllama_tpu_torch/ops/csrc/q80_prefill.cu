// Q80 prefill GEMM for Hopper: out[m, n] = x[m, k] @ W[k, n], m > 16.
//
// Replaces dllama_tpu/ops/pallas/q80_matmul.py:_deq_kernel (called by
// _deq_call), the TPU's prefill-shaped Q80 kernel. As there, each weight is
// its exact int8 code (-128 included) times the f32 scale, rounded once to
// bf16, and the dot accumulates in f32 — the plain version's rounding
// (dequantize, cast to the activation dtype, f32 dot), so only the order of
// the sums differs.
//
// What bounds it on this card: tensor-core operations at m >= 256 (2*m*k*n
// operations against k*n*1.0625 weight bytes, above the ~300 operations per
// byte where the card's bf16 rate, not its memory, is the limit), and
// device-memory bytes at a 32-row chunk. The full bf16 rate is reached only
// through wgmma.
//
// What the design does about it (K2's main loop, q40_prefill.cu, on the
// helpers of hopper.cuh):
//  * A block of two warpgroups owns a BM x 64 output tile; each warpgroup
//    runs wgmma.mma_async m64n64k16 (bf16 in, f32 accumulators in
//    registers) over BM / 2 rows. BM is 256 where a chunk of 256 rows or
//    more still gives a tile to every SM (each weight tile dequantized once
//    per 256 rows), else 128.
//  * A ring of kStages stages, filled by TMA (one thread issues the copies,
//    an mbarrier per stage counts their bytes): per step of 64 input dims,
//    the x tile [BM x 64] bf16 in the 128-byte-swizzled K-major layout that
//    the wgmma descriptor of A reads, and the raw Q80 tile, int8 codes
//    [64 x 64] and f16 scales [2 x 64]: 1.0625 bytes a weight. TMA
//    zero-fills past m, k and n (so a k that is an odd number of 32-row
//    blocks reads a zero second block in its last step). Where it cannot
//    describe the weight (rows of n bytes with n % 16 != 0) the threads
//    load the raw tile themselves. A chunk of fewer rows than the block
//    (m = 32) copies only its rows: at m = 32, copying the zero-filled rows
//    took more time than the dequantization.
//  * The warpgroups dequantize each raw stage into a bf16 B tile [64 x 64]
//    in the 128-byte-swizzled MN-major layout that wgmma reads with its B
//    transpose bit; step j + 1 is dequantized while the wgmma of step j
//    runs. A weight is the plain version's, bit for bit: the code becomes
//    an exact f32 (XOR 0x80 and a byte permute give the float 2^23 + q +
//    128, and subtracting 2^23 + 128 is exact), one f32 multiply by the
//    scale is exact (8 x 11 significant bits), and one cvt.rn.bf16x2 rounds
//    two products once. (K2's split-scale bf16 FMA is exact only for 4-bit
//    codes: (q - 8) s_lo needs up to 10 significant bits for an int8 q, and
//    bf16 holds 8.)
//  * The products are summed in runs of kRunSteps steps (512 input dims):
//    each run starts from zero in its own accumulators (the run's first
//    wgmma has scale-d 0) and is then added to the block's total in k order.
//    Two accumulator sets are why the tile is 64 columns wide: at 128
//    columns, 128 rows a warpgroup would need 2 x 128 f32 registers a
//    thread, past the 255 there are; at 64 they take 2 x 64.
//  * Where the output tiles alone would leave most SMs idle (a narrow n or
//    a short chunk), every run is its own split and a second pass adds the
//    runs' f32 partials in the same order (launch_splitk_reduce), so a
//    column's sum is the same, bit for bit, split or not and whatever n is:
//    wq/wk/wv and w1/w3 give the columns of their fused wqkv/w13
//    (--fuse-weights).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 256;  // rows of x per block where the tiles still fill the card
constexpr int BM_SMALL = 128;  // ... and elsewhere
constexpr int BN = 64;   // output columns per block (the wgmma width)
constexpr int BK = 64;   // input dims per step: two 32-row Q80 blocks
constexpr int kRunSteps = 8;  // steps summed from zero per run
constexpr int kStages = 4;  // steps in the copy ring
constexpr int kThreads = 256;
constexpr int kMinBlocksPerSm = 1;

// Shared memory of a BM-row block: x stages and B tiles, each 1024-byte
// aligned (the 128-byte swizzle repeats every 8 rows of 128 bytes, and the
// wgmma descriptors assume base offset 0), then the raw stages and the
// stages' mbarriers.
constexpr int kBBytes = BK * BN * 2;       // one bf16 B tile, 8 KB
constexpr int kCBytes = BK * BN;           // one stage of int8 codes, 4 KB
constexpr int kSBytes = BK / 32 * BN * 2;  // one stage of f16 scales, 256 B
template <int M>
struct Layout {
  static constexpr int kXBytes = M * BK * 2;  // one x stage
  static constexpr int kOffB = kStages * kXBytes;
  static constexpr int kOffC = kOffB + 2 * kBBytes;
  static constexpr int kOffS = kOffC + kStages * kCBytes;
  static constexpr int kOffBar = kOffS + kStages * kSBytes;
  static constexpr int kSmem = kOffBar + kStages * 8 + 1024;  // + room to align the base
};

// The raw Q80 tile of step `step` loaded by the threads themselves (n % 16
// != 0: code rows are not 16-byte aligned): zero past k and n.
__device__ __forceinline__ void load_w_plain(int8_t* cs, __half* ss, int step,
                                             const int8_t* codes, const __half* scales,
                                             int k, int n, int col0, int tid) {
  const int nkb = k / 32;
  for (int i = tid; i < BK * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    const int kr = step * BK + r;
    cs[i] = kr < k && col0 + c < n ? codes[(size_t)kr * n + col0 + c] : (int8_t)0;
  }
  for (int i = tid; i < BK / 32 * BN; i += kThreads) {
    const int kb = step * 2 + i / BN, c = i % BN;
    ss[i] = kb < nkb && col0 + c < n ? scales[(size_t)kb * n + col0 + c] : __float2half(0.f);
  }
}

// Eight int8 codes (two words) times their eight f32 scales, each product
// rounded once to bf16: four bf16x2 words, columns 0-1 .. 6-7.
__device__ __forceinline__ uint4 dequant8(uint2 raw, const float (&s)[8]) {
  // byte b of a word, XOR 0x80, under the exponent byte 0x4B: 2^23 + q + 128
  const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
  uint32_t o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * e + h;
      const float code =
          __uint_as_float(__byte_perm(w[c / 4], 0x4B000000u, 0x7440 | (c % 4))) - 8388736.0f;
      v[h] = code * s[c];
    }
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[0], v[1]);
    o[e] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Dequantize raw stage (cs, ss) into B tile `bt`. Thread -> 8 columns from
// 8 cg of rows r and r + 16 of one 32-row Q80 block, so that it widens its
// 8 scales once.
__device__ __forceinline__ void dequant_step(const int8_t* cs, const __half* ss,
                                             unsigned char* bt, int tid) {
  const int cg = tid % 8, j = tid / 8;  // j < 32
  const int r = (j / 16) * 32 + j % 16;  // rows r and r + 16 of block j / 16
  const uint4 sv = *reinterpret_cast<const uint4*>(ss + (j / 16) * BN + cg * 8);
  const __half2* sh = reinterpret_cast<const __half2*>(&sv);
  float s[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __half22float2(sh[e]);
    s[2 * e] = f.x;
    s[2 * e + 1] = f.y;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = r + 16 * h;
    const uint2 raw = *reinterpret_cast<const uint2*>(cs + kr * BN + cg * 8);
    *reinterpret_cast<uint4*>(bt + swz(kr, cg)) = dequant8(raw, s);
  }
}

template <typename TO, int M>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm) q80_prefill_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_c,
    const __grid_constant__ CUtensorMap map_s, const int8_t* __restrict__ codes,
    const __half* __restrict__ scales, float* __restrict__ partial, TO* __restrict__ out,
    int m, int k, int n, int steps_per_split, int tma_w, int x_bytes) {
  using L = Layout<M>;
  constexpr int kMTiles = M / 128;  // m64 tiles of each warpgroup
  constexpr int NA = BN / 2;        // f32 accumulators a thread per m64 tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sm_addr = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  const uint32_t bar0 = sm_addr + L::kOffBar;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int row0 = blockIdx.x * M, col0 = blockIdx.y * BN;
  const int n_steps = (k + BK - 1) / BK;
  const int step0 = blockIdx.z * steps_per_split;
  const int nst = max(0, min(n_steps, step0 + steps_per_split) - step0);
  const uint32_t stage_bytes = x_bytes + (tma_w ? kCBytes + kSBytes : 0);

  // stage s of step `step`: TMA copies issued by thread 0 (and the raw tile
  // by every thread where TMA cannot describe it)
  auto fill = [&](int step) {
    const int s = step % kStages;
    const int gs = step0 + step;
    if (tid == 0) {
      mbar_expect(bar0 + 8 * s, stage_bytes);
      tma_load(sm_addr + s * L::kXBytes, &map_x, bar0 + 8 * s, gs * BK, row0);
      if (tma_w) {
        tma_load(sm_addr + L::kOffC + s * kCBytes, &map_c, bar0 + 8 * s, col0, gs * BK);
        tma_load(sm_addr + L::kOffS + s * kSBytes, &map_s, bar0 + 8 * s, col0, gs * BK / 32);
      }
    }
    if (!tma_w)
      load_w_plain(reinterpret_cast<int8_t*>(sm + L::kOffC + s * kCBytes),
                   reinterpret_cast<__half*>(sm + L::kOffS + s * kSBytes), gs, codes, scales,
                   k, n, col0, tid);
  };
  auto dequant = [&](int step) {
    const int s = step % kStages;
    dequant_step(reinterpret_cast<const int8_t*>(sm + L::kOffC + s * kCBytes),
                 reinterpret_cast<const __half*>(sm + L::kOffS + s * kSBytes),
                 sm + L::kOffB + (step & 1) * kBBytes, tid);
  };

  // acc: this run's products; total: the runs so far, added in k order
  float acc[kMTiles][NA], total[kMTiles][NA];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[mt][i] = total[mt][i] = 0.f;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int j = 0; j < kStages - 1 && j < nst; ++j) fill(j);
  if (nst > 0) {
    mbar_wait(bar0, 0);
    __syncthreads();  // (the raw tile some threads loaded themselves)
    dequant(0);
  }
  fence_proxy_async();
  __syncthreads();

  // step j: its products run while step j + 1 is dequantized; its stage is
  // refilled with step j + kStages - 1 one step later, once they are done
  for (int j = 0; j < nst; ++j) {
    const int gs = step0 + j;
    const uint32_t a_base = sm_addr + (j % kStages) * L::kXBytes + wg * (M / 2) * 128;
    const uint32_t b_base = sm_addr + L::kOffB + (j & 1) * kBBytes;
    const int run_start = gs % kRunSteps == 0;
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) fence_acc(acc[mt]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
        // A: +32 bytes per k16 within the swizzled 128-byte rows, 1024-byte
        // groups of 8 rows, 64 rows per m64 tile. B: +16 rows per k16, one
        // 64-column atom, groups of 8 k rows 1024 bytes apart. A run's
        // first k16 overwrites the accumulators instead of adding to them.
        wgmma_m64n64k16(acc[mt], desc_sw128(a_base + mt * 64 * 128 + kk * 32, 16, 1024),
                        desc_sw128(b_base + kk * 16 * 128, BK * 128, 1024),
                        kk > 0 || !run_start);
    wgmma_commit();
    if (j + kStages - 1 < nst) fill(j + kStages - 1);  // the stage of step j - 1
    if (j + 1 < nst) {
      mbar_wait(bar0 + 8 * ((j + 1) % kStages), ((j + 1) / kStages) & 1);
      __syncthreads();
      dequant(j + 1);
      fence_proxy_async();
    }
    wgmma_wait();
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) fence_acc(acc[mt]);
    if ((gs + 1) % kRunSteps == 0 || j + 1 == nst) {  // the run ends here
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int i = 0; i < NA; ++i) total[mt][i] += acc[mt][i];
    }
    __syncthreads();
  }

  // accumulator fragment of m64 tile mt: warp w of the warpgroup holds rows
  // 16 w + lane / 4 (+ 8); n8 tile t holds columns 8 t + 2 (lane % 4) (+ 1)
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const bool direct = gridDim.z == 1;
  const bool pairs = (n & 1) == 0;
#pragma unroll
  for (int mh = 0; mh < 2 * kMTiles; ++mh) {
    const int mt = mh / 2, h = mh % 2;
    const int gr = row0 + wg * (M / 2) + mt * 64 + warp * 16 + lane / 4 + 8 * h;
    if (gr >= m) continue;
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
      const int gc = col0 + 8 * t + 2 * (lane % 4);
      const float v0 = total[mt][4 * t + 2 * h], v1 = total[mt][4 * t + 2 * h + 1];
      if (direct) {
        TO* dst = out + (size_t)gr * n + gc;
        if (pairs && gc + 1 < n) {
          if constexpr (sizeof(TO) == 4)
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          else
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (gc < n) store(dst, v0);
          if (gc + 1 < n) store(dst + 1, v1);
        }
      } else {
        float* dst = partial + ((size_t)blockIdx.z * m + gr) * n + gc;
        if (pairs && gc + 1 < n) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (gc < n) dst[0] = v0;
          if (gc + 1 < n) dst[1] = v1;
        }
      }
    }
  }
}

template <typename TO, int M>
int launch(const void* x, const void* codes, const void* scales, void* partial, void* out,
           int m, int k, int n, int splits, int steps_per_split, cudaStream_t st) {
  // the raw tile goes by TMA where its rows are 16-byte aligned
  const int tma_w = n % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  // a chunk shorter than the block copies only its own rows (to a multiple
  // of 8, the swizzle's period); the rows past them feed only output rows
  // that are never stored
  const int box_m = m < M ? (m + 7) / 8 * 8 : M;
  CUtensorMap map_x, map_c, map_s;
  if (!make_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, k, box_m, BK,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  map_c = map_s = map_x;  // unused unless tma_w
  if (tma_w && !(make_map(&map_c, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, k, n, BK, BN,
                          CU_TENSOR_MAP_SWIZZLE_NONE) &&
                 make_map(&map_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2, scales, k / 32, n,
                          BK / 32, BN, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return -2;
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(q80_prefill_kernel<TO, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Layout<M>::kSmem);
    configured = true;
  }
  // row tiles fastest: the blocks that share a weight tile run together
  dim3 grid((m + M - 1) / M, (n + BN - 1) / BN, splits);
  auto* part = static_cast<float*>(partial);
  auto* o = static_cast<TO*>(out);
  q80_prefill_kernel<TO, M><<<grid, kThreads, Layout<M>::kSmem, st>>>(
      map_x, map_c, map_s, static_cast<const int8_t*>(codes),
      static_cast<const __half*>(scales), part, o, m, k, n, steps_per_split, tma_w,
      box_m * BK * 2);
  if (splits > 1) {
    const size_t mn = (size_t)m * n;
    launch_splitk_reduce<TO>(part, o, mn, splits, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [m, k] (16-byte aligned rows, k % 32 == 0); codes i8 [k, n];
// scales f16 [k/32, n]; out [m, n] in bf16 (out_f32 == 0) or f32; partial
// f32 [splits, m, n] for the split-k sums (unused when splits == 1), each
// split walking steps_per_split steps of 64 input dims (kRunSteps of them,
// or every step with one split); blocks of bm rows, BM or BM_SMALL.
// Returns the CUDA error state after the launches (0 = success; -1 = bad
// bm; -2 = a tensor map could not be made).
extern "C" int q80_prefill(const void* x, const void* codes, const void* scales,
                           void* partial, void* out, int m, int k, int n, int splits,
                           int steps_per_split, int out_f32, int bm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DLLAMA_Q80_ARGS x, codes, scales, partial, out, m, k, n, splits, steps_per_split, st
  if (bm == BM)
    return out_f32 ? launch<float, BM>(DLLAMA_Q80_ARGS)
                   : launch<__nv_bfloat16, BM>(DLLAMA_Q80_ARGS);
  if (bm == BM_SMALL)
    return out_f32 ? launch<float, BM_SMALL>(DLLAMA_Q80_ARGS)
                   : launch<__nv_bfloat16, BM_SMALL>(DLLAMA_Q80_ARGS);
#undef DLLAMA_Q80_ARGS
  return -1;
}
