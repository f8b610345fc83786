// Q40 prefill GEMM for Hopper: out[m, n] = x[m, k] @ W[k, n], m > 16 (and
// every m under STYLE = "deq").
//
// Replaces dllama_tpu/ops/pallas/q40_matmul.py:_deq_kernel (called by
// _deq_call, and by q40_matmul_2d), the TPU's prefill-shaped Q40 kernel. As
// there, each weight is its exact code q - 8 times the f32 scale, rounded
// once to bf16, and the dot accumulates in f32 — the plain version's
// rounding, so only the order of the sums differs.
//
// What bounds it on this card: tensor-core operations. At m >= 256 a
// product does 2*m*k*n operations against k*n*0.5625 weight bytes, more than
// the ~300 operations per byte at which the card's bf16 rate, not its
// memory, is the limit. The full bf16 rate is reached only through wgmma,
// and the dequantization and the copies compete with it for the SM's issue
// slots.
//
// What the design does about it:
//  * A block of two warpgroups owns a BM x 128 output tile (BM = 256 rows
//    for a chunk of 256 rows or more, else 128); each warpgroup runs
//    wgmma.mma_async m64n128k16 (bf16 in, f32 accumulators in registers)
//    over BM / 2 rows. A 256-row chunk dequantizes each weight tile once.
//  * A ring of kStages stages, filled by TMA (one thread issues the copies,
//    an mbarrier per stage counts their bytes): per step of 64 input dims,
//    the x tile [BM x 64] bf16 in the 128-byte-swizzled K-major layout that
//    the wgmma descriptor of A reads, and the raw Q40 tile, packed nibbles
//    [32 x 128] u8 and f16 scales [2 x 128]: 0.5625 bytes a weight. TMA
//    zero-fills past m, k and n. Where it cannot describe the weight (rows
//    of n bytes with n % 16 != 0) the threads load the raw tile themselves.
//  * The warpgroups dequantize each raw stage into a bf16 B tile [64 x 128]
//    in the 128-byte-swizzled MN-major layout (n contiguous, as the Q40
//    layout is) that wgmma reads with its B transpose bit. There are two B
//    tiles: step j + 1 is dequantized while the wgmma of step j runs. One
//    mask-or turns two nibbles into the bf16 values 128 + q, one bf16x2 add
//    into the codes q - 8, and with the f16 scale split into bf16 parts
//    s = s_hi + s_lo, (q - 8) s_lo is exact in bf16 and one bf16x2 FMA
//    (q - 8) s_hi + (q - 8) s_lo rounds (q - 8) s once: the plain version's
//    weight, two weights per instruction.
//  * Where the output tiles alone leave SMs idle (a narrow n, a 32-row
//    chunk), k is split across blocks and a second pass sums the f32
//    partials in a fixed order (launch_splitk_reduce): no float atomics.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 256;  // rows of x per block at m >= 256 (two warpgroups)
constexpr int BM_SMALL = 128;  // ... and below
constexpr int BN = 128;  // output columns per block (the wgmma width)
constexpr int BK = 64;   // input dims per step: two 32-row Q40 blocks
constexpr int kStages = 4;  // steps in the copy ring
constexpr int kThreads = 256;
constexpr int kMinBlocksPerSm = 1;

// Shared memory of a BM-row block: x stages and B tiles, each 1024-byte
// aligned (the 128-byte swizzle repeats every 8 rows of 128 bytes, and the
// wgmma descriptors assume base offset 0), then the raw stages and the
// stages' mbarriers.
constexpr int kBBytes = BK * BN * 2;       // one bf16 B tile, 16 KB
constexpr int kPBytes = BK / 2 * BN;       // one stage of packed nibbles, 4 KB
constexpr int kSBytes = BK / 32 * BN * 2;  // one stage of f16 scales, 512 B
template <int M>
struct Layout {
  static constexpr int kXBytes = M * BK * 2;  // one x stage
  static constexpr int kOffB = kStages * kXBytes;
  static constexpr int kOffP = kOffB + 2 * kBBytes;
  static constexpr int kOffS = kOffP + kStages * kPBytes;
  static constexpr int kOffBar = kOffS + kStages * kSBytes;
  static constexpr int kSmem = kOffBar + kStages * 8 + 1024;  // + room to align the base
};

// The raw Q40 tile of step `step` loaded by the threads themselves (n % 16
// != 0: packed rows are not 16-byte aligned): zero past k and n.
__device__ __forceinline__ void load_w_plain(unsigned char* ps, __half* ss, int step,
                                             const uint8_t* packed, const __half* scales,
                                             int k, int n, int col0, int tid) {
  const int nkb = k / 32;
  for (int i = tid; i < BK / 2 * BN; i += kThreads) {
    const int pr = i / BN, c = i % BN;
    const int kb = step * 2 + pr / 16;
    ps[i] = kb < nkb && col0 + c < n ? packed[((size_t)kb * 16 + pr % 16) * n + col0 + c] : 0;
  }
  for (int i = tid; i < BK / 32 * BN; i += kThreads) {
    const int kb = step * 2 + i / BN, c = i % BN;
    ss[i] = kb < nkb && col0 + c < n ? scales[(size_t)kb * n + col0 + c] : __float2half(0.f);
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// Dequantize raw stage (ps, ss) into B tile `bt`. Thread -> 8 columns from
// 8 cg and kRows consecutive packed rows of one Q40 block, so that it splits
// its 8 scales once. Packed row pr of a step holds k rows 32 (pr / 16) +
// pr % 16 (low nibbles) and that + 16 (high nibbles).
__device__ __forceinline__ void dequant_step(const unsigned char* ps, const __half* ss,
                                             unsigned char* bt, int tid) {
  constexpr int kGroups = BN / 8;
  constexpr int kRows = BK / 2 * kGroups / kThreads;  // packed rows a thread
  static_assert(16 % kRows == 0, "a thread's rows stay in one Q40 block");
  const int cg = tid % kGroups, pr0 = (tid / kGroups) * kRows;
  // the 8 scales as bf16 pairs s_hi + s_lo = s, exactly
  const uint4 sv = *reinterpret_cast<const uint4*>(ss + (pr0 / 16) * BN + cg * 8);
  const __half2* sh = reinterpret_cast<const __half2*>(&sv);
  __nv_bfloat162 s_hi[4], s_lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __half22float2(sh[e]);
    s_hi[e] = __floats2bfloat162_rn(f.x, f.y);
    const float2 h = __bfloat1622float2(s_hi[e]);
    s_lo[e] = __floats2bfloat162_rn(f.x - h.x, f.y - h.y);
  }
  const __nv_bfloat162 k136 = __floats2bfloat162_rn(136.f, 136.f);
  unsigned char* atom = bt + (cg / 8) * (BK * 128);  // 64-column atom of the MN-major tile
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int pr = pr0 + r;
    const uint2 p = *reinterpret_cast<const uint2*>(ps + pr * BN + cg * 8);
    uint32_t lo[4], hi[4];  // k rows klo and klo + 16, column pairs 0-1 .. 6-7
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      // bytes b0 b2 b1 b3, so that a 0x000F000F mask takes two neighbouring
      // columns' nibbles into the low bits of the two 16-bit halves, which
      // with 0x4300 are the bf16 values 128 + q
      const uint32_t wp = __byte_perm(w ? p.y : p.x, 0, 0x3120);
      const uint32_t c[4] = {(wp & 0x000F000Fu) | 0x43004300u,
                             ((wp >> 8) & 0x000F000Fu) | 0x43004300u,
                             ((wp >> 4) & 0x000F000Fu) | 0x43004300u,
                             ((wp >> 12) & 0x000F000Fu) | 0x43004300u};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 2 * w + i % 2;  // column pair
        const __nv_bfloat162 code = __hsub2(bf2(c[i]), k136);  // q - 8, exact
        const uint32_t v = bits(__hfma2(code, s_hi[e], __hmul2(code, s_lo[e])));
        (i < 2 ? lo : hi)[e] = v;
      }
    }
    const int klo = (pr / 16) * 32 + pr % 16;
    *reinterpret_cast<uint4*>(atom + swz(klo, cg % 8)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(atom + swz(klo + 16, cg % 8)) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
  }
}

template <typename TO, int M>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm) q40_prefill_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_p,
    const __grid_constant__ CUtensorMap map_s, const uint8_t* __restrict__ packed,
    const __half* __restrict__ scales, float* __restrict__ partial, TO* __restrict__ out,
    int m, int k, int n, int steps_per_split, int tma_w) {
  using L = Layout<M>;
  constexpr int kMTiles = M / 128;  // m64 tiles of each warpgroup
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
  const uint32_t stage_bytes = L::kXBytes + (tma_w ? kPBytes + kSBytes : 0);

  // stage s of step `step`: TMA copies issued by thread 0 (and the raw tile
  // by every thread where TMA cannot describe it)
  auto fill = [&](int step) {
    const int s = step % kStages;
    const int gs = step0 + step;
    if (tid == 0) {
      mbar_expect(bar0 + 8 * s, stage_bytes);
      tma_load(sm_addr + s * L::kXBytes, &map_x, bar0 + 8 * s, gs * BK, row0);
      if (tma_w) {
        tma_load(sm_addr + L::kOffP + s * kPBytes, &map_p, bar0 + 8 * s, col0, gs * BK / 2);
        tma_load(sm_addr + L::kOffS + s * kSBytes, &map_s, bar0 + 8 * s, col0, gs * BK / 32);
      }
    }
    if (!tma_w)
      load_w_plain(sm + L::kOffP + s * kPBytes,
                   reinterpret_cast<__half*>(sm + L::kOffS + s * kSBytes), gs, packed, scales,
                   k, n, col0, tid);
  };
  auto dequant = [&](int step) {
    const int s = step % kStages;
    dequant_step(sm + L::kOffP + s * kPBytes,
                 reinterpret_cast<const __half*>(sm + L::kOffS + s * kSBytes),
                 sm + L::kOffB + (step & 1) * kBBytes, tid);
  };

  float acc[kMTiles][BN / 2];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;

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
    const uint32_t a_base = sm_addr + (j % kStages) * L::kXBytes + wg * (M / 2) * 128;
    const uint32_t b_base = sm_addr + L::kOffB + (j & 1) * kBBytes;
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) fence_acc(acc[mt]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
        // A: +32 bytes per k16 within the swizzled 128-byte rows, 1024-byte
        // groups of 8 rows, 64 rows per m64 tile. B: +16 rows per k16;
        // 64-column atoms 8 KB apart, groups of 8 k rows 1024 bytes apart.
        wgmma_m64n128k16(acc[mt], desc_sw128(a_base + mt * 64 * 128 + kk * 32, 16, 1024),
                         desc_sw128(b_base + kk * 16 * 128, BK * 128, 1024), 1);
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
      const float v0 = acc[mt][4 * t + 2 * h], v1 = acc[mt][4 * t + 2 * h + 1];
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
int launch(const void* x, const void* packed, const void* scales, void* partial, void* out,
           int m, int k, int n, int splits, int steps_per_split, cudaStream_t st) {
  // the raw tile goes by TMA where its rows are 16-byte aligned
  const int tma_w = n % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  CUtensorMap map_x, map_p, map_s;
  if (!make_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, k, M, BK,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  map_p = map_s = map_x;  // unused unless tma_w
  if (tma_w && !(make_map(&map_p, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed, k / 2, n, BK / 2,
                          BN, CU_TENSOR_MAP_SWIZZLE_NONE) &&
                 make_map(&map_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2, scales, k / 32, n,
                          BK / 32, BN, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return -2;
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(q40_prefill_kernel<TO, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Layout<M>::kSmem);
    configured = true;
  }
  // row tiles fastest: the blocks that share a weight tile run together
  dim3 grid((m + M - 1) / M, (n + BN - 1) / BN, splits);
  auto* part = static_cast<float*>(partial);
  auto* o = static_cast<TO*>(out);
  q40_prefill_kernel<TO, M><<<grid, kThreads, Layout<M>::kSmem, st>>>(
      map_x, map_p, map_s, static_cast<const uint8_t*>(packed),
      static_cast<const __half*>(scales), part, o, m, k, n, steps_per_split, tma_w);
  if (splits > 1) {
    const size_t mn = (size_t)m * n;
    launch_splitk_reduce<TO>(part, o, mn, splits, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [m, k] (16-byte aligned rows, k % 32 == 0); packed u8 [k/2, n];
// scales f16 [k/32, n]; out [m, n] in bf16 (out_f32 == 0) or f32; partial
// f32 [splits, m, n] for the split-k sums (unused when splits == 1), each
// split walking steps_per_split steps of 64 input dims; blocks of BM rows
// where m >= BM, else of BM_SMALL. Returns the CUDA error state after the
// launches (0 = success; -2 = a tensor map could not be made).
extern "C" int q40_prefill(const void* x, const void* packed, const void* scales,
                           void* partial, void* out, int m, int k, int n, int splits,
                           int steps_per_split, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DLLAMA_Q40_ARGS x, packed, scales, partial, out, m, k, n, splits, steps_per_split, st
  if (m >= BM)
    return out_f32 ? launch<float, BM>(DLLAMA_Q40_ARGS)
                   : launch<__nv_bfloat16, BM>(DLLAMA_Q40_ARGS);
  return out_f32 ? launch<float, BM_SMALL>(DLLAMA_Q40_ARGS)
                 : launch<__nv_bfloat16, BM_SMALL>(DLLAMA_Q40_ARGS);
#undef DLLAMA_Q40_ARGS
}
