// The wgmma GEMM loop for Hopper shared by q40_prefill.cu (K2) and the
// m > 16 routes of the kernel benchmark's kbench_fma_f32.cu (K11-B) and
// kbench_bf16_gemm.cu (K11-D): out[m, n] = x[m, k] @ W[k, n] with f32
// accumulation. Included by those sources, never built alone. Two template
// parameters: a weight policy says what one step's weight tile is and how it
// becomes the bf16 B tiles that wgmma reads; the type of x says how the A
// tiles are made.
//
// The loop (K2's; its design is set out in q40_prefill.cu):
//  * A block of two warpgroups owns a BM x 128 output tile (BM = 256 rows
//    for a call of 256 rows or more, else 128); each warpgroup runs
//    wgmma.mma_async m64n128k16 (bf16 in, f32 accumulators in registers)
//    over BM / 2 rows, so a 256-row call reads each weight tile once.
//  * A ring of stages filled by TMA (one thread issues the copies, an
//    mbarrier per stage counts their bytes): per step of 64 input dims, the
//    x tile [BM x 64] bf16 in the 128-byte-swizzled K-major layout of A, and
//    the step's weight tile. TMA zero-fills past m, k and n.
//  * Policies that dequantize (Q40Bf16: K2; Q40SplitF32: K11-B) stage the
//    raw Q40 tile and their warpgroups turn it into bf16 B tiles [64 x 128]
//    in the 128-byte-swizzled MN-major layout that wgmma reads with its B
//    transpose bit (two 64-column atoms 8 KB apart), double-buffered: step
//    j + 1 is dequantized while the products of step j run. K11-B writes two
//    B tiles a step, w_hi = bf16(w) and w_lo = bf16(w - w_hi) of the f32
//    weight w = (q - 8) s, and both products go into one accumulator set:
//    with s an f16 widened to f32, w has at most 14 significant bits and
//    w_hi + w_lo is w exactly (else within 2^-16 of |w|).
//  * Bf16Tiles (K11-D) has nothing to dequantize: TMA writes the weight
//    tile straight into the MN-major B layout (two 64 x 64 boxes in the
//    128-byte swizzle, one a 64-column atom), and the ring is as deep as the
//    shared memory allows; one wgmma group stays in flight while the next
//    step's is issued, and a stage is refilled once both warpgroups are done
//    with it.
//  * An f32 x (K11-B) does not go through the ring: with the dequantization
//    the threads read the step's x tile, split each value into three bf16
//    terms whose sum is the value exactly, and write three A tiles; the
//    products of every A term and B term go into the one accumulator set,
//    so every product is exact. 128-row blocks only.
//  * Where the output tiles alone leave SMs idle, K2 splits k across blocks
//    and a second pass sums the f32 partials in a fixed order
//    (launch_splitk_reduce): no float atomics. The K11 routes take no split.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {
namespace prefill {

constexpr int BM = 256;        // rows of x per block at m >= 256 (two warpgroups)
constexpr int BM_SMALL = 128;  // ... and below
constexpr int BN = 128;        // output columns per block (the wgmma width)
constexpr int BK = 64;         // input dims per step: two 32-row Q40 blocks
constexpr int kThreads = 256;
constexpr int kMinBlocksPerSm = 1;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may have

constexpr int kBBytes = BK * BN * 2;  // one bf16 B tile, 16 KB
constexpr int kPBytes = BK / 2 * BN;  // one stage of packed nibbles, 4 KB

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// Dequantizing policies share the thread mapping: thread -> 8 columns from
// 8 cg and kRows consecutive packed rows of one Q40 block, so that it reads
// its 8 scales once. Packed row pr of a step holds k rows 32 (pr / 16) + pr %
// 16 (low nibbles) and that + 16 (high nibbles).
constexpr int kGroups = BN / 8;
constexpr int kDeqRows = BK / 2 * kGroups / kThreads;  // packed rows a thread
static_assert(16 % kDeqRows == 0, "a thread's rows stay in one Q40 block");

// K2: f16 scales; each weight its exact code q - 8 times the scale, rounded
// once to bf16 (the plain version's rounding): one B tile.
struct Q40Bf16 {
  using Scale = __half;
  static constexpr bool kDequant = true;
  static constexpr int kTerms = 1;  // B tiles a step

  // One mask-or turns two nibbles into the bf16 values 128 + q, one bf16x2
  // add into the codes q - 8, and with the f16 scale split into bf16 parts
  // s = s_hi + s_lo, (q - 8) s_lo is exact in bf16 and one bf16x2 FMA
  // (q - 8) s_hi + (q - 8) s_lo rounds (q - 8) s once: two weights per
  // instruction.
  static __device__ __forceinline__ void dequant(const unsigned char* ps, const void* ssv,
                                                 unsigned char* bt, int tid) {
    const __half* ss = static_cast<const __half*>(ssv);
    const int cg = tid % kGroups, pr0 = (tid / kGroups) * kDeqRows;
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
    for (int r = 0; r < kDeqRows; ++r) {
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
};

// K11-B: f32 scales; each weight w = (q - 8) s in f32 (the exact code times
// the scale), written as two B tiles, w_hi = bf16(w) and w_lo = bf16(w -
// w_hi): the remainder w - w_hi is exact in f32, so w_hi + w_lo is w to
// within 2^-16 of |w|, and exactly where w has at most 16 significant bits
// (every f16 scale widened to f32: at most 14).
struct Q40SplitF32 {
  using Scale = float;
  static constexpr bool kDequant = true;
  static constexpr int kTerms = 2;

  static __device__ __forceinline__ void dequant(const unsigned char* ps, const void* ssv,
                                                 unsigned char* bt, int tid) {
    const float* ss = static_cast<const float*>(ssv);
    const int cg = tid % kGroups, pr0 = (tid / kGroups) * kDeqRows;
    const float4 s0 = *reinterpret_cast<const float4*>(ss + (pr0 / 16) * BN + cg * 8);
    const float4 s1 = *reinterpret_cast<const float4*>(ss + (pr0 / 16) * BN + cg * 8 + 4);
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    unsigned char* atom = bt + (cg / 8) * (BK * 128);
#pragma unroll
    for (int r = 0; r < kDeqRows; ++r) {
      const int pr = pr0 + r;
      const uint2 p = *reinterpret_cast<const uint2*>(ps + pr * BN + cg * 8);
      uint32_t hi[2][4], lo[2][4];  // [k row klo, klo + 16][column pair]
#pragma unroll
      for (int h = 0; h < 2; ++h)  // low nibbles (row klo), high nibbles (klo + 16)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t word = e < 2 ? p.x : p.y;
          const int b0 = 8 * (2 * e % 4) + 4 * h;  // bit of column 2e's nibble
          const float w0 = q40_code((word >> b0) & 15u) * s[2 * e];
          const float w1 = q40_code((word >> (b0 + 8)) & 15u) * s[2 * e + 1];
          const __nv_bfloat162 wh = __floats2bfloat162_rn(w0, w1);
          const float2 f = __bfloat1622float2(wh);
          hi[h][e] = bits(wh);
          lo[h][e] = bits(__floats2bfloat162_rn(w0 - f.x, w1 - f.y));
        }
      const int klo = (pr / 16) * 32 + pr % 16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = swz(klo + 16 * h, cg % 8);
        *reinterpret_cast<uint4*>(atom + off) = make_uint4(hi[h][0], hi[h][1], hi[h][2], hi[h][3]);
        *reinterpret_cast<uint4*>(atom + kBBytes + off) =
            make_uint4(lo[h][0], lo[h][1], lo[h][2], lo[h][3]);
      }
    }
  }
};

// K11-D: bf16 weights [k, n], by TMA straight into the B layout.
struct Bf16Tiles {
  using Scale = void;
  static constexpr bool kDequant = false;
  static constexpr int kTerms = 1;
};

template <class W>
__host__ __device__ constexpr int scale_stage_bytes() {
  if constexpr (W::kDequant)
    return BK / 32 * BN * (int)sizeof(typename W::Scale);
  else
    return 0;
}

// Shared memory of a BM = M block: the ring's x stages (x by TMA), the A
// tiles the threads build (f32 x), the B tiles the threads dequantize into,
// the ring's weight stages (the raw tile, or the B tile itself), the raw
// stages' scales, the stages' mbarriers. Tiles are 1024-byte aligned (the
// 128-byte swizzle repeats every 8 rows of 128 bytes, and the wgmma
// descriptors assume base offset 0).
template <class W, typename TX, int M>
struct Layout {
  static constexpr bool kXTma = sizeof(TX) == 2;
  static constexpr int kXT = kXTma ? 1 : 3;         // A terms a step
  static constexpr int kXBytes = M * BK * 2;        // one bf16 x (A) tile
  static constexpr int kStageX = kXTma ? kXBytes : 0;
  static constexpr int kStageW = W::kDequant ? kPBytes : kBBytes;
  static constexpr int kSBytes = scale_stage_bytes<W>();
  static constexpr int kFixed =
      (kXTma ? 0 : 2 * kXT * kXBytes) + (W::kDequant ? 2 * W::kTerms * kBBytes : 0);
  static constexpr int kRoom = (kSmemMax - 1024 - kFixed) / (kStageX + kStageW + kSBytes + 8);
  static constexpr int kStages = W::kDequant ? 4 : (kRoom < 8 ? kRoom : 8);
  static constexpr int kOffA = kStages * kStageX;
  static constexpr int kOffB = kOffA + (kXTma ? 0 : 2 * kXT * kXBytes);
  static constexpr int kOffP = kOffB + (W::kDequant ? 2 * W::kTerms * kBBytes : 0);
  static constexpr int kOffS = kOffP + kStages * kStageW;
  static constexpr int kOffBar = kOffS + kStages * kSBytes;
  static constexpr int kSmem = kOffBar + kStages * 8 + 1024;  // + room to align the base
  static_assert(kStages >= 4 && kSmem <= kSmemMax, "the ring does not fit");
  static_assert(kXTma || M == BM_SMALL, "an f32 x takes 128-row blocks");
};

// The raw Q40 tile of step `step` loaded by the threads themselves (n % 16
// != 0: packed rows are not 16-byte aligned): zero past k and n.
template <typename Sc>
__device__ __forceinline__ void load_w_plain(unsigned char* ps, Sc* ss, int step,
                                             const uint8_t* packed, const Sc* scales, int k,
                                             int n, int col0, int tid) {
  const int nkb = k / 32;
  for (int i = tid; i < BK / 2 * BN; i += kThreads) {
    const int pr = i / BN, c = i % BN;
    const int kb = step * 2 + pr / 16;
    ps[i] = kb < nkb && col0 + c < n ? packed[((size_t)kb * 16 + pr % 16) * n + col0 + c] : 0;
  }
  for (int i = tid; i < BK / 32 * BN; i += kThreads) {
    const int kb = step * 2 + i / BN, c = i % BN;
    ss[i] = kb < nkb && col0 + c < n ? scales[(size_t)kb * n + col0 + c] : static_cast<Sc>(0.f);
  }
}

// The f32 x tile of step `step` split into three bf16 A tiles (at, at +
// kXBytes, at + 2 kXBytes) in the 128-byte-swizzled K-major layout TMA would
// write: zero past m and k. Thread -> 8 dims (one 16-byte chunk a term) of
// one row at a time.
template <int M>
__device__ __forceinline__ void split_x(unsigned char* at, const float* x, int step, int row0,
                                        int m, int k, int tid) {
  for (int e = tid; e < M * 8; e += kThreads) {
    const int r = e / 8, c = e % 8, gr = row0 + r, gk = step * BK + c * 8;
    float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
    if (gr < m && gk < k) {  // k % 8 == 0: a chunk is all in or all out
      const float4* src = reinterpret_cast<const float4*>(x + (size_t)gr * k + gk);
      v0 = __ldg(src);
      v1 = __ldg(src + 1);
    }
    uint32_t t[4][3];
    split_bf16x3(make_float2(v0.x, v0.y), t[0]);
    split_bf16x3(make_float2(v0.z, v0.w), t[1]);
    split_bf16x3(make_float2(v1.x, v1.y), t[2]);
    split_bf16x3(make_float2(v1.z, v1.w), t[3]);
#pragma unroll
    for (int xt = 0; xt < 3; ++xt)
      *reinterpret_cast<uint4*>(at + xt * M * BK * 2 + swz(r, c)) =
          make_uint4(t[0][xt], t[1][xt], t[2][xt], t[3][xt]);
  }
}

template <class W, typename TX, typename TO, int M>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm) prefill_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_p,
    const __grid_constant__ CUtensorMap map_s, const TX* __restrict__ x,
    const uint8_t* __restrict__ packed, const void* __restrict__ scales,
    float* __restrict__ partial, TO* __restrict__ out, int m, int k, int n, int steps_per_split,
    int tma_w) {
  using L = Layout<W, TX, M>;
  constexpr int kMTiles = M / 128;  // m64 tiles of each warpgroup
  constexpr int NS = L::kStages;
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
  const uint32_t stage_bytes =
      L::kStageX + (W::kDequant ? (tma_w ? kPBytes + L::kSBytes : 0) : kBBytes);

  // stage s of step `step`: TMA copies issued by thread 0 (and the raw tile
  // by every thread where TMA cannot describe it)
  auto fill = [&](int step) {
    const int s = step % NS;
    const int gs = step0 + step;
    const uint32_t bar = bar0 + 8 * s, wdst = sm_addr + L::kOffP + s * L::kStageW;
    if (tid == 0) {
      mbar_expect(bar, stage_bytes);
      if constexpr (L::kXTma) tma_load(sm_addr + s * L::kStageX, &map_x, bar, gs * BK, row0);
      if constexpr (W::kDequant) {
        if (tma_w) {
          tma_load(wdst, &map_p, bar, col0, gs * BK / 2);
          tma_load(sm_addr + L::kOffS + s * L::kSBytes, &map_s, bar, col0, gs * BK / 32);
        }
      } else {  // the B tile's two 64-column atoms
        tma_load(wdst, &map_p, bar, col0, gs * BK);
        tma_load(wdst + BK * 128, &map_p, bar, col0 + 64, gs * BK);
      }
    }
    if constexpr (W::kDequant) {
      using Sc = typename W::Scale;
      if (!tma_w)
        load_w_plain(sm + L::kOffP + s * kPBytes,
                     reinterpret_cast<Sc*>(sm + L::kOffS + s * L::kSBytes), gs, packed,
                     static_cast<const Sc*>(scales), k, n, col0, tid);
    }
  };
  // the B tiles (and A tiles, f32 x) of step `step`, from its raw stage
  auto dequant = [&](int step) {
    if constexpr (W::kDequant) {
      const int s = step % NS;
      W::dequant(sm + L::kOffP + s * kPBytes, sm + L::kOffS + s * L::kSBytes,
                 sm + L::kOffB + (step & 1) * W::kTerms * kBBytes, tid);
      if constexpr (!L::kXTma)
        split_x<M>(sm + L::kOffA + (step & 1) * L::kXT * L::kXBytes, x, step0 + step, row0, m,
                   k, tid);
    }
  };
  // the products of step j: every A term times every B term, one accumulator set
  auto issue = [&](int j, float(&acc)[kMTiles][BN / 2]) {
    const uint32_t a_base =
        (L::kXTma ? sm_addr + (j % NS) * L::kStageX
                  : sm_addr + L::kOffA + (j & 1) * L::kXT * L::kXBytes) +
        wg * (M / 2) * 128;
    const uint32_t b_base = W::kDequant ? sm_addr + L::kOffB + (j & 1) * W::kTerms * kBBytes
                                        : sm_addr + L::kOffP + (j % NS) * kBBytes;
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) fence_acc(acc[mt]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int xt = 0; xt < L::kXT; ++xt)
#pragma unroll
          for (int wt = 0; wt < W::kTerms; ++wt)
            // A: +32 bytes per k16 within the swizzled 128-byte rows, 1024-byte
            // groups of 8 rows, 64 rows per m64 tile. B: +16 rows per k16;
            // 64-column atoms 8 KB apart, groups of 8 k rows 1024 bytes apart.
            wgmma_m64n128k16(
                acc[mt],
                desc_sw128(a_base + xt * L::kXBytes + mt * 64 * 128 + kk * 32, 16, 1024),
                desc_sw128(b_base + wt * kBBytes + kk * 16 * 128, BK * 128, 1024), 1);
    wgmma_commit();
  };

  float acc[kMTiles][BN / 2];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(bar0 + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int j = 0; j < NS - 1 && j < nst; ++j) fill(j);

  if constexpr (W::kDequant) {
    if (nst > 0) {
      mbar_wait(bar0, 0);
      __syncthreads();  // (the raw tile some threads loaded themselves)
      dequant(0);
    }
    fence_proxy_async();
    __syncthreads();

    // step j: its products run while step j + 1 is dequantized; its stage is
    // refilled with step j + NS - 1 one step later, once they are done
    for (int j = 0; j < nst; ++j) {
      issue(j, acc);
      if (j + NS - 1 < nst) fill(j + NS - 1);  // the stage of step j - 1
      if (j + 1 < nst) {
        mbar_wait(bar0 + 8 * ((j + 1) % NS), ((j + 1) / NS) & 1);
        __syncthreads();
        dequant(j + 1);
        fence_proxy_async();
      }
      wgmma_wait();
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) fence_acc(acc[mt]);
      __syncthreads();
    }
  } else {
    // step j: once its stage has landed its products are issued, step j -
    // 1's are waited for (one group stays in flight), and its stage is
    // refilled with step j + NS - 1 once both warpgroups are past that wait
    for (int j = 0; j < nst; ++j) {
      mbar_wait(bar0 + 8 * (j % NS), (j / NS) & 1);
      issue(j, acc);
      wgmma_wait<1>();
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) fence_acc(acc[mt]);
      __syncthreads();
      if (j + NS - 1 < nst) fill(j + NS - 1);
    }
    wgmma_wait();
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) fence_acc(acc[mt]);
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

template <class W, typename TX, typename TO, int M>
int launch(const void* x, const void* w, const void* scales, void* partial, void* out, int m,
           int k, int n, int splits, int steps_per_split, cudaStream_t st) {
  using L = Layout<W, TX, M>;
  CUtensorMap map_x{}, map_p{}, map_s{};
  if constexpr (L::kXTma) {
    if (!make_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, k, M, BK,
                  CU_TENSOR_MAP_SWIZZLE_128B))
      return -2;
    map_p = map_s = map_x;  // unused unless tma_w
  }
  int tma_w;
  if constexpr (W::kDequant) {
    // the raw tile goes by TMA where its rows are 16-byte aligned
    using Sc = typename W::Scale;
    tma_w = n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(scales) % 16 == 0;
    if (tma_w && !(make_map(&map_p, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, k / 2, n, BK / 2, BN,
                            CU_TENSOR_MAP_SWIZZLE_NONE) &&
                   make_map(&map_s,
                            sizeof(Sc) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                            sizeof(Sc), scales, k / 32, n, BK / 32, BN,
                            CU_TENSOR_MAP_SWIZZLE_NONE)))
      return -2;
  } else {  // 64 x 64 boxes of bf16 W [k, n] in the 128-byte swizzle
    tma_w = 1;
    if (n % 8 || reinterpret_cast<uintptr_t>(w) % 16 ||
        !make_map(&map_p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, k, n, BK, 64,
                  CU_TENSOR_MAP_SWIZZLE_128B))
      return -2;
  }
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(prefill_kernel<W, TX, TO, M>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    configured = true;
  }
  // row tiles fastest: the blocks that share a weight tile run together
  dim3 grid((m + M - 1) / M, (n + BN - 1) / BN, splits);
  auto* part = static_cast<float*>(partial);
  auto* o = static_cast<TO*>(out);
  prefill_kernel<W, TX, TO, M><<<grid, kThreads, L::kSmem, st>>>(
      map_x, map_p, map_s, static_cast<const TX*>(x), static_cast<const uint8_t*>(w), scales,
      part, o, m, k, n, steps_per_split, tma_w);
  if (splits > 1) {
    const size_t mn = (size_t)m * n;
    launch_splitk_reduce<TO>(part, o, mn, splits, st);
  }
  return (int)cudaGetLastError();
}

// x [m, k] in TX (bf16: 16-byte aligned rows; f32: 16-byte aligned, k % 8
// == 0), the weight w and its scales as the policy W takes them; out [m, n]
// in TO; partial f32 [splits, m, n] for the split-k sums (unused when splits
// == 1), each split walking steps_per_split steps of BK input dims; blocks of
// BM rows where m >= BM and x is bf16, else of BM_SMALL. Returns the CUDA
// error state after the launches (0 = success; -2 = a tensor map could not
// be made).
template <class W, typename TX, typename TO>
int run(const void* x, const void* w, const void* scales, void* partial, void* out, int m,
        int k, int n, int splits, int steps_per_split, cudaStream_t st) {
  if constexpr (sizeof(TX) == 2) {
    if (m >= BM)
      return launch<W, TX, TO, BM>(x, w, scales, partial, out, m, k, n, splits,
                                   steps_per_split, st);
  }
  return launch<W, TX, TO, BM_SMALL>(x, w, scales, partial, out, m, k, n, splits,
                                     steps_per_split, st);
}

}  // namespace prefill
}  // namespace
