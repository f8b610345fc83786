// Decode body shared by q40_decode.cu (K1) and q80_decode.cu (K5): the
// product out[m, n] = x[m, k] @ W[k, n] for m <= 16, W a block-quantized
// weight (32-row blocks of k, one f16 scale per block and column). Included
// by those sources, never built alone. A code-format policy (Q40Codes,
// Q80Codes) is the template parameter: it says how a block's codes are
// stored and how a thread turns its bytes into tensor-core fragments.
//
// Semantics (the TPU blockdot's, dllama_tpu/ops/pallas/q40_matmul.py and
// q80_matmul.py _blockdot_kernel): per 32-row block b of k, the exact
// integer codes meet x in a partial dot y_b = x_b . codes_b, and the f16
// scale, widened exactly to f32, multiplies that partial: out = sum_b s_b *
// y_b in f32.
//
// What bounds it on this card: device-memory bytes. A call streams the weight
// once, 0.5625 bytes a weight in Q40 and 1.0625 in Q80, and does 2m
// operations a weight: at m <= 16 at most ~57 a byte, against the ~295 a byte
// where the bf16 tensor cores would take over. What the design does about it:
//
//  * Products on the tensor cores, codes in A. Per 32-row block, two
//    mma.sync.m16n8k16 steps (bf16 in, f32 out) into a zeroed fragment give
//    y_b: A is 16 columns of W (transposed: a column is an A row), B is up to
//    8 rows of x (m <= 8; a second n8 tile for rows 8-15), so the work a
//    weight takes does not grow with m. A bf16 x times a small integer is
//    exact in f32. Then acc += s_b * y_b in f32, one FMA an output.
//  * Exact codes in few instructions. A thread's A fragments pair two k rows
//    of one column. Q40: one byte_perm pairs the bytes of two packed rows,
//    one lop3 forms `(p & 0x000F000F) | 0x43004300`, bf16 (128 + q) in each
//    half, and one bf16x2 subtraction of 136 leaves q - 8 exactly (every
//    integer up to 256 is exact in bf16): 1.5 instructions a weight. Q80: a
//    byte_perm puts each code + 128 into the mantissa of 2^23, one f32
//    subtraction leaves the code, and one byte_perm packs the upper halves
//    of two such f32, their bf16 (a code has at most 8 significant bits):
//    2.75 instructions a weight.
//  * Columns are permuted so that a thread's bytes are contiguous: in n16
//    tile i, A row g (g + 8) is column 2 I g + 2 i (+ 1) of the warp's 16 I
//    columns. A thread reads 2 I bytes of each of its rows and 2 I scales,
//    and writes 2 I output columns.
//  * Each warp streams its own run of k (blocks wk, wk + WK, ... of its
//    split) through its own ring of kStages slots in shared memory, a slot
//    one 32-row block of its columns: weight rows, scales and x rows, filled
//    by 16-byte cp.async copies from per-lane pointers that move by a fixed
//    stride. No block-wide barrier in the loop: the copies of the next
//    kStages - 1 blocks are in flight while the warp unpacks and multiplies
//    one (a barrier per chunk of k shared by the 4 warps would hold each
//    warp to the slowest copy). Rows padded by 16 bytes keep the fragment
//    reads free of bank conflicts.
//  * Split-k inside the one launch. Grid (column tiles, splits): a split
//    walks kb_per_split blocks of k. The warps' sums of a block meet in
//    shared memory in warp order; with one split the block writes the output.
//    Otherwise it writes its f32 partial (it stays in L2), fences, and counts
//    its arrival on the column tile's counter; the last block to arrive reads
//    the partials of all (at most kMaxSplits) splits at once, sums them in
//    split order, writes the output, and sets the counter back to 0 for the
//    next launch. No float atomics: a result repeats from run to run, and a
//    column's sum order follows k alone (split boundaries, WK), not n or m:
//    a row of an m-row call equals that row computed alone.
//  * Where the rows cannot be copied in 16-byte pieces (n % 16 != 0, or a
//    weight not 16-byte aligned), the threads copy bytes into the same slots.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;                 // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxM = 16;                 // rows of x a call takes
constexpr int kMinCols = 32;              // columns of a warp: 16 I, I = 2, 4 or 8
constexpr int kMaxCols = 128;
constexpr int kMaxSplits = 8;             // splits of a launch (the partials read at once)
constexpr int kRowPad = 16;               // bytes after each staged weight row
constexpr int kXLd = 40;                  // bf16 of a staged x row of one block (80 B)

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// 16-byte copy into shared memory; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// C[16 x 8] += A[16 x 16] B[16 x 8]: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// BYTES (4, 8, 16 or 32) bytes of shared memory at p as words.
template <int BYTES>
__device__ __forceinline__ void lds(uint32_t (&w)[BYTES / 4], const uint8_t* p) {
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + 16 * i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (BYTES == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// Nibbles at bits 0-3 and 16-19 of v -> bf16x2 of the codes q - 8, exactly.
// One lop3 forms (v & 0x000F000F) | 0x43004300, bf16 128 + q in each half
// (written out: the compiler would split the two constants into two ops).
__device__ __forceinline__ uint32_t q40_pair(uint32_t v) {
  uint32_t b;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(b) : "r"(v), "r"(0x000F000Fu), "r"(0x43004300u));
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b), __float2bfloat162_rn(136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Byte c of w, an int8 code XOR 0x80 (q + 128), as the exact f32 q.
__device__ __forceinline__ float q80_code(uint32_t w, int c) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | c)) - 8388736.0f;
}

// Byte c of lo and of hi -> bf16x2 (lo's code in the low half), exactly: a
// code has at most 8 significant bits, so the upper half of its f32 is its
// bf16, and one byte_perm packs the two upper halves.
__device__ __forceinline__ uint32_t q80_pair(uint32_t lo, uint32_t hi, int c) {
  return __byte_perm(__float_as_uint(q80_code(lo, c)), __float_as_uint(q80_code(hi, c)), 0x7632u);
}

// Q40: packed [k/2, n] u8. Packed row r (0-15) of a 32-row block holds dim r
// of each column in its low nibble and dim r + 16 in its high nibble, so step
// 0 of the block's two k16 steps takes the low nibbles of the 16 rows and
// step 1 the high ones; a thread reads rows 2t, 2t+1, 2t+8, 2t+9 once.
struct Q40Codes {
  static constexpr int kRows = 16;    // stored rows of a 32-row block
  static constexpr int kStages = 4;   // ring slots
  static constexpr bool kWideTiles = true;  // 256 and 512 columns a block too

  template <int I>
  struct Frag {
    uint32_t w[4][I / 2];

    __device__ __forceinline__ void load(const uint8_t* p, int ld, int t) {
      lds<2 * I>(w[0], p + (2 * t) * ld);
      lds<2 * I>(w[1], p + (2 * t + 1) * ld);
      lds<2 * I>(w[2], p + (2 * t + 8) * ld);
      lds<2 * I>(w[3], p + (2 * t + 9) * ld);
    }

    // A fragments of n16 tile i (bytes 2i, 2i+1 of a row) for steps 0 and 1
    __device__ __forceinline__ void tile(int i, uint32_t a[2][4]) const {
      const uint32_t sel = (i & 1) ? 0x7632u : 0x5410u;
      const uint32_t p01 = __byte_perm(w[0][i >> 1], w[1][i >> 1], sel);
      const uint32_t p23 = __byte_perm(w[2][i >> 1], w[3][i >> 1], sel);
      a[0][0] = q40_pair(p01);
      a[0][1] = q40_pair(p01 >> 8);
      a[0][2] = q40_pair(p23);
      a[0][3] = q40_pair(p23 >> 8);
      a[1][0] = q40_pair(p01 >> 4);
      a[1][1] = q40_pair(p01 >> 12);
      a[1][2] = q40_pair(p23 >> 4);
      a[1][3] = q40_pair(p23 >> 12);
    }
  };
};

// Q80: codes [k, n] i8, one row per dim; step s of a 32-row block takes rows
// 16s..16s+15, a thread rows 16s + 2t, +1, +8, +9.
struct Q80Codes {
  static constexpr int kRows = 32;
  static constexpr int kStages = 3;
  static constexpr bool kWideTiles = false;

  template <int I>
  struct Frag {
    uint32_t w[2][4][I / 2];  // codes XOR 0x80, i.e. q + 128 in each byte

    __device__ __forceinline__ void load(const uint8_t* p, int ld, int t) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int r = 16 * s + 2 * t;
        lds<2 * I>(w[s][0], p + r * ld);
        lds<2 * I>(w[s][1], p + (r + 1) * ld);
        lds<2 * I>(w[s][2], p + (r + 8) * ld);
        lds<2 * I>(w[s][3], p + (r + 9) * ld);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < I / 2; ++q) w[s][j][q] ^= 0x80808080u;
      }
    }

    __device__ __forceinline__ void tile(int i, uint32_t a[2][4]) const {
      const int q = i >> 1, c = 2 * (i & 1);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        a[s][0] = q80_pair(w[s][0][q], w[s][1][q], c);
        a[s][1] = q80_pair(w[s][0][q], w[s][1][q], c + 1);
        a[s][2] = q80_pair(w[s][2][q], w[s][3][q], c);
        a[s][3] = q80_pair(w[s][2][q], w[s][3][q], c + 1);
      }
    }
  };
};

// The shape of one instantiation: I n16 tiles a warp (16 I columns), WC
// column groups a block, MT n8 tiles of x rows (M = 8 MT). Each warp owns a
// ring of kStages slots in shared memory, a slot one 32-row block of its
// columns: weight rows, scales and x rows.
template <class Codes, int I, int WC, int MT>
struct DecodeShape {
  static constexpr int M = 8 * MT;
  static constexpr int WK = kWarps / WC;       // warps along k
  static constexpr int GC = 16 * I;            // columns of a warp
  static constexpr int BN = GC * WC;           // columns of a block
  static constexpr int LDW = GC + kRowPad;     // bytes of a staged weight row
  static constexpr int W_BYTES = Codes::kRows * LDW;
  static constexpr int S_BYTES = GC * 2;
  static constexpr int X_BYTES = M * kXLd * 2;
  static constexpr int SLOT = W_BYTES + S_BYTES + X_BYTES;
  static constexpr int RING = Codes::kStages * SLOT;
  static constexpr int RED = WK * M * BN * 4;  // the warps' sums, after the rings
  static constexpr int SMEM = kWarps * RING > RED ? kWarps * RING : RED;
  static_assert(W_BYTES % 16 == 0 && S_BYTES % 16 == 0 && X_BYTES % 16 == 0, "16-byte slots");
  static_assert(M <= kMaxM && GC >= kMinCols && GC <= kMaxCols && kWarps % WC == 0, "shape");
};

__device__ __forceinline__ void store_out(void* out, size_t i, float v, int out_f32) {
  if (out_f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<bf16*>(out)[i] = __float2bfloat16(v);
}

template <class Codes, int I, int WC, int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 3 : 2) decode_kernel(
    const bf16* __restrict__ x, const uint8_t* __restrict__ w,
    const __half* __restrict__ scales, float* __restrict__ partial,
    int* __restrict__ counters, void* __restrict__ out, int out_f32, int m, int k, int n,
    int kb_per_split, int vec) {
  using S = DecodeShape<Codes, I, WC, MT>;
  constexpr int M = S::M, WK = S::WK, GC = S::GC, BN = S::BN, LDW = S::LDW;
  constexpr int ROWS = Codes::kRows, NS = Codes::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wc = warp % WC, wk = warp / WC;
  const int col0 = blockIdx.x * BN, wcol = col0 + wc * GC;  // the block's, the warp's
  const int kb0 = blockIdx.y * kb_per_split + wk;           // this warp's first block
  const int kb1 = min(k / 32, blockIdx.y * kb_per_split + kb_per_split);
  const int blocks = kb0 < kb1 ? (kb1 - kb0 + WK - 1) / WK : 0;  // this warp walks
  uint8_t* ring = smem + warp * S::RING;

  // x rows m..M-1 stay zero: the copies write only rows < m (5 pieces of
  // 16 bytes a staged row)
  for (int i = lane; i < NS * M * 5; i += 32)
    if ((i / 5) % M >= m)
      *reinterpret_cast<uint4*>(ring + (i / (M * 5)) * S::SLOT + S::W_BYTES + S::S_BYTES +
                                ((i / 5) % M) * kXLd * 2 + (i % 5) * 16) =
          make_uint4(0u, 0u, 0u, 0u);

  // Copy sources: lane l takes 16-byte piece l + 32 it of a block's weight
  // rows (row l / WCH + it * 32 / WCH, piece l % WCH), scales piece l (l <
  // GC / 8) and x piece l + 32 it (row l / 4 + 8 it, piece l % 4); each
  // pointer moves by one block of k (WK blocks for this warp) a step.
  constexpr int WCH = GC / 16, WROWS = 32 / WCH;  // pieces a weight row, rows a pass
  const int wr = lane / WCH, wch = lane % WCH;
  const bool w_in = wcol + wch * 16 < n;  // n % 16 == 0: a piece is all in or all out
  const bool s_in = lane < GC / 8 && wcol + lane * 8 < n;
  const size_t wstep = (size_t)WK * ROWS * n, wpass = (size_t)WROWS * n;
  const uint8_t* wsrc = w + ((size_t)kb0 * ROWS + wr) * n + wcol + wch * 16;
  const __half* ssrc = scales + (size_t)kb0 * n + wcol + lane * 8;
  const bf16* xsrc = x + (size_t)(lane / 4) * k + kb0 * 32 + (lane % 4) * 8;
  const int wdst = wr * LDW + wch * 16;
  const int xdst = S::W_BYTES + S::S_BYTES + ((lane / 4) * kXLd + (lane % 4) * 8) * 2;

  // this warp's j-th block of k (kb0 + j WK) into slot j % NS; one commit
  // group a block, empty past the last
  auto fill = [&](int j) {
    if (j < blocks) {
      uint8_t* slot = ring + (j % NS) * S::SLOT;
      const size_t kb = kb0 + j * WK;
      if (vec) {
        const uint8_t* src = wsrc + j * wstep;
#pragma unroll
        for (int it = 0; it < ceil_div(ROWS * WCH, 32); ++it)
          cp_async16(slot + wdst + it * WROWS * LDW, w_in ? src + it * wpass : w, w_in ? 16 : 0);
        if (lane < GC / 8)
          cp_async16(slot + S::W_BYTES + lane * 16, s_in ? ssrc + j * (size_t)WK * n : scales,
                     s_in ? 16 : 0);
      } else {  // rows that 16-byte copies cannot describe: bytes, zero past n
        for (int i = lane; i < ROWS * GC; i += 32) {
          const int r = i / GC, c2 = i % GC, col = wcol + c2;
          slot[r * LDW + c2] = col < n ? w[(kb * ROWS + r) * n + col] : (uint8_t)0;
        }
        __half* ss = reinterpret_cast<__half*>(slot + S::W_BYTES);
        for (int c2 = lane; c2 < GC; c2 += 32)
          ss[c2] = wcol + c2 < n ? scales[kb * n + wcol + c2] : __float2half(0.f);
      }
#pragma unroll
      for (int it = 0; it < ceil_div(M * 4, 32); ++it)  // x: 4 pieces a row
        if (lane / 4 + 8 * it < m)
          cp_async16(slot + xdst + it * 8 * kXLd * 2, xsrc + j * WK * 32 + (size_t)it * 8 * k, 16);
    }
    cp_async_commit();
  };

  float acc[I][MT][4];
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][mt][e] = 0.f;

#pragma unroll
  for (int j = 0; j < NS - 1; ++j) fill(j);
  for (int j = 0; j < blocks; ++j) {
    cp_async_wait<NS - 2>();  // this lane's copies of block j have landed
    __syncwarp();             // the warp's; and every lane is done with slot (j - 1) % NS
    fill(j + NS - 1);
    const uint8_t* slot = ring + (j % NS) * S::SLOT;
    const bf16* xs = reinterpret_cast<const bf16*>(slot + S::W_BYTES + S::S_BYTES);
    uint32_t b[MT][2][2];  // B fragments: x rows g (+ 8 mt), dims 16s + 2t (+ 8)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const bf16* xr = xs + (mt * 8 + g) * kXLd + 16 * s + 2 * t;
        b[mt][s][0] = *reinterpret_cast<const uint32_t*>(xr);
        b[mt][s][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
      }
    uint32_t sw[I];  // scales of columns 2i, 2i+1 of this thread's 2I, as half2
    lds<4 * I>(sw, slot + S::W_BYTES + 2 * I * g * 2);
    typename Codes::template Frag<I> f;
    f.load(slot + 2 * I * g, LDW, t);
#pragma unroll
    for (int i = 0; i < I; ++i) {
      uint32_t a[2][4];
      f.tile(i, a);
      const float2 s = __half22float2(*reinterpret_cast<const __half2*>(&sw[i]));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float y[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(y, a[0], b[mt][0][0], b[mt][0][1]);
        mma_bf16(y, a[1], b[mt][1][0], b[mt][1][1]);
        acc[i][mt][0] = fmaf(s.x, y[0], acc[i][mt][0]);  // column 2i, x row 2t
        acc[i][mt][1] = fmaf(s.x, y[1], acc[i][mt][1]);  // column 2i, x row 2t + 1
        acc[i][mt][2] = fmaf(s.y, y[2], acc[i][mt][2]);  // column 2i + 1, x row 2t
        acc[i][mt][3] = fmaf(s.y, y[3], acc[i][mt][3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free: the warps' sums take their place

  float* red = reinterpret_cast<float*>(smem);  // [WK][M][BN]
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int c2 = wc * GC + 2 * I * g + 2 * i, r = (wk * M + mt * 8 + 2 * t) * BN;
      red[r + c2] = acc[i][mt][0];
      red[r + BN + c2] = acc[i][mt][1];
      red[r + c2 + 1] = acc[i][mt][2];
      red[r + BN + c2 + 1] = acc[i][mt][3];
    }
  __syncthreads();
  const bool direct = gridDim.y == 1;
  for (int e = tid; e < m * BN; e += kThreads) {
    const int r = e / BN, c2 = e % BN, col = col0 + c2;
    float v = red[r * BN + c2];
#pragma unroll
    for (int j = 1; j < WK; ++j) v += red[(j * M + r) * BN + c2];
    if (col >= n) continue;
    if (direct)
      store_out(out, (size_t)r * n + col, v, out_f32);
    else
      partial[((size_t)blockIdx.y * m + r) * n + col] = v;
  }
  if (direct) return;
  __threadfence();  // this thread's partials are visible before the count
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[blockIdx.x], 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < m * BN; e += kThreads) {
    const int r = e / BN, col = col0 + e % BN;
    if (col >= n) continue;
    const size_t i = (size_t)r * n + col, mn = (size_t)m * n;
    float v[kMaxSplits];  // every split's partial in flight at once
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      v[s] = s < (int)gridDim.y ? __ldcg(partial + s * mn + i) : 0.f;
    float sum = v[0];
#pragma unroll
    for (int s = 1; s < kMaxSplits; ++s)
      if (s < (int)gridDim.y) sum += v[s];
    store_out(out, i, sum, out_f32);
  }
  if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

template <class Codes, int I, int WC, int MT>
int launch_decode(const void* x, const void* w, const void* scales, void* partial,
                  void* counters, void* out, int out_f32, int m, int k, int n, int splits,
                  int kb_per_split, int vec, cudaStream_t st) {
  using S = DecodeShape<Codes, I, WC, MT>;
  if (splits < 1 || splits > kMaxSplits) return -1;
  const auto kernel = decode_kernel<Codes, I, WC, MT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((n + S::BN - 1) / S::BN, splits);
  kernel<<<grid, kThreads, S::SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const __half*>(scales), static_cast<float*>(partial),
      static_cast<int*>(counters), out, out_f32, m, k, n, kb_per_split, vec);
  return 0;
}

template <class Codes, int MT>
int launch_decode_cols(const void* x, const void* w, const void* scales, void* partial,
                       void* counters, void* out, int out_f32, int m, int k, int n,
                       int splits, int kb_per_split, int cols, int vec, cudaStream_t st) {
#define DLLAMA_DECODE(I, WC)                                                              \
  return launch_decode<Codes, I, WC, MT>(x, w, scales, partial, counters, out, out_f32, m, \
                                         k, n, splits, kb_per_split, vec, st)
  switch (cols) {
    case 32:
      DLLAMA_DECODE(2, 1);
    case 64:
      DLLAMA_DECODE(4, 1);
    case 128:
      DLLAMA_DECODE(8, 1);
  }
  if constexpr (Codes::kWideTiles) {
    switch (cols) {
      case 256:
        DLLAMA_DECODE(8, 2);
      case 512:
        DLLAMA_DECODE(8, 4);
    }
  }
#undef DLLAMA_DECODE
  return -1;  // a column tile the library was not built for
}

// The C entry of both sources: x bf16 [m, k] (m <= 16, 16-byte aligned, k %
// 32 == 0); w the codes of one layer; scales f16 [k/32, n]; out [m, n] in
// bf16 (out_f32 == 0) or f32; partial f32 [splits, m, n] and counters i32
// [ceil(n / cols)], all 0, are scratch, unused when splits == 1; each of at
// most kMaxSplits splits walks kb_per_split 32-row blocks; cols is the
// block's column tile.
// Returns the CUDA error state after the launch (0 = success; -1 = a column
// tile not built, or more than kMaxSplits splits).
template <class Codes>
int decode(const void* x, const void* w, const void* scales, void* partial, void* counters,
           void* out, int m, int k, int n, int splits, int kb_per_split, int out_f32, int cols,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  const int bad = m > 8 ? launch_decode_cols<Codes, 2>(x, w, scales, partial, counters, out,
                                                       out_f32, m, k, n, splits, kb_per_split,
                                                       cols, vec, st)
                        : launch_decode_cols<Codes, 1>(x, w, scales, partial, counters, out,
                                                       out_f32, m, k, n, splits, kb_per_split,
                                                       cols, vec, st);
  return bad ? bad : (int)cudaGetLastError();
}

}  // namespace
