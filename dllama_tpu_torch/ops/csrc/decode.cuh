// Decode body shared by q40_decode.cu (K1), q80_decode.cu (K5),
// q40_maskdot.cu (K3), q40_loopdot.cu (K4) and the decode routes of the
// kernel benchmark's kbench_fma_f32.cu (K11-B) and kbench_bf16_gemm.cu
// (K11-D): the product out[m, n] = x[m, k] @ W[k, n] for m <= 16, W a
// block-quantized weight (32-row blocks of k, one scale per block and
// column) or plain bf16. Included by those sources, never built alone.
// Three template parameters: a code-format policy (Q40Codes, Q80Codes;
// Q40CodesF32 with f32 scales; Bf16Weights, no codes and no scales) says
// how a block's weights are stored and how a thread turns its bytes into
// tensor-core fragments; a walk (Blockdot, Loopdot) says how a split's
// blocks of k are dealt to the warps, and so the order of the sums; the type
// of x (bf16, or f32 split exactly into three bf16 terms, each its own B
// fragment against the same A).
//
// Semantics (the TPU blockdot's, dllama_tpu/ops/pallas/q40_matmul.py and
// q80_matmul.py _blockdot_kernel, and of its maskdot and loopdot forms): per
// 32-row block b of k, the exact integer codes meet x in a partial dot y_b =
// x_b . codes_b, and the f16 scale, widened exactly to f32, multiplies that
// partial: out = sum_b s_b * y_b in f32.
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
//    weight not 16-byte aligned), the threads copy bytes into the same slots
//    (1-byte formats; bf16 rows of n % 8 == 0 columns always take 16-byte
//    pieces, and a launch that cannot is refused).
//  * Bf16Weights (K11-D): a stored row is one dim of k, 2 bytes a column
//    (3.6x a Q40 weight's bytes), so a block's ring holds fewer columns (32
//    or 64 a warp, two blocks an SM); ldmatrix.trans reads W's rows straight into A fragments (a
//    column of W is an A row, the columns in order), no unpack and no scale,
//    and the products go straight into the accumulators. k need only be a
//    multiple of 8: copies past k are zero-filled.
//  * Q40CodesF32 (K11-B): Q40's codes with f32 scales, read as they are.
//    With an f32 x, each x value is split into three bf16 terms whose sum is
//    the value exactly (for |x| >= 2^-110), three B fragments against one A:
//    every product is exact and y_b is the block's f32 dot.
//
// The walks (a walk changes the order of the f32 sums, never the function):
//  * Blockdot (K1, K5, K3): warp wk takes blocks wk, wk + WK, ... of its
//    split, as above.
//  * Loopdot (K4; the TPU kernel adds its blocks' scaled partials one plain
//    dot after another, in ascending k): warp wk of a block walks the wk-th
//    of WK equal runs of its split, in ascending k, so a column's sum is the
//    runs' ascending sums added in k order. Its wrapper's split boundaries
//    follow k alone (ops/q40_matmul.loopdot_geometry), and every column tile
//    it takes has the same WK, so that order does too: the same bits
//    whatever n, m, the column tile or the card's SM count.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;                 // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxM = 16;                 // rows of x a call takes
constexpr int kMinCols = 32;              // columns of a warp: 16 I, I = 2, 4 or 8
constexpr int kMaxCols = 128;
constexpr int kMaxSplits = 8;             // splits of a launch (the partials read at once)
constexpr int kRowPad = 16;               // bytes after each staged weight row
constexpr int kXLd = 40;                  // x values of a staged row of one block (80 B in bf16)

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

// Four 8 x 8 b16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 and receives, of matrix j, the word
// holding its column l / 4 at rows 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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
  static constexpr bool kTile128 = true;    // 128 columns a warp
  static constexpr bool kRaggedK = false;   // k % 32 == 0
  static constexpr int kColBytes = 1;       // bytes of a column in a stored row
  static constexpr bool kLdmatrix = false;  // Frag::load(its bytes, ld, t), not (slot, ld, lane)
  using Scale = __half;                     // one a block and column

  // the warp's column of A row g + 8 h of n16 tile i: a thread's 2 I columns
  // are contiguous
  __device__ static constexpr int col(int I, int i, int g, int h) { return 2 * I * g + 2 * i + h; }

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
  static constexpr bool kTile128 = true;
  static constexpr bool kRaggedK = false;
  static constexpr int kColBytes = 1;
  static constexpr bool kLdmatrix = false;
  using Scale = __half;

  __device__ static constexpr int col(int I, int i, int g, int h) { return 2 * I * g + 2 * i + h; }

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

// Q40 codes with f32 scales (K11-B): Q40Codes' rows and fragments.
struct Q40CodesF32 : Q40Codes {
  static constexpr bool kWideTiles = false;
  using Scale = float;
};

// Plain bf16 weights [k, n] (K11-D): a stored row is one dim of k, 2 bytes a
// column; A fragments straight from shared memory by ldmatrix.trans (matrix
// j of n16 tile i, k16 step s: dims 16 s + 8 (j / 2) + 0..7 of columns 16 i +
// 8 (j % 2) + 0..7), so A row g + 8 h is column 16 i + 8 h + g.
struct Bf16Weights {
  static constexpr int kRows = 32;
  static constexpr int kStages = 4;
  static constexpr bool kWideTiles = false;
  static constexpr bool kTile128 = false;  // 64 columns a warp at most: 2 bytes a weight
  static constexpr bool kRaggedK = true;   // k % 8 == 0
  static constexpr int kColBytes = 2;
  static constexpr bool kLdmatrix = true;
  using Scale = void;

  __device__ static constexpr int col(int I, int i, int g, int h) { return 16 * i + 8 * h + g; }

  template <int I>
  struct Frag {
    uint32_t row;  // shared address of this lane's matrix row in tile 0, step 0
    int ld;

    __device__ __forceinline__ void load(const uint8_t* slot, int ld_, int lane) {
      ld = ld_;
      row = static_cast<uint32_t>(__cvta_generic_to_shared(slot)) +
            ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 16;
    }

    __device__ __forceinline__ void tile(int i, uint32_t a[2][4]) const {
#pragma unroll
      for (int s = 0; s < 2; ++s) ldsm_x4_trans(a[s], row + 16 * s * ld + 32 * i);
    }
  };
};

template <class Codes>
__host__ __device__ constexpr int scale_bytes() {
  if constexpr (std::is_void_v<typename Codes::Scale>)
    return 0;
  else
    return sizeof(typename Codes::Scale);
}

// The walks (see the head of this file): whether a warp walks a contiguous
// run of its split, or every WK-th block of it.
struct Blockdot {
  static constexpr bool kRuns = false;
};
struct Loopdot {
  static constexpr bool kRuns = true;
};

// The shape of one instantiation: I n16 tiles a warp (16 I columns), WC
// column groups a block, MT n8 tiles of x rows (M = 8 MT), x of type TX. Each warp owns a
// ring of kStages slots in shared memory, a slot one 32-row block of its
// columns: weight rows, scales and x rows.
template <class Codes, int I, int WC, int MT, typename TX>
struct DecodeShape {
  static constexpr int M = 8 * MT;
  static constexpr int WK = kWarps / WC;       // warps along k
  static constexpr int GC = 16 * I;            // columns of a warp
  static constexpr int BN = GC * WC;           // columns of a block
  static constexpr int LDW = GC * Codes::kColBytes + kRowPad;  // bytes of a staged weight row
  static constexpr int W_BYTES = Codes::kRows * LDW;
  static constexpr int S_BYTES = GC * scale_bytes<Codes>();
  static constexpr int X_BYTES = M * kXLd * (int)sizeof(TX);
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

template <class Codes, class Walk, int I, int WC, int MT, typename TX>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 3 : 2) decode_kernel(
    const TX* __restrict__ x, const uint8_t* __restrict__ w, const void* __restrict__ scales,
    float* __restrict__ partial, int* __restrict__ counters, void* __restrict__ out, int out_f32,
    int m, int k, int n, int kb_per_split, int vec) {
  using S = DecodeShape<Codes, I, WC, MT, TX>;
  constexpr int M = S::M, WK = S::WK, GC = S::GC, BN = S::BN, LDW = S::LDW;
  constexpr int ROWS = Codes::kRows, NS = Codes::kStages;
  constexpr int CB = Codes::kColBytes, SB = scale_bytes<Codes>();
  constexpr bool kScaled = SB > 0;
  constexpr int XE = sizeof(TX), XT = XE == 4 ? 3 : 1;  // bytes of an x value, its bf16 terms
  constexpr int XPR = kXLd * XE / 16;  // 16-byte pieces of a staged x row
  constexpr int XP = 32 * XE / 16;     // ... of one block's x row
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wc = warp % WC, wk = warp / WC;
  const int col0 = blockIdx.x * BN, wcol = col0 + wc * GC;  // the block's, the warp's
  // this warp's first block of k, the end of its walk, and the step between
  // two of its blocks: every WK-th block of the split, or the wk-th run
  constexpr int KS = Walk::kRuns ? 1 : WK;
  const int nkb = Codes::kRaggedK ? ceil_div(k, 32) : k / 32;
  const int split0 = blockIdx.y * kb_per_split, end = min(nkb, split0 + kb_per_split);
  const int run = Walk::kRuns ? ceil_div(kb_per_split, WK) : 1;
  const int kb0 = split0 + wk * run;
  const int kb1 = Walk::kRuns ? min(end, kb0 + run) : end;
  const int blocks = kb0 < kb1 ? (kb1 - kb0 + KS - 1) / KS : 0;  // this warp walks
  uint8_t* ring = smem + warp * S::RING;

  // x rows m..M-1 stay zero: the copies write only rows < m (XPR pieces of
  // 16 bytes a staged row)
  for (int i = lane; i < NS * M * XPR; i += 32)
    if ((i / XPR) % M >= m)
      *reinterpret_cast<uint4*>(ring + (i / (M * XPR)) * S::SLOT + S::W_BYTES + S::S_BYTES +
                                ((i / XPR) % M) * kXLd * XE + (i % XPR) * 16) =
          make_uint4(0u, 0u, 0u, 0u);

  // Copy sources: lane l takes 16-byte piece l + 32 it of a block's weight
  // rows (row l / WCH + it * 32 / WCH, piece l % WCH), scales piece l (l <
  // SCH) and x piece l + 32 it (row l / XP + it * 32 / XP, piece l % XP);
  // each pointer moves by KS blocks of k a step.
  constexpr int WCH = GC * CB / 16, WROWS = 32 / WCH;  // pieces a weight row, rows a pass
  constexpr int SCH = GC * SB / 16;                     // pieces of a block's scales
  constexpr int XROWS = 32 / XP;                        // x rows a pass
  const int wr = lane / WCH, wch = lane % WCH;
  const size_t wrow = (size_t)n * CB;  // bytes of a weight row
  // n * CB % 16 == 0: a piece is all in or all out
  const bool w_in = wcol + wch * 16 / CB < n;
  const bool s_in = kScaled && lane < SCH && wcol + lane * 16 / (kScaled ? SB : 1) < n;
  const size_t wstep = (size_t)KS * ROWS * wrow, wpass = (size_t)WROWS * wrow;
  const uint8_t* wsrc = w + ((size_t)kb0 * ROWS + wr) * wrow + wcol * CB + wch * 16;
  using Sc = std::conditional_t<kScaled, typename Codes::Scale, uint8_t>;
  const Sc* sg = static_cast<const Sc*>(scales);
  const Sc* ssrc = sg + (size_t)kb0 * n + wcol + lane * (16 / (int)sizeof(Sc));
  const TX* xsrc = x + (size_t)(lane / XP) * k + kb0 * 32 + (lane % XP) * (16 / XE);
  const int wdst = wr * LDW + wch * 16;
  const int xdst = S::W_BYTES + S::S_BYTES + ((lane / XP) * kXLd + (lane % XP) * (16 / XE)) * XE;

  // this warp's j-th block of k (kb0 + j KS) into slot j % NS; one commit
  // group a block, empty past the last
  auto fill = [&](int j) {
    if (j < blocks) {
      uint8_t* slot = ring + (j % NS) * S::SLOT;
      const size_t kb = kb0 + j * KS;
      if (vec) {
        const uint8_t* src = wsrc + j * wstep;
#pragma unroll
        for (int it = 0; it < ceil_div(ROWS * WCH, 32); ++it) {
          const bool in = w_in && (!Codes::kRaggedK || (int)kb * 32 + wr + it * WROWS < k);
          cp_async16(slot + wdst + it * WROWS * LDW, in ? src + it * wpass : w, in ? 16 : 0);
        }
        if constexpr (kScaled)
          if (lane < SCH)
            cp_async16(slot + S::W_BYTES + lane * 16, s_in ? ssrc + j * (size_t)KS * n : sg,
                       s_in ? 16 : 0);
      } else if constexpr (CB == 1) {  // rows 16-byte copies cannot describe: bytes, zero past n
        for (int i = lane; i < ROWS * GC; i += 32) {
          const int r = i / GC, c2 = i % GC, col = wcol + c2;
          slot[r * LDW + c2] = col < n ? w[(kb * ROWS + r) * n + col] : (uint8_t)0;
        }
        if constexpr (kScaled) {
          Sc* ss = reinterpret_cast<Sc*>(slot + S::W_BYTES);
          for (int c2 = lane; c2 < GC; c2 += 32)
            ss[c2] = wcol + c2 < n ? sg[kb * n + wcol + c2] : static_cast<Sc>(0.f);
        }
      }
#pragma unroll
      for (int it = 0; it < ceil_div(M * XP, 32); ++it)  // x: XP pieces a row
        if (lane / XP + XROWS * it < m) {
          const bool in = !Codes::kRaggedK || (int)kb * 32 + (lane % XP) * (16 / XE) < k;
          cp_async16(slot + xdst + it * XROWS * kXLd * XE,
                     in ? xsrc + j * KS * 32 + (size_t)it * XROWS * k : x, in ? 16 : 0);
        }
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
    const uint8_t* xs = slot + S::W_BYTES + S::S_BYTES;
    uint32_t b[MT][2][XT][2];  // B fragments: x rows g (+ 8 mt), dims 16s + 2t (+ 8)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const TX* xr = reinterpret_cast<const TX*>(xs) + (mt * 8 + g) * kXLd + 16 * s + 2 * t;
        if constexpr (XT == 1) {
          b[mt][s][0][0] = *reinterpret_cast<const uint32_t*>(xr);
          b[mt][s][0][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
        } else {
          uint32_t lo[3], hi[3];
          split_bf16x3(*reinterpret_cast<const float2*>(xr), lo);
          split_bf16x3(*reinterpret_cast<const float2*>(xr + 8), hi);
#pragma unroll
          for (int xt = 0; xt < XT; ++xt) {
            b[mt][s][xt][0] = lo[xt];
            b[mt][s][xt][1] = hi[xt];
          }
        }
      }
    // scales of columns 2i, 2i+1 of this thread's 2I: half2 a word (f16), or
    // a word each (f32)
    uint32_t sw[kScaled ? I * SB / 2 : 1];
    if constexpr (kScaled) lds<kScaled ? 2 * I * SB : 4>(sw, slot + S::W_BYTES + 2 * I * g * SB);
    typename Codes::template Frag<I> f;
    if constexpr (Codes::kLdmatrix)
      f.load(slot, LDW, lane);
    else
      f.load(slot + 2 * I * g, LDW, t);
#pragma unroll
    for (int i = 0; i < I; ++i) {
      uint32_t a[2][4];
      f.tile(i, a);
      if constexpr (kScaled) {
        float2 s;
        if constexpr (SB == 2)
          s = __half22float2(*reinterpret_cast<const __half2*>(&sw[i]));
        else
          s = make_float2(__uint_as_float(sw[2 * i]), __uint_as_float(sw[2 * i + 1]));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int xt = 0; xt < XT; ++xt) {
            mma_bf16(y, a[0], b[mt][0][xt][0], b[mt][0][xt][1]);
            mma_bf16(y, a[1], b[mt][1][xt][0], b[mt][1][xt][1]);
          }
          acc[i][mt][0] = fmaf(s.x, y[0], acc[i][mt][0]);  // column 2i, x row 2t
          acc[i][mt][1] = fmaf(s.x, y[1], acc[i][mt][1]);  // column 2i, x row 2t + 1
          acc[i][mt][2] = fmaf(s.y, y[2], acc[i][mt][2]);  // column 2i + 1, x row 2t
          acc[i][mt][3] = fmaf(s.y, y[3], acc[i][mt][3]);
        }
      } else {  // no scale: the products go straight into the sums
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int xt = 0; xt < XT; ++xt) {
            mma_bf16(acc[i][mt], a[0], b[mt][0][xt][0], b[mt][0][xt][1]);
            mma_bf16(acc[i][mt], a[1], b[mt][1][xt][0], b[mt][1][xt][1]);
          }
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
      const int c0 = wc * GC + Codes::col(I, i, g, 0), c1 = wc * GC + Codes::col(I, i, g, 1);
      const int r = (wk * M + mt * 8 + 2 * t) * BN;
      red[r + c0] = acc[i][mt][0];
      red[r + BN + c0] = acc[i][mt][1];
      red[r + c1] = acc[i][mt][2];
      red[r + BN + c1] = acc[i][mt][3];
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

template <class Codes, class Walk, int I, int WC, int MT, typename TX>
int launch_decode(const void* x, const void* w, const void* scales, void* partial,
                  void* counters, void* out, int out_f32, int m, int k, int n, int splits,
                  int kb_per_split, int vec, cudaStream_t st) {
  using S = DecodeShape<Codes, I, WC, MT, TX>;
  if (splits < 1 || splits > kMaxSplits) return -1;
  const auto kernel = decode_kernel<Codes, Walk, I, WC, MT, TX>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((n + S::BN - 1) / S::BN, splits);
  kernel<<<grid, kThreads, S::SMEM, st>>>(
      static_cast<const TX*>(x), static_cast<const uint8_t*>(w), scales,
      static_cast<float*>(partial), static_cast<int*>(counters), out, out_f32, m, k, n,
      kb_per_split, vec);
  return 0;
}

template <class Codes, class Walk, int MT, typename TX>
int launch_decode_cols(const void* x, const void* w, const void* scales, void* partial,
                       void* counters, void* out, int out_f32, int m, int k, int n,
                       int splits, int kb_per_split, int cols, int vec, cudaStream_t st) {
#define DLLAMA_DECODE(I, WC)                                                                  \
  return launch_decode<Codes, Walk, I, WC, MT, TX>(x, w, scales, partial, counters, out,      \
                                                   out_f32, m, k, n, splits, kb_per_split, vec, \
                                                   st)
  switch (cols) {
    case 32:
      DLLAMA_DECODE(2, 1);
    case 64:
      DLLAMA_DECODE(4, 1);
  }
  // 128 columns a warp: not for 2-byte weights (the ring) nor an f32 x (the
  // registers of its three terms)
  if constexpr (Codes::kTile128 && sizeof(TX) == 2) {
    switch (cols) {
      case 128:
        DLLAMA_DECODE(8, 1);
    }
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

// The C entry of the sources: x [m, k] in TX (bf16, or f32; m <= 16,
// 16-byte aligned, k % 32 == 0, or k % 8 == 0 for Bf16Weights); w the
// weights of one layer; scales [k/32, n] of the policy's Scale (f16, f32;
// unused for Bf16Weights); out [m, n] in bf16 (out_f32 == 0) or f32;
// partial f32 [splits, m, n] and counters i32 [ceil(n / cols)], all 0, are
// scratch, unused when splits == 1; each of at most kMaxSplits splits walks
// kb_per_split 32-row blocks; cols is the block's column tile.
// Returns the CUDA error state after the launch (0 = success; -1 = a column
// tile not built, or more than kMaxSplits splits).
template <class Codes, class Walk, typename TX = bf16>
int decode(const void* x, const void* w, const void* scales, void* partial, void* counters,
           void* out, int m, int k, int n, int splits, int kb_per_split, int out_f32, int cols,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = n * Codes::kColBytes % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  if (Codes::kColBytes > 1 && !vec) return -1;  // 2-byte rows go in 16-byte pieces only
  const int bad =
      m > 8 ? launch_decode_cols<Codes, Walk, 2, TX>(x, w, scales, partial, counters, out,
                                                      out_f32, m, k, n, splits, kb_per_split,
                                                      cols, vec, st)
            : launch_decode_cols<Codes, Walk, 1, TX>(x, w, scales, partial, counters, out,
                                                      out_f32, m, k, n, splits, kb_per_split,
                                                      cols, vec, st);
  return bad ? bad : (int)cudaGetLastError();
}

}  // namespace
