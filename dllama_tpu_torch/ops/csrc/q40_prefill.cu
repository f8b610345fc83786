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
//
// The loop is prefill.cuh's (shared with the m > 16 routes of K11-B and
// K11-D) over its Q40Bf16 weight policy, with bf16 x.
#include "prefill.cuh"

// x bf16 [m, k] (16-byte aligned rows, k % 32 == 0); packed u8 [k/2, n];
// scales f16 [k/32, n]; out [m, n] in bf16 (out_f32 == 0) or f32; partial
// f32 [splits, m, n] for the split-k sums (unused when splits == 1), each
// split walking steps_per_split steps of 64 input dims; blocks of BM rows
// where m >= BM, else of BM_SMALL. Returns the CUDA error state after the
// launches (0 = success; -2 = a tensor map could not be made).
extern "C" int q40_prefill(const void* x, const void* packed, const void* scales,
                           void* partial, void* out, int m, int k, int n, int splits,
                           int steps_per_split, int out_f32, void* stream) {
  using namespace prefill;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? run<Q40Bf16, __nv_bfloat16, float>(x, packed, scales, partial, out, m, k, n,
                                                      splits, steps_per_split, st)
                 : run<Q40Bf16, __nv_bfloat16, __nv_bfloat16>(x, packed, scales, partial, out,
                                                              m, k, n, splits, steps_per_split,
                                                              st);
}
