// The kernel benchmark's f32-FMA Q40 product (variant B of
// dllama_tpu_torch/experiments/kbench.py): out[m, n] = x[m, k] @ W[k, n] in
// f32 for any m, with W the dequantized w = f * s - 8 * s of the unsigned
// nibble f and an f32 scale s, and x in bf16 or f32.
//
// Replaces experiments/kbench.py:_kernel_b (called through make_call), the
// TPU benchmark's f32 variant: codes widened to f32, the dequant as one
// multiply and one subtract per weight, an f32 dot with no bf16 rounding.
//
// What bounds it on this card: device-memory bytes at decode row counts
// (k*n/2 nibbles and k*n/8 bytes of f32 scales), tensor-core operations
// once m is large. The products need no f32 unit: a bf16 x times an exact
// code q - 8 is exact in f32, and an f32 x is three bf16 terms whose sum is
// x exactly, so the bf16 tensor cores compute this f32 function, only the
// order of the f32 sums differing (the bound is the bf16 rate's).
//
// What the design does: two routes, split at m <= 16 as K1 against K2
// (the wrapper picks the route; `route` says which).
//  * m <= 16 (route 0): the decode body (decode.cuh) over Q40CodesF32, Q40's
//    exact codes in A with the f32 scales read as they are, in K1's
//    geometry (ops/q40_matmul.decode_geometry): per 32-row block y_b = x_b .
//    codes_b on the tensor cores, then out = sum_b s_b y_b in f32, split-k
//    summed in split order inside the one launch. An f32 x enters as three
//    B fragments against the same A (64 columns a warp at most).
//  * m > 16 (route 1): K2's wgmma loop (prefill.cuh) over Q40SplitF32: the
//    raw tile (nibbles and f32 scales) through a TMA ring, each weight w =
//    (q - 8) s in f32 written as two bf16 B tiles w_hi + w_lo (exact for
//    f16 scales widened to f32, as the benchmark's are), two wgmma into one
//    accumulator set a k16 step, 256-row blocks at m >= 256. An f32 x is
//    split by the threads into three bf16 A tiles (128-row blocks).
#include "decode.cuh"
#include "prefill.cuh"

// x [m, k] in bf16 (x_f32 == 0) or f32, 16-byte aligned, k % 32 == 0;
// packed u8 [k/2, n]; scales f32 [k/32, n]; out f32 [m, n]. Route 0 (m <=
// 16): the decode body with partial, counters, splits, kb_per_split and cols
// as decode() in decode.cuh takes them; route 1: the wgmma loop, one launch
// (no split). Returns the CUDA error state after the launch (0 = success;
// -1 = a column tile not built; -2 = a tensor map could not be made).
extern "C" int kbench_fma_f32(const void* x, const void* packed, const void* scales,
                              void* partial, void* counters, void* out, int m, int k, int n,
                              int splits, int kb_per_split, int cols, int x_f32, int route,
                              void* stream) {
  if (route == 0)
    return x_f32 ? decode<Q40CodesF32, Blockdot, float>(x, packed, scales, partial, counters, out,
                                                         m, k, n, splits, kb_per_split, 1, cols,
                                                         stream)
                 : decode<Q40CodesF32, Blockdot>(x, packed, scales, partial, counters, out, m,
                                                 k, n, splits, kb_per_split, 1, cols, stream);
  using namespace prefill;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int steps = (k + BK - 1) / BK;
  return x_f32 ? run<Q40SplitF32, float, float>(x, packed, scales, nullptr, out, m, k, n, 1,
                                                steps, st)
               : run<Q40SplitF32, __nv_bfloat16, float>(x, packed, scales, nullptr, out, m, k, n,
                                                        1, steps, st);
}
