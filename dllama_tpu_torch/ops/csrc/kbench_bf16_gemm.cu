// The kernel benchmark's bf16-weight reference product (variant D of
// dllama_tpu_torch/experiments/kbench.py): out[m, n] = x[m, k] @ W[k, n]
// with bf16 x and a bf16 (already dequantized) W, f32 accumulation and an
// f32 result, for any m.
//
// Replaces experiments/kbench.py:_kernel_d (called through make_call), the
// TPU benchmark's roofline reference for unquantized weights: a plain dot.
//
// What bounds it on this card: device-memory bytes, 2 a weight (3.6x a Q40
// weight's): at m = 256 a call does 2*m*k*n operations against 2*k*n weight
// bytes, 256 a byte, still under the ~295 at which the bf16 tensor cores
// become the limit, so both routes are built to keep the weight streaming.
//
// What the design does: two routes, split at m <= 16 as K1 against K2
// (the wrapper picks the route; `route` says which).
//  * m <= 16 (route 0): the decode body (decode.cuh) over Bf16Weights: each
//    warp streams its own run of k through its own cp.async ring (4 slots of
//    32 rows x 32 or 64 columns, so 2 blocks fit an SM's shared memory),
//    ldmatrix.trans turns W's rows into A fragments with no unpack and no
//    scale, x rows are B, and the products go straight into the f32
//    accumulators; split-k boundaries follow k alone
//    (experiments/kbench.bf16_decode_geometry) and the splits are summed in
//    split order inside the one launch.
//  * m > 16 (route 1): K2's wgmma loop (prefill.cuh) over Bf16Tiles: there
//    is nothing to dequantize, so TMA writes each weight tile straight into
//    the 128-byte-swizzled MN-major B layout that wgmma reads with its
//    transpose bit (two 64 x 64 boxes a 128-column tile), through a ring as
//    deep as shared memory allows (4 stages at 256 rows a block, 7 at 128);
//    one wgmma group stays in flight while the next is issued, and 256-row
//    blocks at m >= 256 read each weight tile once.
#include "decode.cuh"
#include "prefill.cuh"

// x bf16 [m, k] and w bf16 [k, n], 16-byte aligned, k % 8 == 0 and n % 8 ==
// 0; out f32 [m, n]. Route 0 (m <= 16): the decode body with partial,
// counters, splits, kb_per_split and cols as decode() in decode.cuh takes
// them; route 1: the wgmma loop, one launch (no split). Returns the CUDA
// error state after the launch (0 = success; -1 = a column tile not built;
// -2 = a tensor map could not be made).
extern "C" int kbench_bf16_gemm(const void* x, const void* w, void* partial, void* counters,
                                void* out, int m, int k, int n, int splits, int kb_per_split,
                                int cols, int route, void* stream) {
  if (route == 0)
    return decode<Bf16Weights, Blockdot>(x, w, nullptr, partial, counters, out, m, k, n, splits,
                                         kb_per_split, 1, cols, stream);
  using namespace prefill;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return run<Bf16Tiles, __nv_bfloat16, float>(x, w, nullptr, nullptr, out, m, k, n, 1,
                                              (k + BK - 1) / BK, st);
}
