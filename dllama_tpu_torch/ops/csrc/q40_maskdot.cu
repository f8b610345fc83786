// Q40 decode product with the rows of x padded in the tensor-core product:
// out[m, n] = x[m, k] @ W[k, n], m <= 16. The `maskdot` style of the ops
// wrapper (STYLE = "maskdot").
//
// Replaces dllama_tpu/ops/pallas/q40_matmul.py:_maskdot_kernel (called by
// _maskdot_call). On the TPU that kernel expresses blockdot's per-block
// partial dots as ONE plain dot of a block-masked activation matrix against
// the exact codes, accepting redundant multiply-adds. Here each block's
// partial is two mma.sync.m16n8k16 steps whose x operand is padded with zero
// rows to a whole n8 tile (7 of 8 rows at m = 1): the redundant products the
// card does at no cost, since the product is bound by the weight's bytes.
// Two orientations were timed on this body (on an H100, in one call): x rows
// in A, padded to 16 rows as the earlier form of this kernel did, and the
// codes in A with x rows in B. They gave the same bits (the same exact
// products, summed alike) and tied at m <= 8; codes in A was 12-18 % faster
// at m = 16 on the 8B shapes, where x in A widens four times the scales a
// block (a thread's C fragment spans two columns of its own) and holds ~30
// more registers a thread for the same products. So this kernel takes the
// codes in A, K1's orientation and geometry (ops/q40_matmul.decode_geometry),
// and gives K1's bits.
//
// The body is decode.cuh's (shared with K1, K5 and K4) over the Q40 policy and
// the Blockdot walk: there the design is set out. What bounds it on this card
// is device-memory bytes (0.5625 a weight, at most 32 operations a byte at m
// <= 16); the body streams them through a cp.async ring a warp and sums the
// splits in split order inside the one launch: no second pass.
#include "decode.cuh"

// x bf16 [m, k]; packed u8 [k/2, n]; scales f16 [k/32, n]; the rest as
// decode() in decode.cuh.
extern "C" int q40_maskdot(const void* x, const void* packed, const void* scales,
                           void* partial, void* counters, void* out, int m, int k, int n,
                           int splits, int kb_per_split, int out_f32, int cols, void* stream) {
  return decode<Q40Codes, Blockdot>(x, packed, scales, partial, counters, out, m, k, n, splits,
                                    kb_per_split, out_f32, cols, stream);
}
