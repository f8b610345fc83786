// Q40 decode product in one sum order that follows k alone: out[m, n] =
// x[m, k] @ W[k, n], m <= 16. The `loopdot` style of the ops wrapper
// (STYLE = "loopdot").
//
// Replaces dllama_tpu/ops/pallas/q40_matmul.py:_loopdot_kernel (called by
// _loopdot_call). On the TPU that kernel is the most lowering-conservative
// form of blockdot's math: per grid step, tk/32 plain [m, 32] x [32, tn]
// dots of exact codes on the matrix unit, each scaled by its block's f32
// scale and added to the sum in ascending k. What sets it apart is that
// order, and it is what this kernel keeps: each split of k is walked as
// four runs, one a warp, each in ascending k, and the runs' sums meet in k
// order; the split boundaries follow k alone (ops/q40_matmul.loopdot_geometry),
// so a column's sum has one order whatever n, m, the column tile or the SM
// count.
//
// The body is decode.cuh's (shared with K1, K5 and K3) over the Q40 policy and
// the Loopdot walk: there the design is set out. What bounds it on this
// card is device-memory bytes (0.5625 a weight); the body streams them
// through a cp.async ring a warp into tensor-core products (codes in A, x
// rows in B) and sums the splits in split order inside the one launch.
#include "decode.cuh"

// x bf16 [m, k]; packed u8 [k/2, n]; scales f16 [k/32, n]; the rest as
// decode() in decode.cuh.
extern "C" int q40_loopdot(const void* x, const void* packed, const void* scales,
                           void* partial, void* counters, void* out, int m, int k, int n,
                           int splits, int kb_per_split, int out_f32, int cols, void* stream) {
  return decode<Q40Codes, Loopdot>(x, packed, scales, partial, counters, out, m, k, n, splits,
                                   kb_per_split, out_f32, cols, stream);
}
