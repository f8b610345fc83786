// Q80 decode product for Hopper: out[m, n] = x[m, k] @ W[k, n], m <= 16.
//
// Replaces dllama_tpu/ops/pallas/q80_matmul.py:_blockdot_kernel (called by
// _blockdot_call), the TPU's decode-shaped Q80 kernel: exact int8 codes (-128
// included), per 32-row block a partial dot scaled by the block's f16 scale
// in f32.
//
// The body is decode.cuh's (shared with K1, K3 and K4) over the Q80 policy
// and the Blockdot walk: there the design is set out. What bounds it on this
// card is device-memory bytes (1.0625 a weight); the body streams them
// through a cp.async ring into tensor-core products, with split-k summed in
// split order inside the one launch. The wrapper's split boundaries follow k alone and
// a column's sum order does not depend on its tile (32, 64 or 128 columns a
// block), so fused wqkv/w13 weights (--fuse-weights) give the bit-equal
// columns of their parts. A weight whose rows are not 16-byte
// aligned (n % 16 != 0) is copied byte by byte into the same ring.
#include "decode.cuh"

// x bf16 [m, k]; codes i8 [k, n]; scales f16 [k/32, n]; the rest as decode()
// in decode.cuh.
extern "C" int q80_decode(const void* x, const void* codes, const void* scales,
                          void* partial, void* counters, void* out, int m, int k, int n,
                          int splits, int kb_per_split, int out_f32, int cols, void* stream) {
  return decode<Q80Codes, Blockdot>(x, codes, scales, partial, counters, out, m, k, n, splits,
                                    kb_per_split, out_f32, cols, stream);
}
