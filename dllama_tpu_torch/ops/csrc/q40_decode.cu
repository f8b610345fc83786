// Q40 decode product for Hopper: out[m, n] = x[m, k] @ W[k, n], m <= 16.
//
// Replaces dllama_tpu/ops/pallas/q40_matmul.py:_blockdot_kernel (called by
// _blockdot_call), the TPU's decode-shaped Q40 kernel: exact codes q - 8,
// per 32-row block a partial dot scaled by the block's f16 scale in f32.
//
// The body is decode.cuh's (shared with K5, q80_decode.cu) over the Q40
// policy: there the design is set out. What bounds it on this card is
// device-memory bytes (0.5625 a weight); the body streams them through a
// cp.async ring into tensor-core products, with split-k summed in split
// order inside the one launch. Column tiles of 32, 64 and 128 columns a block
// (the wrapper's choice by n), and 256 and 512 for the BLOCKDOT_TN overrides
// (two or four warps side by side along n).
#include "decode.cuh"

// x bf16 [m, k]; packed u8 [k/2, n]; scales f16 [k/32, n]; the rest as
// decode() in decode.cuh.
extern "C" int q40_decode(const void* x, const void* packed, const void* scales,
                          void* partial, void* counters, void* out, int m, int k, int n,
                          int splits, int kb_per_split, int out_f32, int cols, void* stream) {
  return decode<Q40Codes>(x, packed, scales, partial, counters, out, m, k, n, splits,
                          kb_per_split, out_f32, cols, stream);
}
