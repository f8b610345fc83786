// Causal GQA flash attention over the dense KV cache, for Hopper.
//
// Replaces dllama_tpu/ops/pallas/flash_attention.py:_kernel (called by
// _flash_folded, wrapper flash_gqa_attention), the TPU's attention kernel.
//
// Semantics (those of dllama_tpu/ops/layers.gqa_attention): q[B, T, Hq, hd]
// against a cache [B, Hkv, S, hd]; query token t of sequence b sees cache
// slots s <= pos[b] + t. The GQA group is folded t-major into the query rows
// of one KV head (row R = t * group + g holds query head kv * group + g), so
// one sweep over a KV tile serves the whole group. As in the TPU kernel, q
// and K meet in f32 sums, the scores and the online softmax are f32, masked
// entries take -1e30, P meets V at f32's precision, and a row whose sum is 0
// divides by 1.
//
// The body is attention.cuh's (shared with the paged kernels K9/K8), over a
// contiguous cache through DenseRows: there the design is set out. The
// bf16 and f8 modes run attn_mma_kernel (tensor cores, a two-stage cp.async
// ring, split-KV over live 64-row tiles); the f32 mode runs attn_f32_kernel
// (CUDA cores, f32 products).
#include "attention.cuh"

// q [B, T, Hq, hd]; k, v [B, Hkv, S, hd]; dtype 0 = q and cache bf16, 1 =
// both f32, 2 = bf16 q over an e4m3 cache; out [B, T, Hq, hd] in q's dtype,
// or in f32 when out_f32; hd 64 or 128. pos_vec: i32 [B] on the device,
// or null to use pos_scalar for every sequence. o_part f32 [splits, B*Hkv,
// rows_pad, hd] and ml_part f32 [splits, B*Hkv, rows_pad, 2] are scratch,
// unused when splits == 1. Returns the CUDA error state after the launches
// (0 = success; -1 = unsupported dtype/hd).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               void* o_part, void* ml_part, const void* pos_vec,
                               int pos_scalar, int B, int T_, int Hq, int Hkv, int S,
                               int hd, int dtype, int out_f32, int splits,
                               int tiles_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DLLAMA_FLASH(T, TC, TO, HD)                                                          \
  launch_attention<T, TC, TO, HD>(q, k, v, DenseRows<HD>{S}, out, o_part, ml_part, pos_vec,   \
                                  pos_scalar, B, T_, Hq, Hkv, S, splits, tiles_per_split, st)
  if (dtype == 0 && !out_f32 && hd == 128) return DLLAMA_FLASH(bf16, bf16, bf16, 128);
  if (dtype == 0 && !out_f32 && hd == 64) return DLLAMA_FLASH(bf16, bf16, bf16, 64);
  if (dtype == 0 && out_f32 && hd == 128) return DLLAMA_FLASH(bf16, bf16, float, 128);
  if (dtype == 0 && out_f32 && hd == 64) return DLLAMA_FLASH(bf16, bf16, float, 64);
  if (dtype == 1 && hd == 128) return DLLAMA_FLASH(float, float, float, 128);
  if (dtype == 1 && hd == 64) return DLLAMA_FLASH(float, float, float, 64);
  if (dtype == 2 && !out_f32 && hd == 128) return DLLAMA_FLASH(bf16, f8, bf16, 128);
  if (dtype == 2 && !out_f32 && hd == 64) return DLLAMA_FLASH(bf16, f8, bf16, 64);
  if (dtype == 2 && out_f32 && hd == 128) return DLLAMA_FLASH(bf16, f8, float, 128);
  if (dtype == 2 && out_f32 && hd == 64) return DLLAMA_FLASH(bf16, f8, float, 64);
#undef DLLAMA_FLASH
  return -1;
}
