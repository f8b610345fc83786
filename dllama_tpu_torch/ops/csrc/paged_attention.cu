// Paged attention over the KV page pool, for Hopper: the decode kernel with
// its fused KV scatter, and the same sweep read-only.
//
// Replaces dllama_tpu/ops/pallas/paged_attention.py:_kernel (K9, called by
// _paged_folded, wrapper paged_decode_attention) and, as its read-only mode,
// dllama_tpu/ops/pallas/flash_attention.py:_paged_kernel (K8, called by
// _flash_paged_folded, wrapper paged_flash_gqa_attention).
//
// Semantics (those of dllama_tpu/models/llama._paged_cache_update followed by
// dllama_tpu/ops/layers.paged_gqa_attention): q[B, T, Hq, hd] against pools
// [P, Hkv, page, hd] through block tables i32 [B, nb]; logical cache row r of
// slot b is pool[tables[b, r / page], :, r % page]; query token t of slot b
// sees rows r <= pos[b] + t. The GQA group is folded t-major into the query
// rows of one KV head (row R = t * group + g holds query head kv * group + g).
// With new rows, a first launch writes them to their targets (the addressing
// of ops.layers.paged_write_targets; inactive slots go to the trash page)
// before the sweep reads them.
//
// What bounds it on this card: at decode, device-memory bytes. A step reads
// 2 * Hkv * (pos + 1) * hd pool elements of each slot once per layer and does
// only group * hd * 4 operations per pair of elements. A 256-token prefill
// chunk does 4 * rows * keys * hd operations: tensor-core work.
//
// What the design does about it: the sweep is attention.cuh's body, the one
// K7 runs over a dense cache, with PagedRows in place of DenseRows: 64-row
// logical KV tiles gathered row by row through the slot's table in the
// cp.async issue (a tile may span pages of any size >= 8), Q.K^T and P.V on
// the tensor cores (mma.sync, P as bf16 hi + lo), f32 online softmax, live
// tiles only, split-KV with a fixed-order combine; f32 pools take its
// CUDA-core body. Further:
//  * No host read: each block reads pos[b] and its table entries itself,
//    and an entry past the slot's horizon is never read. The host fixes the
//    tiles per split from the table width (a split past a slot's horizon
//    exits at once), so a long slot gets many blocks and a short one few.
//  * Fused scatter: blocks of one (slot, head) run in no order, so the new
//    rows are written by a small kernel launched first on the same stream,
//    one block per (slot, head), rows in order t = 0..T-1; a row whose target
//    a later row of the batch (in (slot, t) order) also hits is skipped, so
//    the last row wins, as in the plain scatter, and no two blocks race. It
//    computes the targets from pos, the tables and the active flags itself,
//    and reads the new rows in the layer's own [B, T, Hkv, hd] layout: a
//    decode step's attention is three launches, no host-side index math.
#include "attention.cuh"

namespace {

// Where new row t of slot b goes (ops.layers.paged_write_targets, the plain
// scatter's addressing): logical row pos[b] + t at page tables[b, row / page]
// (the block clipped to the table), offset row % page; an inactive slot's
// rows go to the trash page n_pool - 1.
__device__ __forceinline__ void write_target(int i, int T_, const unsigned char* active,
                                             const int* tables, const int* pos, int page,
                                             int nb, int n_pool, int& pg, int& off) {
  const int b = i / T_, row = pos[b] + i % T_;
  off = row % page;
  pg = active && !active[b] ? n_pool - 1 : tables[(size_t)b * nb + min(row / page, nb - 1)];
}

// New rows nk/nv [B, T, Hkv, hd] -> the pools at their write targets. One
// block per (slot, kv head), rows in order; a row whose target a later row
// of the batch (in (slot, t) order) also hits is skipped: the last one wins.
template <typename T>
__global__ void scatter_kernel(T* __restrict__ kp, T* __restrict__ vp,
                               const T* __restrict__ nk, const T* __restrict__ nv,
                               const unsigned char* __restrict__ active,
                               const int* __restrict__ tables, const int* __restrict__ pos,
                               int B, int T_, int Hkv, int page, int nb, int n_pool, int HD) {
  const int b = blockIdx.x / Hkv, kv = blockIdx.x % Hkv;
  const int n = B * T_;
  for (int t = 0; t < T_; ++t) {
    const int i = b * T_ + t;
    int pg, off;
    write_target(i, T_, active, tables, pos, page, nb, n_pool, pg, off);
    bool later = false;  // the same for every thread of the block
    for (int j = i + 1; j < n && !later; ++j) {
      int pj, oj;
      write_target(j, T_, active, tables, pos, page, nb, n_pool, pj, oj);
      later = pj == pg && oj == off;
    }
    if (later) continue;
    const size_t dst = (((size_t)pg * Hkv + kv) * page + off) * HD;
    const size_t src = ((size_t)i * Hkv + kv) * HD;
    for (int d = threadIdx.x; d < HD; d += blockDim.x) {
      kp[dst + d] = nk[src + d];
      vp[dst + d] = nv[src + d];
    }
  }
}

template <typename T, typename TO, int HD>
int launch(const void* q, void* kp, void* vp, const void* nk, const void* nv,
           const void* active, const void* tables, const void* pos, void* out, void* o_part,
           void* ml_part, int B, int T_, int Hq, int Hkv, int page, int nb, int n_pool,
           int splits, int tiles_per_split, cudaStream_t st) {
  if (nk != nullptr) {
    scatter_kernel<T><<<B * Hkv, kThreads, 0, st>>>(
        static_cast<T*>(kp), static_cast<T*>(vp), static_cast<const T*>(nk),
        static_cast<const T*>(nv), static_cast<const unsigned char*>(active),
        static_cast<const int*>(tables), static_cast<const int*>(pos), B, T_, Hkv, page, nb,
        n_pool, HD);
  }
  const PagedRows<HD> rows{static_cast<const int*>(tables), nb, page};
  return launch_attention<T, T, TO, HD>(q, kp, vp, rows, out, o_part, ml_part, pos, 0, B, T_,
                                        Hq, Hkv, nb * page, splits, tiles_per_split, st);
}

}  // namespace

// q [B, T, Hq, hd]; pools k, v [P, Hkv, page, hd] of q's dtype (0 = bf16,
// 1 = f32), updated in place by the scatter; tables i32 [B, nb]; pos i32 [B];
// out [B, T, Hq, hd] in that dtype, or f32 when out_f32; hd 64 or 128;
// page >= 8 and a multiple of 8. With new_k non-null, new_k/new_v
// [B, T, Hkv, hd] (the pools' dtype) are first written at their targets,
// the rows of slots whose `active` byte is 0 (active null: all active) at
// the trash page n_pool - 1; with new_k null the sweep is read-only. Split
// z of each query tile walks 64-row tiles [z * tiles_per_split, (z + 1) *
// tiles_per_split) of the live ones. o_part f32 [splits, B*Hkv, rows_pad,
// hd] and ml_part f32 [splits, B*Hkv, rows_pad, 2] are scratch, unused when
// splits == 1. Returns the CUDA error state after the launches (0 =
// success; -1 = unsupported dtype/hd; -2 = bad page).
extern "C" int paged_attention(const void* q, void* k_pool, void* v_pool, const void* new_k,
                               const void* new_v, const void* active, const void* tables,
                               const void* pos, void* out, void* o_part, void* ml_part, int B,
                               int T_, int Hq, int Hkv, int page, int nb, int n_pool, int hd,
                               int dtype, int out_f32, int splits, int tiles_per_split,
                               void* stream) {
  if (page < 8 || page % 8) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DLLAMA_PAGED_ARGS                                                                   \
  q, k_pool, v_pool, new_k, new_v, active, tables, pos, out, o_part, ml_part, B, T_, Hq, Hkv, \
      page, nb, n_pool, splits, tiles_per_split, st
  if (dtype == 0 && !out_f32 && hd == 128) return launch<bf16, bf16, 128>(DLLAMA_PAGED_ARGS);
  if (dtype == 0 && !out_f32 && hd == 64) return launch<bf16, bf16, 64>(DLLAMA_PAGED_ARGS);
  if (dtype == 0 && out_f32 && hd == 128) return launch<bf16, float, 128>(DLLAMA_PAGED_ARGS);
  if (dtype == 0 && out_f32 && hd == 64) return launch<bf16, float, 64>(DLLAMA_PAGED_ARGS);
  if (dtype == 1 && hd == 128) return launch<float, float, 128>(DLLAMA_PAGED_ARGS);
  if (dtype == 1 && hd == 64) return launch<float, float, 64>(DLLAMA_PAGED_ARGS);
#undef DLLAMA_PAGED_ARGS
  return -1;
}
