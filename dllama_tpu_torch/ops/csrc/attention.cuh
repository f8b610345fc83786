// Causal GQA attention body shared by flash_attention.cu (K7, a dense cache)
// and paged_attention.cu (K9 and its read-only mode K8, a page pool read
// through block tables). Included by those sources, never built alone.
//
// Semantics (those of dllama_tpu/ops/layers.gqa_attention): q[B, T, Hq, hd]
// against a cache of S logical rows per (sequence, KV head); query token t
// of sequence b sees rows s <= pos[b] + t. The GQA group is folded t-major
// into the query rows of one KV head (row R = t * group + g holds query head
// kv * group + g), so one sweep over a KV tile serves the whole group. As in
// the TPU kernels, q and K meet in f32 sums, the scores and the online
// softmax are f32, masked entries take -1e30, P meets V at f32's precision,
// and a row whose sum is 0 divides by 1.
//
// Where a row lives is the only thing the two caches change. A Rows policy
// says it: DenseRows (row s of (b, kv) at ((b Hkv + kv) S + s) hd) and
// PagedRows (row s at pool[tables[b, s / page], kv, s % page]). A thread
// walks its rows of a tile with the policy's Walk, which for a page pool
// reads a table entry once per page it enters and never past the horizon
// (entries past a slot's rows may hold any page id).
//
// What bounds it on this card: at decode, device-memory bytes — each step
// reads 2 * Hkv * (pos + 1) * hd cache elements once per layer, with only
// group * hd * 4 operations per element pair. At a 256-token prefill chunk
// it does 4 * rows * keys * hd operations, which is tensor-core work.
//
// What the design does about it, for bf16 and e4m3 caches (attn_mma_kernel):
//  * Q.K^T and P.V run on the tensor cores, mma.sync.m16n8k16 with bf16
//    operands (fed by ldmatrix) and f32 accumulators. A product of two bf16
//    values is exact in f32, so Q.K^T differs from the plain version only in
//    the order of its sums. P is f32; it enters the tensor cores as
//    P_hi + P_lo, two bf16 values whose sum holds P to about 2^-17, and both
//    products go into the same f32 accumulator: one more MMA on the P.V half
//    of the work, and no bf16 rounding of P (a single bf16 P would be off by
//    up to 2^-9 of |v| on rows that see few keys).
//  * Tiles stay bf16 in shared memory (rows padded by 16 bytes, so the eight
//    rows an ldmatrix reads fall in eight different bank groups). Each warp
//    owns 16 query rows and keeps its Q fragments in registers; the online
//    softmax runs on the score fragments in registers, a row's max and sum
//    reduced across its quad by shuffles.
//  * KV tiles of 64 logical rows arrive through a two-stage cp.async ring:
//    the copy of the next tile is in flight while this one's products run.
//    Each 16-byte copy takes its row's address from the policy, so a tile
//    may span pages of any size >= 8 rows. Rows past the block's horizon are
//    zero-filled, not read. An e4m3 cache (the f8 KV cache) is copied raw
//    into the ring, half the bytes, and widened to bf16 in shared memory
//    before the products: e4m3's values are a subset of bf16's, so this is
//    exact and the f8 mode shares the bf16 mode's path.
//  * Only live KV tiles are read: a block walks 64-row tiles up to the
//    horizon of its last REAL query row (pad rows do not widen it), and a
//    warp skips the products of a tile past its own rows' horizon (a fully
//    masked tile leaves max, sum and output bit-for-bit as they were), so
//    decode cost follows pos, not S.
//  * Split-KV: split z of a (sequence, KV head, query tile) takes the live
//    tiles [z per, (z + 1) per) so that a decode step fills the card. A
//    block whose first tile is past its horizon exits at once; the others
//    keep their own online-softmax state (max, sum, unnormalized output) and
//    attn_combine merges each row's live splits in split order, counting
//    them from pos as the blocks did (no value goes back to the host). With
//    one split in the grid the block writes the output directly.
//  * A query row's sum order does not depend on how many rows the call has:
//    every call takes 64-row query tiles, the same instruction shapes, and a
//    tile count per split that the hosts derive from the number of query
//    tiles only, so T = 1 decode (4 folded rows a KV head) and a T = 9 spec
//    verify forward (36 rows) sum a row alike.
//
// f32 caches (attn_f32_kernel) keep a CUDA-core body: on the tensor cores
// f32 operands would be rounded to TF32, which is not the TPU kernels' f32
// product. It stages K/V tiles as f32 and runs the same mask, online
// softmax and split-KV merge with FMAs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int TQ = 64;  // folded query rows per block
constexpr int TS = 64;  // cache rows per KV tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kMinBlocksPerSm = 2;  // blocks an SM holds (shared memory and registers)
constexpr int kStages = 2;  // KV tiles in the copy ring
constexpr int RPW = TQ / (kThreads / 32);
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;
using f8 = __nv_fp8_e4m3;

// ------------------------------------------------------- where a row lives

// A contiguous cache [B, Hkv, S, hd].
template <int HD>
struct DenseRows {
  int S;
  struct Walk {
    size_t off;
    __device__ __forceinline__ size_t at() { return off; }
    __device__ __forceinline__ void step(int n) { off += (size_t)n * HD; }
  };
  __device__ __forceinline__ int length() const { return S; }
  // element offset of rows s, s + n, ... of (b, kv), one step() apart
  __device__ __forceinline__ Walk walk(int b, int kv, int Hkv, int s) const {
    return {((size_t)(b * Hkv + kv) * S + s) * HD};
  }
};

// A page pool [P, Hkv, page, hd] through block tables i32 [B, nb]: logical
// row s of slot b at pool[tables[b, s / page], kv, s % page].
template <int HD>
struct PagedRows {
  const int* tables;
  int nb, page;
  struct Walk {
    const int* tab;  // the slot's table row
    int Hkv, kv, page, pi, off, pi_read;
    size_t base;
    // the table entry is read when the walk enters its page, not before
    __device__ __forceinline__ size_t at() {
      if (pi != pi_read) {
        base = ((size_t)__ldg(tab + pi) * Hkv + kv) * page;
        pi_read = pi;
      }
      return (base + off) * HD;
    }
    __device__ __forceinline__ void step(int n) {
      off += n;
      while (off >= page) {
        off -= page;
        ++pi;
      }
    }
  };
  __device__ __forceinline__ int length() const { return nb * page; }
  __device__ __forceinline__ Walk walk(int b, int kv, int Hkv, int s) const {
    return {tables + (size_t)b * nb, Hkv, kv, page, s / page, s % page, -1, 0};
  }
};

// Live KV tiles of the query tile that starts at row r0: those up to the
// horizon of its last REAL row. The blocks and the combine agree on it.
__device__ __forceinline__ int live_tiles(int r0, int rows, int group, int pos_b, int S) {
  const int last_row = min(r0 + TQ - 1, rows - 1);
  return min(pos_b + last_row / group, S - 1) / TS + 1;
}

// ------------------------------------------------ tensor-core mode (bf16, f8)

// cp.async of 16 bytes from global to shared memory, zero-filling the 16
// bytes instead when `valid` is false (src is then not read, but must be a
// mapped address). A thread's copies form groups with cp_async_commit_group;
// cp_async_wait_group<N> waits until at most N of its groups are in flight.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// bf16 per shared row of a Q/K/V tile: hd plus 16 bytes of padding.
template <int HD>
constexpr int kLdh = HD + 8;

// Shared bytes of the MMA kernel: the ring of kStages (K, V) tiles in the
// cache's own type (bf16 tiles padded, e4m3 tiles raw), plus for e4m3 one
// bf16 (K, V) tile widened from the ring. The Q tile is read once into
// registers before the ring fills, so it borrows stage 1's K tile (bf16) or
// the widened K tile (f8).
template <typename TC, int HD>
constexpr int mma_smem_bytes() {
  return sizeof(TC) == 2 ? kStages * 2 * TS * kLdh<HD> * 2
                         : kStages * 2 * TS * HD + 2 * TS * kLdh<HD> * 2;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two f32 values as bf16x2 hi and lo parts: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split_bf16x2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(v0 - __low2float(h), v1 - __high2float(h));
}

// Sixteen e4m3 values (one 16-byte chunk) widened to bf16, exactly.
__device__ __forceinline__ void widen16(bf16* dst, uint4 raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __half2 v = __half2(__nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * h)), __NV_E4M3));
      const float2 f = __half22float2(v);
      o[2 * i + h] = pack_bf16x2(f.x, f.y);
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(o[4], o[5], o[6], o[7]);
}

template <typename TC, typename TO, int HD, typename Rows>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm) attn_mma_kernel(
    const bf16* __restrict__ q, const TC* __restrict__ kc, const TC* __restrict__ vc,
    const Rows cache, TO* __restrict__ out, float* __restrict__ o_part,
    float* __restrict__ ml_part, const int* __restrict__ pos_vec, int pos_scalar, int T_,
    int Hq, int Hkv, int tiles_per_split, float scale) {
  constexpr bool kF8 = sizeof(TC) == 1;
  constexpr int LD = kLdh<HD>;
  constexpr int KT = HD / 16;  // k16 steps of Q.K^T
  constexpr int NT = HD / 8;   // n8 tiles of the output
  constexpr int kChunks = HD * static_cast<int>(sizeof(TC)) / 16;  // 16-byte chunks a row
  constexpr int kRowsPerPass = kThreads / kChunks;  // rows one pass of the block copies
  extern __shared__ __align__(16) unsigned char smem[];
  TC* ring = reinterpret_cast<TC*>(smem);  // [kStages][K, V][TS][kF8 ? HD : LD]
  constexpr int kRingLd = kF8 ? HD : LD;
  bf16* wide = reinterpret_cast<bf16*>(smem + kStages * 2 * TS * HD);  // f8: [K, V][TS][LD]
  bf16* Qs = kF8 ? wide : reinterpret_cast<bf16*>(ring + (2 + 0) * TS * kRingLd);

  const int group = Hq / Hkv;
  const int bh = blockIdx.y;
  const int b = bh / Hkv, kv = bh % Hkv;
  const int rows = T_ * group;
  const int r0 = blockIdx.x * TQ;
  const int pos_b = pos_vec ? pos_vec[b] : pos_scalar;
  const int S = cache.length();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // horizon of this query tile: the last REAL row's last visible cache row
  const int last_row = min(r0 + TQ - 1, rows - 1);
  const int horizon = min(pos_b + last_row / group, S - 1);
  const int n_tiles = horizon / TS + 1;
  const int tile0 = blockIdx.z * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);
  if (tile0 >= tile1) return;  // past the horizon: attn_combine skips this split
  // this warp's 16 rows: real ones, and the horizon of its last real row
  const int wrow0 = r0 + warp * RPW;
  const bool warp_live = wrow0 < rows;
  const int warp_horizon = min(pos_b + (min(wrow0 + RPW, rows) - 1) / group, S - 1);

  // one KV tile into ring stage `st`: this thread's rows, kRowsPerPass
  // apart, at one 16-byte column; rows past the horizon are zero-filled
  auto load_kv = [&](int tile, int st) {
    const int s0 = tile * TS;
    TC* ks = ring + (size_t)st * 2 * TS * kRingLd;
    TC* vs = ks + TS * kRingLd;
    const int r_first = tid / kChunks, c = (tid % kChunks) * (16 / sizeof(TC));
    auto w = cache.walk(b, kv, Hkv, s0 + r_first);
#pragma unroll
    for (int j = 0; j < TS / kRowsPerPass; ++j) {
      const int r = r_first + j * kRowsPerPass;
      const bool in = s0 + r <= horizon;
      const size_t src = in ? w.at() + c : 0;
      cp_async16_zfill(ks + r * kRingLd + c, kc + src, in);
      cp_async16_zfill(vs + r * kRingLd + c, vc + src, in);
      w.step(kRowsPerPass);
    }
  };

  // the query tile's rows, gathered from q[b, t, kv * group + g, :]; pad
  // rows are zero (their results are never written)
  for (int i = tid; i < TQ * (HD / 8); i += kThreads) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    const int R = r0 + r;
    const bool in = R < rows;
    const size_t src =
        in ? ((size_t)(b * T_ + R / group) * Hq + kv * group + R % group) * HD + c : 0;
    cp_async16_zfill(Qs + r * LD + c, q + src, in);
  }
  load_kv(tile0, 0);
  cp_async_commit_group();
  cp_async_wait_group<0>();
  __syncthreads();
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    ldmatrix_x4(qa[kk], Qs + (warp * RPW + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
  __syncthreads();  // Q's shared rows are free for the ring

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  // rows of this thread's fragment elements: e < 2 and e >= 2
  const int rowa = wrow0 + lane / 4;
  const int qpos[2] = {pos_b + rowa / group, pos_b + (rowa + 8) / group};

  for (int tile = tile0, it = 0; tile < tile1; ++tile, ++it) {
    const int st = it & 1;
    if (tile + 1 < tile1) load_kv(tile + 1, st ^ 1);
    cp_async_commit_group();
    cp_async_wait_group<1>();  // this tile has landed; the next may be in flight
    __syncthreads();
    const bf16* Ks;
    const bf16* Vs;
    if constexpr (kF8) {  // widen the raw tile to bf16
      const TC* raw = ring + (size_t)st * 2 * TS * HD;
      for (int i = tid; i < 2 * TS * (HD / 16); i += kThreads) {
        const int r = i / (HD / 16), c = (i % (HD / 16)) * 16;  // r < 2 * TS: K rows, then V
        widen16(wide + r * LD + c, *reinterpret_cast<const uint4*>(raw + r * HD + c));
      }
      __syncthreads();
      Ks = wide;
      Vs = wide + TS * LD;
    } else {
      Ks = ring + (size_t)st * 2 * TS * LD;
      Vs = Ks + TS * LD;
    }
    const int s0 = tile * TS;
    if (warp_live && s0 <= warp_horizon) {
      // S = Q K^T for 16 rows x 64 keys: n8 tile j holds keys s0 + 8j ..
      float sc[TS / 8][4];
#pragma unroll
      for (int j = 0; j < TS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
        for (int jp = 0; jp < TS / 16; ++jp) {
          uint32_t kb[4];
          ldmatrix_x4(kb, Ks + (jp * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                              ((lane / 8) % 2) * 8);
          mma_bf16(sc[2 * jp], qa[kk], kb[0], kb[1]);
          mma_bf16(sc[2 * jp + 1], qa[kk], kb[2], kb[3]);
        }
      }
      // mask, online softmax: element e of tile j is row (e < 2 ? rowa :
      // rowa + 8), key s0 + 8j + 2 (lane % 4) + e % 2
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < TS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = s0 + 8 * j + 2 * (lane % 4) + e % 2;
          const bool ok = key <= qpos[e / 2] && key < S;
          sc[j][e] = ok ? sc[j][e] * scale : kNegInf;
          mx[e / 2] = fmaxf(mx[e / 2], sc[j][e]);
        }
      float alpha[2], m_new[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        m_new[h] = fmaxf(m_i[h], mx[h]);
        alpha[h] = expf(m_i[h] - m_new[h]);
      }
#pragma unroll
      for (int j = 0; j < TS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = s0 + 8 * j + 2 * (lane % 4) + e % 2;
          const bool ok = key <= qpos[e / 2] && key < S;
          sc[j][e] = ok ? expf(sc[j][e] - m_new[e / 2]) : 0.f;
          ps[e / 2] += sc[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
        ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
        l_i[h] = alpha[h] * l_i[h] + ps[h];
        m_i[h] = m_new[h];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
      // O += P V, P as hi + lo bf16 parts; k16 step ks covers keys 16 ks ..
#pragma unroll
      for (int ks = 0; ks < TS / 16; ++ks) {
        uint32_t ph[4], pl[4];
        split_bf16x2(sc[2 * ks][0], sc[2 * ks][1], ph[0], pl[0]);
        split_bf16x2(sc[2 * ks][2], sc[2 * ks][3], ph[1], pl[1]);
        split_bf16x2(sc[2 * ks + 1][0], sc[2 * ks + 1][1], ph[2], pl[2]);
        split_bf16x2(sc[2 * ks + 1][2], sc[2 * ks + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, Vs + (ks * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                    dp * 16 + (lane / 16) * 8);
          mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
          mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
          mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
          mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  if (!warp_live) return;
  const bool direct = gridDim.z == 1;
  const int rows_pad = gridDim.x * TQ;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = rowa + 8 * h;
    if (R >= rows) continue;
    if (direct) {
      const int t = R / group, g = R % group;
      const float inv = 1.f / (l_i[h] == 0.f ? 1.f : l_i[h]);
      TO* dst = out + ((size_t)(b * T_ + t) * Hq + kv * group + g) * HD + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        store(dst + 8 * j, acc[j][2 * h] * inv);
        store(dst + 8 * j + 1, acc[j][2 * h + 1] * inv);
      }
    } else {
      const size_t row = ((size_t)blockIdx.z * gridDim.y + bh) * rows_pad + R;
      float* dst = o_part + row * HD + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      if (lane % 4 == 0) {
        ml_part[row * 2] = m_i[h];
        ml_part[row * 2 + 1] = l_i[h];
      }
    }
  }
}

// ---------------------------------------------------- CUDA-core mode (f32)

// Copy TS rows of HD f32 from s0 on into shared rows of stride ld, through
// the policy's row addresses; rows at or past `valid` are zero-filled and
// not read. 16-byte loads, each thread at one column of rows kRowsPerPass
// apart.
template <int HD, typename Rows>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* src,
                                              const Rows& cache, int b, int kv, int Hkv,
                                              int s0, int valid) {
  constexpr int kPerRow = HD / 4;
  constexpr int kRowsPerPass = kThreads / kPerRow;
  const int r_first = threadIdx.x / kPerRow, c = (threadIdx.x % kPerRow) * 4;
  auto w = cache.walk(b, kv, Hkv, s0 + r_first);
#pragma unroll
  for (int j = 0; j < TS / kRowsPerPass; ++j) {
    const int r = r_first + j * kRowsPerPass;
    const float4 v = r < valid ? *reinterpret_cast<const float4*>(src + w.at() + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[r * ld + c] = v.x;
    dst[r * ld + c + 1] = v.y;
    dst[r * ld + c + 2] = v.z;
    dst[r * ld + c + 3] = v.w;
    w.step(kRowsPerPass);
  }
}

template <int HD>
constexpr int f32_smem_bytes() {
  return (TQ * HD + TS * (HD + 1) + TS * HD + TQ * TS) * 4;
}

template <int HD, typename Rows>
__global__ void __launch_bounds__(kThreads) attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ kc, const float* __restrict__ vc,
    const Rows cache, float* __restrict__ out, float* __restrict__ o_part,
    float* __restrict__ ml_part, const int* __restrict__ pos_vec, int pos_scalar, int T_,
    int Hq, int Hkv, int tiles_per_split, float scale) {
  constexpr int DPL = HD / 32;  // output dims per lane
  extern __shared__ __align__(16) float smem_f32[];
  float* Qs = smem_f32;             // [TQ][HD]
  float* Ks = Qs + TQ * HD;         // [TS][HD + 1]
  float* Vs = Ks + TS * (HD + 1);   // [TS][HD]
  float* Ps = Vs + TS * HD;         // [TQ][TS]

  const int group = Hq / Hkv;
  const int bh = blockIdx.y;
  const int b = bh / Hkv, kv = bh % Hkv;
  const int rows = T_ * group;
  const int r0 = blockIdx.x * TQ;
  const int pos_b = pos_vec ? pos_vec[b] : pos_scalar;
  const int S = cache.length();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // horizon of this query tile: the last REAL row's last visible cache row
  const int last_row = min(r0 + TQ - 1, rows - 1);
  const int horizon = min(pos_b + last_row / group, S - 1);
  const int n_tiles = horizon / TS + 1;
  const int tile0 = blockIdx.z * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);
  if (tile0 >= tile1) return;  // past the horizon: attn_combine skips this split

  // the query tile's real rows, gathered from q[b, t, kv * group + g, :]
  // (pad rows are never read unmasked: their scores take -1e30)
  const int live_rows = min(TQ, rows - r0);
  for (int i = threadIdx.x; i < live_rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int R = r0 + r;
    const int t = R / group, g = R % group;
    Qs[r * HD + d] = q[((size_t)(b * T_ + t) * Hq + kv * group + g) * HD + d];
  }

  const int wrow0 = warp * RPW;  // this warp's first row within the tile
  const int nrw = min(RPW, rows - (r0 + wrow0));  // its real rows (warp-uniform)
  const bool warp_live = nrw > 0;
  float m_i[RPW], l_i[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }

  for (int tile = tile0; tile < tile1; ++tile) {
    const int s0 = tile * TS;
    __syncthreads();  // Q is loaded / the previous tile's reads are done
    load_rows_f32<HD>(Ks, HD + 1, kc, cache, b, kv, Hkv, s0, horizon - s0 + 1);
    load_rows_f32<HD>(Vs, HD, vc, cache, b, kv, Hkv, s0, horizon - s0 + 1);
    __syncthreads();
    if (!warp_live) continue;

    // scores for this warp's rows against keys s0 + lane and s0 + lane + 32
    float sc[RPW][2];
#pragma unroll
    for (int i = 0; i < RPW; ++i) sc[i][0] = sc[i][1] = 0.f;
    for (int d = 0; d < HD; d += 4) {
      float k0[4], k1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k0[e] = Ks[lane * (HD + 1) + d + e];
        k1[e] = Ks[(lane + 32) * (HD + 1) + d + e];
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        if (i >= nrw) break;
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (wrow0 + i) * HD + d);
        sc[i][0] += qv.x * k0[0] + qv.y * k0[1] + qv.z * k0[2] + qv.w * k0[3];
        sc[i][1] += qv.x * k1[0] + qv.y * k1[1] + qv.z * k1[2] + qv.w * k1[3];
      }
    }

    // online softmax, one row at a time across the warp
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (i >= nrw) break;
      const int R = r0 + wrow0 + i;
      const int qpos = pos_b + R / group;
      const int sa = s0 + lane, sb = s0 + lane + 32;
      const bool ma = sa <= qpos && sa < S;
      const bool mb = sb <= qpos && sb < S;
      const float a = ma ? sc[i][0] * scale : kNegInf;
      const float bb = mb ? sc[i][1] * scale : kNegInf;
      float mx = fmaxf(a, bb);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      const float pa = ma ? expf(a - m_new) : 0.f;
      const float pb = mb ? expf(bb - m_new) : 0.f;
      float ps = pa + pb;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l_i[i] = alpha * l_i[i] + ps;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[i][c] *= alpha;
      Ps[(wrow0 + i) * TS + lane] = pa;
      Ps[(wrow0 + i) * TS + lane + 32] = pb;
    }
    __syncwarp();

    // acc += P @ V over this tile's live keys, 4 keys at a time
    const int n_keys = min(TS, horizon - s0 + 1);
    for (int j = 0; j < n_keys; j += 4) {
      float v[4][DPL];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < DPL; ++c) v[e][c] = Vs[(j + e) * HD + c * 32 + lane];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        if (i >= nrw) break;
        const float4 p = *reinterpret_cast<const float4*>(Ps + (wrow0 + i) * TS + j);
#pragma unroll
        for (int c = 0; c < DPL; ++c)
          acc[i][c] += p.x * v[0][c] + p.y * v[1][c] + p.z * v[2][c] + p.w * v[3][c];
      }
    }
  }

  if (!warp_live) return;
  const bool direct = gridDim.z == 1;
  const int rows_pad = gridDim.x * TQ;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int R = r0 + wrow0 + i;
    if (R >= rows) break;
    if (direct) {
      const int t = R / group, g = R % group;
      const float inv = 1.f / (l_i[i] == 0.f ? 1.f : l_i[i]);
      float* dst = out + ((size_t)(b * T_ + t) * Hq + kv * group + g) * HD;
#pragma unroll
      for (int c = 0; c < DPL; ++c) dst[c * 32 + lane] = acc[i][c] * inv;
    } else {
      const size_t row = ((size_t)blockIdx.z * gridDim.y + bh) * rows_pad + R;
#pragma unroll
      for (int c = 0; c < DPL; ++c) o_part[row * HD + c * 32 + lane] = acc[i][c];
      if (lane == 0) {
        ml_part[row * 2] = m_i[i];
        ml_part[row * 2 + 1] = l_i[i];
      }
    }
  }
}

// ------------------------------------------------------------- both modes

// Merge each row's live splits, in split order: out = sum_s w_s o_s /
// sum_s w_s l_s with w_s = exp(m_s - max_s m_s). The live splits are those
// whose first tile the row's query tile reaches (the blocks of the others
// exited without writing); split 0 always holds tile 0.
template <typename TO>
__global__ void attn_combine(const float* __restrict__ o_part,
                             const float* __restrict__ ml_part, TO* __restrict__ out,
                             const int* __restrict__ pos_vec, int pos_scalar, int splits,
                             int tiles_per_split, int S, int BHkv, int rows_pad, int T_,
                             int Hq, int Hkv, int HD) {
  const int group = Hq / Hkv;
  const int rows = T_ * group;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)BHkv * rows * HD) return;
  const int d = (int)(i % HD);
  const int R = (int)((i / HD) % rows);
  const int bh = (int)(i / ((size_t)HD * rows));
  const int b = bh / Hkv, kv = bh % Hkv;
  const int pos_b = pos_vec ? pos_vec[b] : pos_scalar;
  const int n_tiles = live_tiles(R / TQ * TQ, rows, group, pos_b, S);
  const int live = min(splits, (n_tiles + tiles_per_split - 1) / tiles_per_split);
  float mmax = kNegInf;
#pragma unroll 8
  for (int s = 0; s < live; ++s)
    mmax = fmaxf(mmax, ml_part[(((size_t)s * BHkv + bh) * rows_pad + R) * 2]);
  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int s = 0; s < live; ++s) {
    const size_t row = ((size_t)s * BHkv + bh) * rows_pad + R;
    const float w = expf(ml_part[row * 2] - mmax);
    num += w * o_part[row * HD + d];
    den += w * ml_part[row * 2 + 1];
  }
  const int t = R / group, g = R % group;
  store(out + ((size_t)(b * T_ + t) * Hq + kv * group + g) * HD + d,
        num / (den == 0.f ? 1.f : den));
}

template <typename KernelFn>
void set_smem(KernelFn* fn, int bytes, bool& configured) {
  if (!configured) {
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    configured = true;
  }
}

// One attention call over `cache`: the sweep, then (splits > 1) the
// combine. T: q's element type (f32 takes the CUDA-core body); TC: the
// cache's; TO: the output's.
template <typename T, typename TC, typename TO, int HD, typename Rows>
int launch_attention(const void* q, const void* k, const void* v, const Rows& cache, void* out,
                     void* o_part, void* ml_part, const void* pos_vec, int pos_scalar, int B,
                     int T_, int Hq, int Hkv, int S, int splits, int tiles_per_split,
                     cudaStream_t st) {
  const int rows = T_ * (Hq / Hkv);
  dim3 grid((rows + TQ - 1) / TQ, B * Hkv, splits);
  const float scale = 1.0f / sqrtf((float)HD);
  static bool configured = false;
  if constexpr (sizeof(T) == 4) {
    constexpr int kSmem = f32_smem_bytes<HD>();
    set_smem(attn_f32_kernel<HD, Rows>, kSmem, configured);
    attn_f32_kernel<HD, Rows><<<grid, kThreads, kSmem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), cache, static_cast<float*>(out),
        static_cast<float*>(o_part), static_cast<float*>(ml_part),
        static_cast<const int*>(pos_vec), pos_scalar, T_, Hq, Hkv, tiles_per_split, scale);
  } else {
    constexpr int kSmem = mma_smem_bytes<TC, HD>();
    set_smem(attn_mma_kernel<TC, TO, HD, Rows>, kSmem, configured);
    attn_mma_kernel<TC, TO, HD, Rows><<<grid, kThreads, kSmem, st>>>(
        static_cast<const bf16*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v),
        cache, static_cast<TO*>(out), static_cast<float*>(o_part),
        static_cast<float*>(ml_part), static_cast<const int*>(pos_vec), pos_scalar, T_, Hq,
        Hkv, tiles_per_split, scale);
  }
  if (splits > 1) {
    const size_t total = (size_t)B * Hkv * rows * HD;
    attn_combine<TO><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
        static_cast<TO*>(out), static_cast<const int*>(pos_vec), pos_scalar, splits,
        tiles_per_split, S, B * Hkv, grid.x * TQ, T_, Hq, Hkv, HD);
  }
  return (int)cudaGetLastError();
}

}  // namespace
