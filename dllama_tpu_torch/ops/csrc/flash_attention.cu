// Causal GQA flash attention over the dense KV cache, for Hopper.
//
// Replaces dllama_tpu/ops/pallas/flash_attention.py:_kernel (called by
// _flash_folded, wrapper flash_gqa_attention), the TPU's attention kernel.
//
// Semantics (those of dllama_tpu/ops/layers.gqa_attention): q[B, T, Hq, hd]
// against a cache [B, Hkv, S, hd]; query token t of sequence b sees cache
// slots s <= pos[b] + t. The GQA group is folded t-major into the query rows
// of one KV head (row R = t * group + g holds query head kv * group + g), so
// one sweep over a KV tile serves the whole group.
//
// What bounds it on this card: at decode, device-memory bytes — each step
// reads 2 * Hkv * (pos + 1) * hd cache elements once per layer, with only
// group * hd * 4 operations per element pair. At a 256-token prefill chunk
// it does 4 * rows * keys * hd operations on CUDA cores, which is compute.
//
// What the design does about it:
//  * Only live KV tiles are read: a block walks 64-row tiles up to the
//    horizon of its last REAL query row (pad rows do not widen it), so decode
//    cost follows pos, not S. A ragged S is masked.
//  * Split-KV: the live tiles of one (sequence, KV head, query tile) are
//    divided among several blocks so that a decode step (B * Hkv = 8 blocks
//    without a split) fills the card. Each split keeps its own online-softmax
//    state (max, sum, unnormalized output) and a second pass merges the
//    splits in a fixed order; with one split the block writes the output
//    directly.
//  * K/V tiles are loaded with 16-byte loads into shared memory as f32 (K
//    rows padded by one word so lanes reading different keys hit different
//    banks). Scores and the online softmax are f32, masked entries take
//    -1e30, and a row whose sum is 0 divides by 1, as on the TPU.
//  * The cache element has its own type beside q's: bf16 or f32 as q, or
//    e4m3 under a bf16 q (the f8 KV cache, --cache-dtype f8). An e4m3 value
//    widens to f32 exactly (cuda_fp8.h), so everything after the load stays
//    f32, as in the TPU kernel, and the f8 mode moves half the cache bytes.
//  * Still simple: CUDA-core FMAs, no tensor cores, one tile in flight.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int TQ = 64;        // folded query rows per block
constexpr int TS = 64;        // cache rows per KV tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int RPW = TQ / (kThreads / 32);
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }

// Copy n_rows x HD elements (row stride HD in global memory) into shared f32
// rows of stride ld, zero-filling rows at or past `valid`. 16-byte loads.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int n_rows,
                                          int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < n_rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    alignas(16) T vals[kVec];
    if (r < valid) {
      *reinterpret_cast<uint4*>(vals) =
          *reinterpret_cast<const uint4*>(src + (size_t)r * HD + c);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = T(0.f);
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r * ld + c + e] = to_f32(vals[e]);
  }
}

template <typename T, typename TC, typename TO, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const TC* __restrict__ kc, const TC* __restrict__ vc,
    TO* __restrict__ out, float* __restrict__ o_part, float* __restrict__ ml_part,
    const int* __restrict__ pos_vec, int pos_scalar, int T_, int Hq, int Hkv, int S,
    int tiles_per_split, float scale) {
  constexpr int DPL = HD / 32;  // output dims per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [TQ][HD]
  float* Ks = Qs + TQ * HD;         // [TS][HD + 1]
  float* Vs = Ks + TS * (HD + 1);   // [TS][HD]
  float* Ps = Vs + TS * HD;         // [TQ][TS]

  const int group = Hq / Hkv;
  const int bh = blockIdx.y;
  const int b = bh / Hkv, kv = bh % Hkv;
  const int rows = T_ * group;
  const int r0 = blockIdx.x * TQ;
  const int pos_b = pos_vec ? pos_vec[b] : pos_scalar;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // horizon of this query tile: the last REAL row's last visible cache slot
  const int last_row = min(r0 + TQ - 1, rows - 1);
  const int horizon = min(pos_b + last_row / group, S - 1);
  const int n_tiles = horizon / TS + 1;
  const int tile0 = blockIdx.z * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);

  // the query tile's real rows, gathered from q[b, t, kv * group + g, :]
  // (pad rows are never read unmasked: their scores take -1e30)
  const int live_rows = min(TQ, rows - r0);
  for (int i = threadIdx.x; i < live_rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int R = r0 + r;
    const int t = R / group, g = R % group;
    Qs[r * HD + d] = to_f32(q[((size_t)(b * T_ + t) * Hq + kv * group + g) * HD + d]);
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

  const size_t head_off = (size_t)bh * S * HD;
  for (int tile = tile0; tile < tile1; ++tile) {
    const int s0 = tile * TS;
    __syncthreads();  // Q is loaded / the previous tile's reads are done
    load_tile<TC, HD>(Ks, HD + 1, kc + head_off + (size_t)s0 * HD, TS, S - s0);
    load_tile<TC, HD>(Vs, HD, vc + head_off + (size_t)s0 * HD, TS, S - s0);
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
      TO* dst = out + ((size_t)(b * T_ + t) * Hq + kv * group + g) * HD;
#pragma unroll
      for (int c = 0; c < DPL; ++c) store(dst + c * 32 + lane, acc[i][c] * inv);
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

// Merge the splits of each row, in split order: out = sum_s w_s o_s /
// sum_s w_s l_s with w_s = exp(m_s - max_s m_s).
template <typename TO>
__global__ void flash_combine(const float* __restrict__ o_part,
                              const float* __restrict__ ml_part, TO* __restrict__ out,
                              int splits, int BHkv, int rows_pad, int T_, int Hq,
                              int Hkv, int HD) {
  const int group = Hq / Hkv;
  const int rows = T_ * group;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)BHkv * rows * HD) return;
  const int d = (int)(i % HD);
  const int R = (int)((i / HD) % rows);
  const int bh = (int)(i / ((size_t)HD * rows));
  float mmax = kNegInf;
#pragma unroll 8
  for (int s = 0; s < splits; ++s)
    mmax = fmaxf(mmax, ml_part[(((size_t)s * BHkv + bh) * rows_pad + R) * 2]);
  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {
    const size_t row = ((size_t)s * BHkv + bh) * rows_pad + R;
    const float w = expf(ml_part[row * 2] - mmax);
    num += w * o_part[row * HD + d];
    den += w * ml_part[row * 2 + 1];
  }
  const int b = bh / Hkv, kv = bh % Hkv;
  const int t = R / group, g = R % group;
  store(out + ((size_t)(b * T_ + t) * Hq + kv * group + g) * HD + d,
        num / (den == 0.f ? 1.f : den));
}

template <typename T, typename TC, typename TO, int HD>
int launch(const void* q, const void* k, const void* v, void* out, void* o_part,
           void* ml_part, const void* pos_vec, int pos_scalar, int B, int T_, int Hq,
           int Hkv, int S, int splits, int tiles_per_split, cudaStream_t st) {
  constexpr int kSmem = (TQ * HD + TS * (HD + 1) + TS * HD + TQ * TS) * 4;
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(flash_kernel<T, TC, TO, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmem);
    configured = true;
  }
  const int rows = T_ * (Hq / Hkv);
  dim3 grid((rows + TQ - 1) / TQ, B * Hkv, splits);
  flash_kernel<T, TC, TO, HD><<<grid, kThreads, kSmem, st>>>(
      static_cast<const T*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v),
      static_cast<TO*>(out), static_cast<float*>(o_part), static_cast<float*>(ml_part),
      static_cast<const int*>(pos_vec), pos_scalar, T_, Hq, Hkv, S, tiles_per_split,
      1.0f / sqrtf((float)HD));
  if (splits > 1) {
    const size_t total = (size_t)B * Hkv * rows * HD;
    flash_combine<TO><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
        static_cast<TO*>(out), splits, B * Hkv, grid.x * TQ, T_, Hq, Hkv, HD);
  }
  return (int)cudaGetLastError();
}

}  // namespace

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
#define DLLAMA_FLASH_ARGS \
  q, k, v, out, o_part, ml_part, pos_vec, pos_scalar, B, T_, Hq, Hkv, S, splits, \
      tiles_per_split, st
  using bf16 = __nv_bfloat16;
  using f8 = __nv_fp8_e4m3;
  if (dtype == 0 && !out_f32 && hd == 128) return launch<bf16, bf16, bf16, 128>(DLLAMA_FLASH_ARGS);
  if (dtype == 0 && !out_f32 && hd == 64) return launch<bf16, bf16, bf16, 64>(DLLAMA_FLASH_ARGS);
  if (dtype == 0 && out_f32 && hd == 128) return launch<bf16, bf16, float, 128>(DLLAMA_FLASH_ARGS);
  if (dtype == 0 && out_f32 && hd == 64) return launch<bf16, bf16, float, 64>(DLLAMA_FLASH_ARGS);
  if (dtype == 1 && hd == 128) return launch<float, float, float, 128>(DLLAMA_FLASH_ARGS);
  if (dtype == 1 && hd == 64) return launch<float, float, float, 64>(DLLAMA_FLASH_ARGS);
  if (dtype == 2 && !out_f32 && hd == 128) return launch<bf16, f8, bf16, 128>(DLLAMA_FLASH_ARGS);
  if (dtype == 2 && !out_f32 && hd == 64) return launch<bf16, f8, bf16, 64>(DLLAMA_FLASH_ARGS);
  if (dtype == 2 && out_f32 && hd == 128) return launch<bf16, f8, float, 128>(DLLAMA_FLASH_ARGS);
  if (dtype == 2 && out_f32 && hd == 64) return launch<bf16, f8, float, 64>(DLLAMA_FLASH_ARGS);
#undef DLLAMA_FLASH_ARGS
  return -1;
}
