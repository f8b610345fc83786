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
// With new rows, a first launch writes them to their targets (wpages, woffs
// from ops.layers.paged_write_targets; inactive slots go to the trash page)
// before the sweep reads them.
//
// What bounds it on this card: at decode, device-memory bytes. A step reads
// 2 * Hkv * (pos + 1) * hd pool elements of each slot once per layer and does
// only group * hd * 4 operations per pair of elements. A 256-token prefill
// chunk does 4 * rows * keys * hd operations on CUDA cores: compute.
//
// What the design does about it:
//  * Only live rows are read: a block walks sub-tiles of ts <= 64 rows (ts
//    divides the page, so a sub-tile never spans two pages) up to the
//    horizon of its last REAL query row (pad rows do not widen it), so the
//    cost follows pos, not the table width. Each block reads pos[b] and the
//    table entries itself: no value goes back to the host.
//  * Split-KV without a host sync: the host picks the split count from the
//    table width and the SM count; split z takes sub-tiles z, z + splits, ...
//    so the live tiles are spread over the splits at any horizon, and a split
//    past the horizon writes an empty partial (m = -1e30, l = 0). A second
//    pass merges the splits in a fixed order: no float atomics, so greedy
//    output repeats run to run.
//  * K/V sub-tiles are copied with cp.async, 16 bytes a thread, into two
//    shared-memory stages in the pool's own type (rows padded by 16 bytes to
//    spread the banks): the next sub-tile is in flight while this one is in
//    use. Any page % 8 == 0 fits, f32 pools included; the TPU needed whole
//    pages in VMEM, Hopper does not.
//  * Fused scatter: blocks of one (slot, head) run in no order, so the new
//    rows are written by a small kernel launched first on the same stream,
//    one block per (slot, head), rows in order t = 0..T-1; a row whose target
//    a later row of the batch (in (slot, t) order) also hits is skipped, so
//    the last row wins, as in the plain scatter, and no two blocks race.
//  * Scores and the online softmax are f32, scale 1/sqrt(hd), masked entries
//    -1e30, and a row whose sum is 0 divides by 1, as on the TPU.
//  * Still simple: CUDA-core FMAs, no tensor cores, one warp per 16 query
//    rows (decode at group 4 keeps one warp computing while all four load).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int TQ = 64;         // folded query rows per block
constexpr int TS = 64;         // most pool rows per sub-tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int RPW = TQ / (kThreads / 32);
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// four consecutive elements, widened to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory row stride of a K/V sub-tile, in elements: hd plus 16 bytes.
template <typename T, int HD>
constexpr int kLd = HD + 16 / static_cast<int>(sizeof(T));

template <typename T, int HD>
constexpr int smem_bytes() {
  return (TQ * HD + TQ * TS) * 4 + 2 * 2 * TS * kLd<T, HD> * static_cast<int>(sizeof(T));
}

// New rows nk/nv [B, Hkv, T, hd] -> pools at (wpages, woffs) [B, T]. One block
// per (slot, kv head).
template <typename T>
__global__ void scatter_kernel(T* __restrict__ kp, T* __restrict__ vp,
                               const T* __restrict__ nk, const T* __restrict__ nv,
                               const int* __restrict__ wpages, const int* __restrict__ woffs,
                               int B, int T_, int Hkv, int page, int HD) {
  const int b = blockIdx.x / Hkv, kv = blockIdx.x % Hkv;
  const int n = B * T_;
  for (int t = 0; t < T_; ++t) {
    const int i = b * T_ + t;
    const int pg = wpages[i], off = woffs[i];
    bool later = false;  // the same for every thread of the block
    for (int j = i + 1; j < n; ++j) later |= (wpages[j] == pg && woffs[j] == off);
    if (later) continue;
    const size_t dst = (((size_t)pg * Hkv + kv) * page + off) * HD;
    const size_t src = (((size_t)b * Hkv + kv) * T_ + t) * HD;
    for (int d = threadIdx.x; d < HD; d += blockDim.x) {
      kp[dst + d] = nk[src + d];
      vp[dst + d] = nv[src + d];
    }
  }
}

template <typename T, typename TO, int HD>
__global__ void __launch_bounds__(kThreads) paged_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ tables, const int* __restrict__ pos, TO* __restrict__ out,
    float* __restrict__ o_part, float* __restrict__ ml_part, int T_, int Hq, int Hkv,
    int page, int nb, int ts, float scale) {
  constexpr int LD = kLd<T, HD>;
  constexpr int DPL = HD / 32;  // output dims per lane
  constexpr int CPR = HD * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [TQ][HD]
  float* Ps = Qs + TQ * HD;                        // [TQ][TS]
  T* KV = reinterpret_cast<T*>(Ps + TQ * TS);      // [stage][k, v][TS][LD]

  const int group = Hq / Hkv;
  const int bh = blockIdx.y;
  const int b = bh / Hkv, kv = bh % Hkv;
  const int rows = T_ * group;
  const int r0 = blockIdx.x * TQ;
  const int split = blockIdx.z, splits = gridDim.z;
  const int pos_b = pos[b];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* tab = tables + (size_t)b * nb;

  // horizon of this query tile: the last REAL row's last visible row, within
  // the table's logical view of nb * page rows
  const int last_row = min(r0 + TQ - 1, rows - 1);
  const int horizon = min(pos_b + last_row / group, nb * page - 1);
  const int n_tiles = horizon / ts + 1;

  const int live_rows = min(TQ, rows - r0);
  for (int i = threadIdx.x; i < live_rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int R = r0 + r;
    const int t = R / group, g = R % group;
    Qs[r * HD + d] = to_f32(q[((size_t)(b * T_ + t) * Hq + kv * group + g) * HD + d]);
  }

  const int wrow0 = warp * RPW;
  const int nrw = min(RPW, rows - (r0 + wrow0));  // this warp's real rows
  const bool warp_live = nrw > 0;
  float m_i[RPW], l_i[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }

  // copy sub-tile `tile` (rows [tile*ts, tile*ts + ts) of the slot) into `stage`
  auto load_tile = [&](int tile, int stage) {
    const int s0 = tile * ts;
    const int pg = tab[min(s0 / page, nb - 1)];
    const size_t base = (((size_t)pg * Hkv + kv) * page + (s0 % page)) * HD;
    T* ks = KV + (size_t)stage * 2 * TS * LD;
    T* vs = ks + TS * LD;
    for (int c = threadIdx.x; c < ts * CPR; c += kThreads) {
      const int r = c / CPR, col = (c % CPR) * (16 / static_cast<int>(sizeof(T)));
      cp_async16(ks + r * LD + col, kp + base + (size_t)r * HD + col);
      cp_async16(vs + r * LD + col, vp + base + (size_t)r * HD + col);
    }
    cp_async_commit();
  };

  int stage = 0;
  if (split < n_tiles) load_tile(split, 0);
  for (int tile = split; tile < n_tiles; tile += splits) {
    if (tile + splits < n_tiles) {
      load_tile(tile + splits, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this sub-tile (and Q) is in shared memory for every thread
    const T* Ks = KV + (size_t)stage * 2 * TS * LD;
    const T* Vs = Ks + TS * LD;
    const int s0 = tile * ts;
    if (warp_live) {
      // scores for this warp's rows against keys s0 + lane and s0 + lane + 32
      float sc[RPW][2];
#pragma unroll
      for (int i = 0; i < RPW; ++i) sc[i][0] = sc[i][1] = 0.f;
      for (int d = 0; d < HD; d += 4) {
        const float4 k0 = load4(Ks + lane * LD + d);
        const float4 k1 = load4(Ks + (lane + 32) * LD + d);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          if (i >= nrw) break;
          const float4 qv = *reinterpret_cast<const float4*>(Qs + (wrow0 + i) * HD + d);
          sc[i][0] += qv.x * k0.x + qv.y * k0.y + qv.z * k0.z + qv.w * k0.w;
          sc[i][1] += qv.x * k1.x + qv.y * k1.y + qv.z * k1.z + qv.w * k1.w;
        }
      }
      // online softmax, one row at a time across the warp
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        if (i >= nrw) break;
        const int R = r0 + wrow0 + i;
        const int qpos = pos_b + R / group;
        const bool ma = lane < ts && s0 + lane <= qpos;
        const bool mb = lane + 32 < ts && s0 + lane + 32 <= qpos;
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
      // acc += P @ V over this sub-tile's live keys, 4 at a time (ts % 8 == 0,
      // so the last group of 4 stays inside the copied rows)
      const int n_keys = min(ts, horizon - s0 + 1);
      for (int j = 0; j < n_keys; j += 4) {
        float v[4][DPL];
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < DPL; ++c) v[e][c] = to_f32(Vs[(j + e) * LD + c * 32 + lane]);
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
    __syncthreads();  // every read of this stage is done before it is refilled
    stage ^= 1;
  }

  if (!warp_live) return;
  const bool direct = splits == 1;
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
      const size_t row = ((size_t)split * gridDim.y + bh) * rows_pad + R;
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
// sum_s w_s l_s with w_s = exp(m_s - max_s m_s). An empty split (m = -1e30,
// l = 0) weighs 0; split 0 always holds sub-tile 0, so the max is real.
template <typename TO>
__global__ void paged_combine(const float* __restrict__ o_part,
                              const float* __restrict__ ml_part, TO* __restrict__ out,
                              int splits, int BHkv, int rows_pad, int T_, int Hq, int Hkv,
                              int HD) {
  const int group = Hq / Hkv;
  const int rows = T_ * group;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)BHkv * rows * HD) return;
  const int d = (int)(i % HD);
  const int R = (int)((i / HD) % rows);
  const int bh = (int)(i / ((size_t)HD * rows));
  float mmax = kNegInf;
  for (int s = 0; s < splits; ++s)
    mmax = fmaxf(mmax, ml_part[(((size_t)s * BHkv + bh) * rows_pad + R) * 2]);
  float num = 0.f, den = 0.f;
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

template <typename T, typename TO, int HD>
int launch(const void* q, void* kp, void* vp, const void* nk, const void* nv,
           const void* wpages, const void* woffs, const void* tables, const void* pos,
           void* out, void* o_part, void* ml_part, int B, int T_, int Hq, int Hkv, int page,
           int nb, int ts, int splits, cudaStream_t st) {
  constexpr int kSmem = smem_bytes<T, HD>();
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(paged_kernel<T, TO, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmem);
    configured = true;
  }
  if (nk != nullptr) {
    scatter_kernel<T><<<B * Hkv, kThreads, 0, st>>>(
        static_cast<T*>(kp), static_cast<T*>(vp), static_cast<const T*>(nk),
        static_cast<const T*>(nv), static_cast<const int*>(wpages),
        static_cast<const int*>(woffs), B, T_, Hkv, page, HD);
  }
  const int rows = T_ * (Hq / Hkv);
  dim3 grid((rows + TQ - 1) / TQ, B * Hkv, splits);
  paged_kernel<T, TO, HD><<<grid, kThreads, kSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(pos), static_cast<TO*>(out),
      static_cast<float*>(o_part), static_cast<float*>(ml_part), T_, Hq, Hkv, page, nb, ts,
      1.0f / sqrtf((float)HD));
  if (splits > 1) {
    const size_t total = (size_t)B * Hkv * rows * HD;
    paged_combine<TO><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
        static_cast<TO*>(out), splits, B * Hkv, grid.x * TQ, T_, Hq, Hkv, HD);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, T, Hq, hd]; pools k, v [P, Hkv, page, hd] of q's dtype (0 = bf16,
// 1 = f32), updated in place by the scatter; tables i32 [B, nb]; pos i32 [B];
// out [B, T, Hq, hd] in that dtype, or f32 when out_f32; hd 64 or 128. With
// new_k non-null, new_k/new_v [B, Hkv, T, hd] (the pools' dtype) are first
// written at wpages/woffs i32 [B, T]; with new_k null the sweep is read-only.
// ts: rows per sub-tile, a multiple of 8, at most 64, dividing page. o_part
// f32 [splits, B*Hkv, rows_pad, hd] and ml_part f32 [splits, B*Hkv, rows_pad,
// 2] are scratch, unused when splits == 1. Returns the CUDA error state after
// the launches (0 = success; -1 = unsupported dtype/hd; -2 = bad ts/page).
extern "C" int paged_attention(const void* q, void* k_pool, void* v_pool, const void* new_k,
                               const void* new_v, const void* wpages, const void* woffs,
                               const void* tables, const void* pos, void* out, void* o_part,
                               void* ml_part, int B, int T_, int Hq, int Hkv, int page, int nb,
                               int hd, int ts, int dtype, int out_f32, int splits,
                               void* stream) {
  if (ts <= 0 || ts > TS || ts % 8 || page % ts) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DLLAMA_PAGED_ARGS                                                                 \
  q, k_pool, v_pool, new_k, new_v, wpages, woffs, tables, pos, out, o_part, ml_part, B, T_, \
      Hq, Hkv, page, nb, ts, splits, st
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && !out_f32 && hd == 128) return launch<bf16, bf16, 128>(DLLAMA_PAGED_ARGS);
  if (dtype == 0 && !out_f32 && hd == 64) return launch<bf16, bf16, 64>(DLLAMA_PAGED_ARGS);
  if (dtype == 0 && out_f32 && hd == 128) return launch<bf16, float, 128>(DLLAMA_PAGED_ARGS);
  if (dtype == 0 && out_f32 && hd == 64) return launch<bf16, float, 64>(DLLAMA_PAGED_ARGS);
  if (dtype == 1 && hd == 128) return launch<float, float, 128>(DLLAMA_PAGED_ARGS);
  if (dtype == 1 && hd == 64) return launch<float, float, 64>(DLLAMA_PAGED_ARGS);
#undef DLLAMA_PAGED_ARGS
  return -1;
}
