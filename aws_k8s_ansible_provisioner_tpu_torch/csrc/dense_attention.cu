// Flash attention over one layer of the dense slot cache [L, B, Hkv, S, D]
// (the dense engine's cache, paged=False, and the draft model's), bf16 or
// float32, or int8 with a float32 scale per (row, kv head), with or without
// a sliding window; one slot per CTA, or BB slots per CTA (the
// batch-blocked form).
//
// Replaces: aws_k8s_ansible_provisioner_tpu/ops/pallas_attention.py:
//   decode_attend_pallas_layer with bblock 1 (K4: bodies
//   _decode_kernel_layer and, int8, _decode_kernel_layer_q) and with
//   bblock > 1 (K5: _decode_kernel_layer_bb and _decode_kernel_layer_q_bb),
//   and decode_attend_pallas_spec (K7: _spec_accumulate through
//   _spec_kernel_plain and _spec_kernel_quant), each at window 0 and
//   window > 0; and decode_attend_pallas_layer with return_stats=True (K6:
//   _decode_kernel_layer_stats and, int8, _decode_kernel_layer_q_stats),
//   the second entry dense_attention_stats.
//
// Contract (same as the TPU kernels): q [B, R, Hq, D], R query rows per slot
// (R = 1 for a decode step, R > 1 for a speculative verify); cache_k/v
// [L, B, Hkv, S, D] of q's type, or int8 with cache_ks/vs [L, B, Hkv, S]
// float32; limits [B] int32; output [B, R, Hq, D] in q's type.
// Query row (b, r) has the limit lim = limits[b] + r and attends the rows
// [0, min(lim, S)) of slot b, or with a window the rows
// [max(lim - window, 0), min(lim, S)); the decode entry passes limits =
// lengths (the just-written row counted), the verify entry limits =
// lengths + 1. No row past that is read; with a window the 64-row tiles
// start at the tile of the window start, no earlier row is read, and the
// columns of that tile below the start are masked with -1e30 (the tile
// holds a live column, so they add exp(-1e30 - m) = 0). Online softmax in
// float32 with the scale 1/sqrt(D) folded into q; output acc / max(l,
// 1e-9). A row with no row to visit (a decode row of length 0)
// accumulates nothing and returns 0 / 1e-9 = zeros, where the paged kernel
// returns the mean of V over its first page (the TPU kernels differ the
// same way). Window 0 is its own instance (kWindow false) with no window
// arithmetic in it.
//
// Int8 (TC = int8_t) folds the scales into the loop in the TPU body's order
// and never builds a dequantized copy: s = (q * 1/sqrt(D)) . k_int8 *
// kscale[col], then the mask and the online max; l sums the UNSCALED p, and
// p * vscale[col] enters P.V (as the paged kernel's int8 instance does).
//
// The batch-blocked form (kBlock, decode only, R = 1): CTA g owns slots
// g * BB .. g * BB + BB - 1 of one kv head and walks the block's union tile
// range, as the TPU body's chunk range is the union over its block
// (pallas_attention.py:454-469): from the tile of the lowest window start
// (0 without a window) to the largest length. Each slot's G rows are
// masked by the slot's own limit and window; a slot reads no row past its
// own limit. Masked columns get p = 0 exactly, so a row whose block tiles
// below its window are wholly masked comes out as K4's, and a row with no
// live column at all (length 0 beside a longer slot) returns K4's zeros,
// where the TPU body returns the mean of V over the chunks its block visits
// (every column masked, p = exp(0); ROADMAP C11). So the block size changes
// the speed and never the result. On the H100 the slots of a block share
// no bytes (each has its own rows), so this form only trades CTAs for
// serial work; it is kept so that a pinned decode_bblock runs it.
//
// What bounds it on the H100: bytes. A query row reads its slot's live K
// and V rows (2 * D * elem bytes per row and kv head, plus 8 bytes of scales
// for int8) and does 4 * G * D flops per column, about one flop per byte
// against the card's ~295 flop/byte ridge. The design is the paged
// kernel's: one CTA per (query row, kv head), the G = Hq / Hkv query heads
// of that kv head sharing its row stream (GQA in the kernel); the R rows of
// a slot are R packed rows (b = n / R), so a catch-up re-reads the slot's
// rows R times. The slot's contiguous rows stream through shared memory in
// 64-row tiles with 16-byte loads (int8: half the bytes of a bf16 tile, the
// tile's scales with 4-byte loads); scores, running max, denominator and
// the accumulator stay in float32 in shared memory, and the output is
// written once. With a window a row reads only the tiles from its window
// start's on. This first version does not overlap copy and arithmetic, uses
// no tensor cores and does not split long rows across CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 8;
constexpr int kTile = 64;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_float<int8_t>(int8_t x) {
  return (float)x;
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int clamp_rows(int x, int hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// Shared memory: K tile, V tile [kTile, D] (TC), then float32 q [G, D],
// scores [G, kTile], acc [G, D], m [G], l [G], corr [G], and for an int8
// cache the tile's K and V scales [kTile] each.
// out: [B * R, Hq, D] of T, or with kStats float32 acc beside m_out and
// l_out [B, Hq] float32.
template <typename T, typename TC, bool kWindow, bool kBlock, bool kStats>
__global__ void __launch_bounds__(kThreads)
dense_attention_kernel(void* __restrict__ out, float* __restrict__ m_out,
                       float* __restrict__ l_out, const T* __restrict__ q,
                       const TC* __restrict__ cache_k,
                       const TC* __restrict__ cache_v,
                       const float* __restrict__ cache_ks,
                       const float* __restrict__ cache_vs,
                       const int32_t* __restrict__ limits, int layer,
                       int n_slots, int hkv, int seq, int d, int groups,
                       int r_rows, int window, float scale, int bb) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  TC* ks = reinterpret_cast<TC*>(smem);
  TC* vs = ks + kTile * d;
  float* qs = reinterpret_cast<float*>(vs + kTile * d);
  float* sc = qs + groups * d;
  float* acc = sc + groups * kTile;
  float* m_run = acc + groups * d;
  float* l_run = m_run + groups;
  float* corr = l_run + groups;
  float* k_scale = corr + groups;          // kQuant only
  float* v_scale = k_scale + kTile;

  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hq = hkv * groups;

  // the batch-blocked form walks its block's union tile range
  int block_lo = 0, block_hi = 0;
  if (kBlock) {
    block_lo = seq;
    for (int i = 0; i < bb; ++i) {
      const int lim_i = limits[blockIdx.x * bb + i];
      const int ext_i = clamp_rows(lim_i, seq);
      block_hi = ext_i > block_hi ? ext_i : block_hi;
      const int ws = kWindow && lim_i - window > 0 ? lim_i - window : 0;
      const int lo_i = ws / kTile * kTile;
      block_lo = lo_i < block_lo ? lo_i : block_lo;
    }
  }

  for (int i = 0; i < (kBlock ? bb : 1); ++i) {
    // packed row b * R + r (the batch-blocked form: R = 1, row = slot)
    const int n = kBlock ? blockIdx.x * bb + i : blockIdx.x;
    const int b = n / r_rows;
    const int lim = limits[b] + (n - b * r_rows);
    const int extent = clamp_rows(lim, seq);
    // window: live rows from wstart on; tiles below its tile never read
    // (the batch-blocked form: below the block's lowest window start)
    int wstart = 0;
    if (kWindow) wstart = lim - window > 0 ? lim - window : 0;

    if (kBlock && i > 0) __syncthreads();   // the last slot's output read
    const T* q_row = q + ((int64_t)n * hq + (int64_t)h * groups) * d;
    for (int x = tid; x < groups * d; x += kThreads) {
      qs[x] = to_float(q_row[x]) * scale;
      acc[x] = 0.f;
    }
    if (tid < groups) {
      m_run[tid] = kNegInf;
      l_run[tid] = 0.f;
    }

    const int64_t head_row0 =
        (((int64_t)layer * n_slots + b) * hkv + h) * (int64_t)seq;
    const int c_begin =
        kBlock ? block_lo : (kWindow ? wstart / kTile * kTile : 0);
    const int c_end = kBlock ? block_hi : extent;
    for (int c0 = c_begin; c0 < c_end; c0 += kTile) {
      const int nr = extent - c0 < kTile ? extent - c0 : kTile;
      if (kBlock && nr <= 0) break;        // past this slot's own limit
      const int64_t base = (head_row0 + c0) * d;
      const uint4* k_src = reinterpret_cast<const uint4*>(cache_k + base);
      const uint4* v_src = reinterpret_cast<const uint4*>(cache_v + base);
      uint4* k_dst = reinterpret_cast<uint4*>(ks);
      uint4* v_dst = reinterpret_cast<uint4*>(vs);
      const int vecs = nr * d * (int)sizeof(TC) / 16;
      for (int x = tid; x < vecs; x += kThreads) {
        k_dst[x] = k_src[x];
        v_dst[x] = v_src[x];
      }
      if (kQuant) {
        for (int x = tid; x < nr; x += kThreads) {
          k_scale[x] = cache_ks[head_row0 + c0 + x];
          v_scale[x] = cache_vs[head_row0 + c0 + x];
        }
      }
      __syncthreads();

      // scores: one warp per column, lanes split D, all G heads at once;
      // int8: the dot of the raw values, times the column's K scale
      for (int j = warp; j < nr; j += kWarps) {
        float part[kMaxGroups];
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g) part[g] = 0.f;
        for (int x = lane; x < d; x += 32) {
          const float kv = to_float(ks[j * d + x]);
#pragma unroll
          for (int g = 0; g < kMaxGroups; ++g)
            if (g < groups) part[g] += qs[g * d + x] * kv;
        }
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g) {
          if (g < groups) {
            float s = warp_sum(part[g]);
            if (kQuant) s *= k_scale[j];
            if (lane == 0)
              sc[g * kTile + j] = !kWindow || c0 + j >= wstart ? s : kNegInf;
          }
        }
      }
      __syncthreads();

      // online softmax: one warp per head of the group; l sums the unscaled
      // p, and P.V takes p times the column's V scale (int8); the
      // batch-blocked form gives masked columns p = 0 exactly
      for (int g = warp; g < groups; g += kWarps) {
        float mx = kNegInf;
        for (int j = lane; j < nr; j += 32) mx = fmaxf(mx, sc[g * kTile + j]);
        mx = warp_max(mx);
        const float m_prev = m_run[g];
        const float m_cur = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int j = lane; j < nr; j += 32) {
          const float s = sc[g * kTile + j];
          const float p = kBlock && s == kNegInf ? 0.f : expf(s - m_cur);
          sc[g * kTile + j] = kQuant ? p * v_scale[j] : p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float cr = expf(m_prev - m_cur);
          corr[g] = cr;
          m_run[g] = m_cur;
          l_run[g] = l_run[g] * cr + sum;
        }
      }
      __syncthreads();

      // acc = acc * corr + p @ V, each thread owning columns of D
      for (int x = tid; x < d; x += kThreads) {
        float a[kMaxGroups];
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g)
          a[g] = g < groups ? acc[g * d + x] * corr[g] : 0.f;
        for (int j = 0; j < nr; ++j) {
          const float vv = to_float(vs[j * d + x]);
#pragma unroll
          for (int g = 0; g < kMaxGroups; ++g)
            if (g < groups) a[g] += sc[g * kTile + j] * vv;
        }
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g)
          if (g < groups) acc[g * d + x] = a[g];
      }
      __syncthreads();
    }
    __syncthreads();                   // l of a row that visited no tile

    const int64_t head0 = (int64_t)n * hq + (int64_t)h * groups;
    if (kStats) {
      // the flash triple, unnormalized (K6)
      float* o_row = reinterpret_cast<float*>(out) + head0 * d;
      for (int x = tid; x < groups * d; x += kThreads) o_row[x] = acc[x];
      if (tid < groups) {
        m_out[head0 + tid] = m_run[tid];
        l_out[head0 + tid] = l_run[tid];
      }
    } else {
      T* o_row = reinterpret_cast<T*>(out) + head0 * d;
      for (int x = tid; x < groups * d; x += kThreads) {
        const float l = fmaxf(l_run[x / d], 1e-9f);
        o_row[x] = from_float<T>(acc[x] / l);
      }
    }
  }
}

template <typename T, typename TC, bool kWindow, bool kBlock,
          bool kStats = false>
int launch(void* out, float* m_out, float* l_out, const void* q,
           const void* cache_k, const void* cache_v, const void* cache_ks,
           const void* cache_vs, const void* limits, int n_slots, int hkv,
           int groups, int r_rows, int d, int seq, int layer, int window,
           float scale, int bb, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  const size_t smem =
      2 * (size_t)kTile * d * sizeof(TC) +
      sizeof(float) * ((size_t)groups * (2 * d + kTile) + 3 * (size_t)groups +
                       (kQuant ? 2 * (size_t)kTile : 0));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dense_attention_kernel<T, TC, kWindow, kBlock, kStats>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(kBlock ? n_slots / bb : n_slots * r_rows, hkv);
  dense_attention_kernel<T, TC, kWindow, kBlock, kStats>
      <<<grid, kThreads, smem, stream>>>(
          out, m_out, l_out, (const T*)q, (const TC*)cache_k,
          (const TC*)cache_v,
          (const float*)cache_ks, (const float*)cache_vs,
          (const int32_t*)limits, layer, n_slots, hkv, seq, d, groups,
          r_rows, window, scale, bb);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (q and output): 0 = float32, 1 = bfloat16. cache_dtype: 0 =
// float32, 1 = bfloat16 (both the q type), 2 = int8 with the float32 scale
// caches cache_ks / cache_vs (ignored otherwise). r_rows = R query rows per
// slot. window > 0: sliding window of that many rows; 0: none. bblock > 1:
// the batch-blocked form, bblock slots per CTA (R = 1, bblock dividing
// n_slots). Returns cudaGetLastError() after the launch (0 = launched).
// groups <= 8 and D % 8 == 0 (int8: D % 16 == 0; the wrapper checks).
extern "C" int dense_attention(void* out, const void* q, const void* cache_k,
                               const void* cache_v, const void* cache_ks,
                               const void* cache_vs, const void* limits,
                               int n_slots, int hkv, int groups, int r_rows,
                               int d, int seq, int layer, int window,
                               float scale, int dtype, int cache_dtype,
                               int bblock, void* stream) {
  if (n_slots <= 0 || r_rows <= 0) return 0;
  if (groups < 1 || groups > kMaxGroups || window < 0 || bblock < 1 ||
      (bblock > 1 && (r_rows != 1 || n_slots % bblock)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define DA_ARGS                                                             \
  out, nullptr, nullptr, q, cache_k, cache_v, cache_ks, cache_vs, limits,  \
      n_slots, hkv, groups, r_rows, d, seq, layer
#define DA_LAUNCH(T, TC)                                                    \
  if (bblock > 1)                                                           \
    return window > 0                                                       \
        ? launch<T, TC, true, true>(DA_ARGS, window, scale, bblock, s)      \
        : launch<T, TC, false, true>(DA_ARGS, 0, scale, bblock, s);         \
  return window > 0 ? launch<T, TC, true, false>(DA_ARGS, window, scale, 1, \
                                                 s)                         \
                    : launch<T, TC, false, false>(DA_ARGS, 0, scale, 1, s)
  if (dtype == 1 && cache_dtype == 1) { DA_LAUNCH(__nv_bfloat16, __nv_bfloat16); }
  if (dtype == 0 && cache_dtype == 0) { DA_LAUNCH(float, float); }
  if (dtype == 1 && cache_dtype == 2) { DA_LAUNCH(__nv_bfloat16, int8_t); }
  if (dtype == 0 && cache_dtype == 2) { DA_LAUNCH(float, int8_t); }
#undef DA_LAUNCH
#undef DA_ARGS
  return (int)cudaErrorInvalidValue;
}

// K6, the stats form: acc [n_slots, Hq, D], m and l [n_slots, Hq], all
// float32; one query row per slot (q [n_slots, 1, Hq, D]), no window, no
// block; limits = each slot's rows in this cache (shard). dtype and
// cache_dtype as above. Returns cudaGetLastError() after the launch.
extern "C" int dense_attention_stats(void* acc, void* m, void* l,
                                     const void* q, const void* cache_k,
                                     const void* cache_v,
                                     const void* cache_ks,
                                     const void* cache_vs,
                                     const void* limits, int n_slots, int hkv,
                                     int groups, int d, int seq, int layer,
                                     float scale, int dtype, int cache_dtype,
                                     void* stream) {
  if (n_slots <= 0) return 0;
  if (groups < 1 || groups > kMaxGroups) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define DS_LAUNCH(T, TC)                                                     \
  return launch<T, TC, false, false, true>(                                  \
      acc, (float*)m, (float*)l, q, cache_k, cache_v, cache_ks, cache_vs,    \
      limits, n_slots, hkv, groups, 1, d, seq, layer, 0, scale, 1, s)
  if (dtype == 1 && cache_dtype == 1) { DS_LAUNCH(__nv_bfloat16, __nv_bfloat16); }
  if (dtype == 0 && cache_dtype == 0) { DS_LAUNCH(float, float); }
  if (dtype == 1 && cache_dtype == 2) { DS_LAUNCH(__nv_bfloat16, int8_t); }
  if (dtype == 0 && cache_dtype == 2) { DS_LAUNCH(float, int8_t); }
#undef DS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
