// Paged flash attention with per-row (table row, live-column limit), over a
// bf16/f32 pool or an int8 pool with per-row float32 scales, with or without
// a sliding window.
//
// Replaces: aws_k8s_ansible_provisioner_tpu/ops/pallas_attention.py:
//   _paged_flash_db / _paged_db_body, the body behind
//   decode_attend_pallas_paged and ragged_attend_pallas_paged (R=1) and
//   decode_attend_pallas_spec_paged (spec=True, R>1): the bf16 body
//   _paged_db_kernel and the int8 scale-folding body _paged_db_kernel_quant,
//   each at window 0 and window > 0. The speculative verify's R rows per
//   slot come in as R packed rows, row (b, r) with limit lengths[b] + 1 + r
//   and slot b's table row.
//
// Contract (same as the TPU kernel): q [N, Hq, D]; pools [L, P, Hkv, ps, D];
// limits [N] int32; table [N, max_pages] int32; output [N, Hq, D] in q's
// type. Query row n visits its logical pages lo .. hi with
// hi = min(max(cdiv(limit, ps) - 1, 0), max_pages - 1) and lo = 0, or with a
// window lo = min(max(limit - window, 0) / ps, hi), and reads no table entry
// and no page outside that range; its live columns are
// [limit - window, limit) (window 0: [0, limit)), the others are masked with
// NEG_INF = -1e30. Online softmax in float32 with the scale 1/sqrt(D) folded
// into q; output acc / max(l, 1e-9). A row with limit <= 0 still visits page
// table[n, 0] with every column masked, so p = exp(0) = 1 there and the row
// returns the mean of V over that page, exactly as the TPU kernel does
// (mixed_step's dead passenger row; its output is discarded). Page ids are
// clamped into [0, P), as Pallas clamps a block index.
//
// The window: the TPU verify starts all R rows of a slot at row 0's window
// start; here each packed row starts at its own. The result is the same: a
// page that is wholly masked for a row leaves m = -1e30, and the row's first
// live page then scales what it summed by exp(-1e30 - m) = 0. Window 0 is
// its own instance (kWindow false) with no window arithmetic in it.
//
// Int8 pools (scale pools ks, vs [L, P, Hkv, ps] float32) fold the scales
// into the flash loop in the TPU body's order and never build a dequantized
// copy: s = (q * 1/sqrt(D)) . k_int8 * kscale[col], then the mask and the
// online max; l sums the UNSCALED p, and p * vscale[col] enters P.V.
//
// What bounds it on the H100: bytes. A decode row reads its live K and V
// pages once (2 * ps * D * elem bytes per page and kv head, plus 2 * ps * 4
// bytes of scales for int8) and does 4 * G * D flops per column, about one
// flop per byte against the card's ~295 flop/byte ridge. The design keeps
// every byte read exactly once per (row, kv head): one CTA per (query row,
// kv head) and the G = Hq / Hkv query heads of that kv head share its page
// stream (GQA in the kernel); a page tile of K and V is copied into shared
// memory with 16-byte loads (the page's scales with 4-byte loads), scores,
// running max, denominator and the accumulator stay in float32 in shared
// memory, and the output is written once. An int8 pool halves the tile's
// bytes; the values are converted to float32 as they are read from shared
// memory. With a window a row reads only the pages from its window start
// on (Mistral's 4096 columns: 65 of up to 128 pages of 64). This first
// version does not overlap the next page's copy with the current page's
// arithmetic, uses no tensor cores, and does not split long rows across
// CTAs; rows that share a slot (chunk rows, a verify's R rows) re-read that
// slot's pages. Those are the known costs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 8;

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

// Shared memory: K tile, V tile [ps, D] (TP), then float32 q [G, D],
// scores [G, ps], acc [G, D], m [G], l [G], corr [G], and for an int8 pool
// the page's K and V scales [ps] each.
template <typename T, typename TP, bool kWindow>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(T* __restrict__ out, const T* __restrict__ q,
                       const TP* __restrict__ pool_k,
                       const TP* __restrict__ pool_v,
                       const float* __restrict__ pool_ks,
                       const float* __restrict__ pool_vs,
                       const int32_t* __restrict__ limits,
                       const int32_t* __restrict__ table, int layer,
                       int num_pages, int hkv, int ps, int d, int groups,
                       int max_pages, int window, float scale) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  TP* ks = reinterpret_cast<TP*>(smem);
  TP* vs = ks + ps * d;
  float* qs = reinterpret_cast<float*>(vs + ps * d);
  float* sc = qs + groups * d;
  float* acc = sc + groups * ps;
  float* m_run = acc + groups * d;
  float* l_run = m_run + groups;
  float* corr = l_run + groups;
  float* k_scale = corr + groups;          // kQuant only
  float* v_scale = k_scale + ps;

  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hq = hkv * groups;

  const int limit = limits[n];
  int hi = limit > 0 ? (limit + ps - 1) / ps - 1 : 0;
  hi = hi < max_pages - 1 ? hi : max_pages - 1;
  // window: live columns from wstart on; pages below its page never read
  const int wstart = kWindow ? limit - window : 0;
  int lo = 0;
  if (kWindow) {
    lo = (wstart > 0 ? wstart : 0) / ps;
    lo = lo < hi ? lo : hi;
  }

  const T* q_row = q + ((int64_t)n * hq + (int64_t)h * groups) * d;
  for (int i = tid; i < groups * d; i += kThreads) {
    qs[i] = to_float(q_row[i]) * scale;
    acc[i] = 0.f;
  }
  if (tid < groups) {
    m_run[tid] = kNegInf;
    l_run[tid] = 0.f;
  }

  const int tile_vecs = ps * d * (int)sizeof(TP) / 16;
  const int32_t* table_row = table + (int64_t)n * max_pages;
  for (int c = lo; c <= hi; ++c) {
    int page = table_row[c];
    page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
    const int64_t head = ((int64_t)layer * num_pages + page) * hkv + h;
    const int64_t base = head * (int64_t)ps * d;
    const uint4* k_src = reinterpret_cast<const uint4*>(pool_k + base);
    const uint4* v_src = reinterpret_cast<const uint4*>(pool_v + base);
    uint4* k_dst = reinterpret_cast<uint4*>(ks);
    uint4* v_dst = reinterpret_cast<uint4*>(vs);
    for (int i = tid; i < tile_vecs; i += kThreads) {
      k_dst[i] = k_src[i];
      v_dst[i] = v_src[i];
    }
    if (kQuant) {
      for (int i = tid; i < ps; i += kThreads) {
        k_scale[i] = pool_ks[head * ps + i];
        v_scale[i] = pool_vs[head * ps + i];
      }
    }
    __syncthreads();

    // scores: one warp per column, lanes split D, all G heads at once;
    // int8: the dot of the raw values, times the column's K scale
    for (int j = warp; j < ps; j += kWarps) {
      float part[kMaxGroups];
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) part[g] = 0.f;
      for (int x = lane; x < d; x += 32) {
        const float kv = to_float(ks[j * d + x]);
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g)
          if (g < groups) part[g] += qs[g * d + x] * kv;
      }
      const int col = c * ps + j;
      const bool live = col < limit && (!kWindow || col >= wstart);
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        if (g < groups) {
          float s = warp_sum(part[g]);
          if (kQuant) s *= k_scale[j];
          if (lane == 0) sc[g * ps + j] = live ? s : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per head of the group; l sums the unscaled
    // p, and P.V takes p times the column's V scale (int8)
    for (int g = warp; g < groups; g += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < ps; j += 32) mx = fmaxf(mx, sc[g * ps + j]);
      mx = warp_max(mx);
      const float m_prev = m_run[g];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < ps; j += 32) {
        const float p = expf(sc[g * ps + j] - m_cur);
        sc[g * ps + j] = kQuant ? p * v_scale[j] : p;
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
      for (int j = 0; j < ps; ++j) {
        const float vv = to_float(vs[j * d + x]);
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g)
          if (g < groups) a[g] += sc[g * ps + j] * vv;
      }
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g)
        if (g < groups) acc[g * d + x] = a[g];
    }
    __syncthreads();
  }

  T* o_row = out + ((int64_t)n * hq + (int64_t)h * groups) * d;
  for (int i = tid; i < groups * d; i += kThreads) {
    const float l = fmaxf(l_run[i / d], 1e-9f);
    o_row[i] = from_float<T>(acc[i] / l);
  }
}

template <typename T, typename TP, bool kWindow>
int launch(void* out, const void* q, const void* pool_k, const void* pool_v,
           const void* pool_ks, const void* pool_vs, const void* limits,
           const void* table, int n_rows, int hkv, int groups, int d,
           int num_pages, int ps, int max_pages, int layer, int window,
           float scale, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  const size_t smem = 2 * (size_t)ps * d * sizeof(TP) +
                      sizeof(float) * ((size_t)groups * (2 * d + ps) +
                                       3 * (size_t)groups +
                                       (kQuant ? 2 * (size_t)ps : 0));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, TP, kWindow>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_rows, hkv);
  paged_attention_kernel<T, TP, kWindow><<<grid, kThreads, smem, stream>>>(
      (T*)out, (const T*)q, (const TP*)pool_k, (const TP*)pool_v,
      (const float*)pool_ks, (const float*)pool_vs, (const int32_t*)limits,
      (const int32_t*)table, layer, num_pages, hkv, ps, d, groups, max_pages,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (q and output): 0 = float32, 1 = bfloat16. pool_dtype: 0 = float32,
// 1 = bfloat16 (both the q type), 2 = int8 with the float32 scale pools
// pool_ks / pool_vs (ignored otherwise). window > 0: sliding window of that
// many columns; 0: none. Returns cudaGetLastError() after the launch (0 =
// launched). groups <= 8, D % 8 == 0 and, for int8, D % 16 == 0 (the
// wrapper checks).
extern "C" int paged_attention(void* out, const void* q, const void* pool_k,
                               const void* pool_v, const void* pool_ks,
                               const void* pool_vs, const void* limits,
                               const void* table, int n_rows, int hkv,
                               int groups, int d, int num_pages, int ps,
                               int max_pages, int layer, int window,
                               float scale, int dtype, int pool_dtype,
                               void* stream) {
  if (n_rows <= 0) return 0;
  if (groups < 1 || groups > kMaxGroups || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PA_LAUNCH(T, TP)                                                    \
  return window > 0                                                         \
      ? launch<T, TP, true>(out, q, pool_k, pool_v, pool_ks, pool_vs,       \
                            limits, table, n_rows, hkv, groups, d,          \
                            num_pages, ps, max_pages, layer, window, scale, \
                            s)                                              \
      : launch<T, TP, false>(out, q, pool_k, pool_v, pool_ks, pool_vs,      \
                             limits, table, n_rows, hkv, groups, d,         \
                             num_pages, ps, max_pages, layer, 0, scale, s)
  if (dtype == 1 && pool_dtype == 1) PA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 0 && pool_dtype == 0) PA_LAUNCH(float, float);
  if (dtype == 1 && pool_dtype == 2) PA_LAUNCH(__nv_bfloat16, int8_t);
  if (dtype == 0 && pool_dtype == 2) PA_LAUNCH(float, int8_t);
#undef PA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
