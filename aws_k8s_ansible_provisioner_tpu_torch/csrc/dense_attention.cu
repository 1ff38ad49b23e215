// Flash attention over one layer of the dense slot cache [L, B, Hkv, S, D]
// (the draft model's cache), bf16 or float32, with or without a sliding
// window.
//
// Replaces: aws_k8s_ansible_provisioner_tpu/ops/pallas_attention.py:
//   decode_attend_pallas_layer with bblock 1 (its body _decode_kernel_layer)
//   and decode_attend_pallas_spec (_spec_accumulate through
//   _spec_kernel_plain), each at window 0 and window > 0. Their int8 bodies
//   are not ported here.
//
// Contract (same as the TPU kernels): q [B, R, Hq, D], R query rows per slot
// (R = 1 for a decode step, R > 1 for a speculative catch-up); cache_k/v
// [L, B, Hkv, S, D]; limits [B] int32; output [B, R, Hq, D] in q's type.
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
// What bounds it on the H100: bytes. A query row reads its slot's live K
// and V rows (2 * D * elem bytes per row and kv head) and does 4 * G * D
// flops per column, about one flop per byte against the card's ~295
// flop/byte ridge. The design is the paged kernel's: one CTA per (query row,
// kv head), the G = Hq / Hkv query heads of that kv head sharing its row
// stream (GQA in the kernel); the R rows of a slot are R packed rows
// (b = n / R), so a catch-up re-reads the slot's rows R times. The slot's
// contiguous rows stream through shared memory in 64-row tiles with 16-byte
// loads; scores, running max, denominator and the accumulator stay in
// float32 in shared memory, and the output is written once. With a window a
// row reads only the tiles from its window start's on. This first version
// does not overlap copy and arithmetic, uses no tensor cores and does not
// split long rows across CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Shared memory: K tile, V tile [kTile, D] (T), then float32 q [G, D],
// scores [G, kTile], acc [G, D], m [G], l [G], corr [G].
template <typename T, bool kWindow>
__global__ void __launch_bounds__(kThreads)
dense_attention_kernel(T* __restrict__ out, const T* __restrict__ q,
                       const T* __restrict__ cache_k,
                       const T* __restrict__ cache_v,
                       const int32_t* __restrict__ limits, int layer,
                       int n_slots, int hkv, int seq, int d, int groups,
                       int r_rows, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kTile * d;
  float* qs = reinterpret_cast<float*>(vs + kTile * d);
  float* sc = qs + groups * d;
  float* acc = sc + groups * kTile;
  float* m_run = acc + groups * d;
  float* l_run = m_run + groups;
  float* corr = l_run + groups;

  const int n = blockIdx.x;                      // packed row b * R + r
  const int b = n / r_rows;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hq = hkv * groups;

  const int lim = limits[b] + (n - b * r_rows);
  const int extent = lim < 0 ? 0 : (lim > seq ? seq : lim);
  // window: live rows from wstart on; tiles below its tile never read
  int wstart = 0;
  if (kWindow) wstart = lim - window > 0 ? lim - window : 0;

  const T* q_row = q + ((int64_t)n * hq + (int64_t)h * groups) * d;
  for (int i = tid; i < groups * d; i += kThreads) {
    qs[i] = to_float(q_row[i]) * scale;
    acc[i] = 0.f;
  }
  if (tid < groups) {
    m_run[tid] = -1e30f;
    l_run[tid] = 0.f;
  }

  const int64_t head_row0 =
      (((int64_t)layer * n_slots + b) * hkv + h) * (int64_t)seq;
  for (int c0 = kWindow ? wstart / kTile * kTile : 0; c0 < extent;
       c0 += kTile) {
    const int nr = extent - c0 < kTile ? extent - c0 : kTile;
    const int64_t base = (head_row0 + c0) * d;
    const uint4* k_src = reinterpret_cast<const uint4*>(cache_k + base);
    const uint4* v_src = reinterpret_cast<const uint4*>(cache_v + base);
    uint4* k_dst = reinterpret_cast<uint4*>(ks);
    uint4* v_dst = reinterpret_cast<uint4*>(vs);
    const int vecs = nr * d * (int)sizeof(T) / 16;
    for (int i = tid; i < vecs; i += kThreads) {
      k_dst[i] = k_src[i];
      v_dst[i] = v_src[i];
    }
    __syncthreads();

    // scores: one warp per column, lanes split D, all G heads at once
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
          const float s = warp_sum(part[g]);
          if (lane == 0)
            sc[g * kTile + j] = !kWindow || c0 + j >= wstart ? s : -1e30f;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per head of the group
    for (int g = warp; g < groups; g += kWarps) {
      float mx = -1e30f;
      for (int j = lane; j < nr; j += 32) mx = fmaxf(mx, sc[g * kTile + j]);
      mx = warp_max(mx);
      const float m_prev = m_run[g];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < nr; j += 32) {
        const float p = expf(sc[g * kTile + j] - m_cur);
        sc[g * kTile + j] = p;
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
  __syncthreads();                     // l of a row that visited no tile

  T* o_row = out + ((int64_t)n * hq + (int64_t)h * groups) * d;
  for (int i = tid; i < groups * d; i += kThreads) {
    const float l = fmaxf(l_run[i / d], 1e-9f);
    o_row[i] = from_float<T>(acc[i] / l);
  }
}

template <typename T, bool kWindow>
int launch(void* out, const void* q, const void* cache_k, const void* cache_v,
           const void* limits, int n_slots, int hkv, int groups, int r_rows,
           int d, int seq, int layer, int window, float scale,
           cudaStream_t stream) {
  const size_t smem =
      2 * (size_t)kTile * d * sizeof(T) +
      sizeof(float) * ((size_t)groups * (2 * d + kTile) + 3 * (size_t)groups);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dense_attention_kernel<T, kWindow>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_slots * r_rows, hkv);
  dense_attention_kernel<T, kWindow><<<grid, kThreads, smem, stream>>>(
      (T*)out, (const T*)q, (const T*)cache_k, (const T*)cache_v,
      (const int32_t*)limits, layer, n_slots, hkv, seq, d, groups, r_rows,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (q, cache and output): 0 = float32, 1 = bfloat16. r_rows = R query
// rows per slot. window > 0: sliding window of that many rows; 0: none.
// Returns cudaGetLastError() after the launch (0 = launched). groups <= 8
// and D % 8 == 0 (the wrapper checks).
extern "C" int dense_attention(void* out, const void* q, const void* cache_k,
                               const void* cache_v, const void* limits,
                               int n_slots, int hkv, int groups, int r_rows,
                               int d, int seq, int layer, int window,
                               float scale, int dtype, void* stream) {
  if (n_slots <= 0 || r_rows <= 0) return 0;
  if (groups < 1 || groups > kMaxGroups || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define DA_LAUNCH(T)                                                        \
  return window > 0                                                         \
      ? launch<T, true>(out, q, cache_k, cache_v, limits, n_slots, hkv,     \
                        groups, r_rows, d, seq, layer, window, scale, s)    \
      : launch<T, false>(out, q, cache_k, cache_v, limits, n_slots, hkv,    \
                         groups, r_rows, d, seq, layer, 0, scale, s)
  if (dtype == 1) DA_LAUNCH(__nv_bfloat16);
  if (dtype == 0) DA_LAUNCH(float);
#undef DA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
