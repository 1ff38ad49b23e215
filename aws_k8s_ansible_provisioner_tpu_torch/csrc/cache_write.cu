// K/V row writes: one new K row and one new V row per packed query row,
// written in place into the page pool; copied as they are
// (cache_write_rows_paged) or quantized to int8 with a float32 scale per
// row and kv head (cache_write_rows_quant_paged). And the dense slot
// cache's two writes, R rows per slot: the copy (cache_write_rows_dense)
// and the quantizing write (cache_write_rows_quant_dense).
//
// Replaces: aws_k8s_ansible_provisioner_tpu/ops/pallas_attention.py:
//   cache_write_row_paged and cache_write_row_quant_paged (each called once
//   for K and once for V per layer), cache_write_row (the dense cache, once
//   for K and once for V per layer and per verify row), and
//   cache_write_row_quant (the dense int8 cache, the same calls).
//
// Contract (same as the TPU kernel): pool [L, P, Hkv, ps, D]; new rows
// [N, Hkv, D]; rows [N] int32; table [N, max_pages] int32. Row n lands at
// page table[n, rows[n] / ps], offset rows[n] % ps. A row outside
// [0, max_pages * ps) is dropped, and that check comes BEFORE the table is
// read: padding tables hold OOB_PAGE (INT32_MAX) and mixed_step's dead
// passenger carries row -1. A page id outside [0, P) is dropped as well.
//
// What bounds it on the H100: bytes. It moves N * Hkv * D * elem bytes in
// and the same out, for K and for V, and does no arithmetic. The design
// keeps those bytes in as few transactions as the layout allows: one CTA per
// packed row; each thread copies 16 bytes, so a warp covers 512 contiguous
// bytes of a head row (one D=128 bf16 row is 256 bytes); K and V go in one
// launch (the attention paths always write both). The copy is byte-exact,
// so one kernel serves bf16 and float32 pools.
//
// The quantizing writes follow serving/kv_cache.py's quantize_rows as the
// JAX engine's compiled programs compute it: per (row, kv head),
// scale = max(amax, 1e-6) * float32(1/127) (XLA turns the division by the
// constant into that product), q = round_half_even(x / scale) with an IEEE
// division, so their int8 rows and scales are bit-identical to the plain
// version, and rows quantized by the prefill scatters and by these kernels
// are alike. Bytes bound them too: D elements in, D int8 bytes and one
// float32 out per (row, kv head). One CTA per (packed row, K or V); a warp
// per kv head reads the row once into registers, takes amax with a shuffle
// reduction and stores D bytes, 32 neighbouring lanes on 32 neighbouring
// bytes (quantize_row_warp, shared by both). The same drop checks as the
// copies come first. Rows that share a page land at their own offsets,
// every one of them (the Pallas kernel's scale block spans a whole page;
// see ROADMAP C6).
//
// The dense writes' contract (cache_write_row's and cache_write_row_quant's):
// cache [L, B, Hkv, S, D] (int8: scales [L, B, Hkv, S] float32); new rows
// [B, R, Hkv, D]; rows [B, R] int32. Slot b's row r lands at row rows[b, r]
// of slot b; a row outside [0, S) is dropped. Their designs are the paged
// ones with the slot's contiguous rows for the table: one CTA per (slot,
// row), K and V in one launch, so a verify's R rows of one layer are one
// launch where the TPU made 2 R. The Pallas kernels rewrite the row's whole
// 8-row (int8: 32-row) block and, int8, the slot's whole scale row; the
// port writes the row and its scale alone, which is the same result since
// the rest is written back unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 256;
constexpr float kInv127 = 1.0f / 127.0f;

__global__ void cache_write_rows_paged_kernel(
    uint4* __restrict__ pool_k, uint4* __restrict__ pool_v,
    const uint4* __restrict__ k_new, const uint4* __restrict__ v_new,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ table,
    int layer, int num_pages, int hkv, int ps, int vec_per_row,
    int max_pages) {
  const int n = blockIdx.x;
  const int row = rows[n];
  if (row < 0 || row >= max_pages * ps) return;   // dropped: table unread
  const int page = table[(int64_t)n * max_pages + row / ps];
  if (page < 0 || page >= num_pages) return;
  const int off = row % ps;
  const int total = hkv * vec_per_row;
  const int64_t page_base =
      ((int64_t)layer * num_pages + page) * hkv * ps * vec_per_row;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int h = i / vec_per_row;
    const int c = i - h * vec_per_row;
    const int64_t dst = page_base + ((int64_t)h * ps + off) * vec_per_row + c;
    const int64_t src = (int64_t)n * total + i;
    pool_k[dst] = k_new[src];
    pool_v[dst] = v_new[src];
  }
}

__global__ void cache_write_rows_dense_kernel(
    uint4* __restrict__ cache_k, uint4* __restrict__ cache_v,
    const uint4* __restrict__ k_new, const uint4* __restrict__ v_new,
    const int32_t* __restrict__ rows, int r_rows, int layer, int n_slots,
    int hkv, int seq, int vec_per_row) {
  const int i_row = blockIdx.x;                  // b * r_rows + r
  const int b = i_row / r_rows;
  const int row = rows[i_row];
  if (row < 0 || row >= seq) return;             // dropped
  const int total = hkv * vec_per_row;
  const int64_t slot_base = ((int64_t)layer * n_slots + b) * hkv;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int h = i / vec_per_row;
    const int c = i - h * vec_per_row;
    const int64_t dst =
        ((slot_base + h) * seq + row) * (int64_t)vec_per_row + c;
    const int64_t src = (int64_t)i_row * total + i;
    cache_k[dst] = k_new[src];
    cache_v[dst] = v_new[src];
  }
}

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One warp quantizes one (row, kv head) of D values (K3's and K9's shared
// quantizer): the row is read once into registers, amax by a shuffle
// reduction, scale = max(amax, 1e-6) * float32(1/127), then
// round_half_even(x / scale) with an IEEE division, 32 neighbouring lanes
// storing 32 neighbouring bytes; lane 0 stores the scale.
template <typename T>
__device__ __forceinline__ void quantize_row_warp(const T* __restrict__ x,
                                                  int8_t* __restrict__ out,
                                                  float* __restrict__ scale_out,
                                                  int d, int lane) {
  float vals[kMaxD / 32];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i) {
    const int c = lane + 32 * i;
    vals[i] = c < d ? to_float(x[c]) : 0.f;
    amax = fmaxf(amax, fabsf(vals[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = fmaxf(amax, 1e-6f) * kInv127;
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < d) out[c] = (int8_t)rintf(__fdiv_rn(vals[i], scale));
  }
  if (lane == 0) *scale_out = scale;
}

template <typename T>
__global__ void cache_write_rows_quant_kernel(
    int8_t* __restrict__ pool_k, int8_t* __restrict__ pool_v,
    float* __restrict__ scale_k, float* __restrict__ scale_v,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ table,
    int layer, int num_pages, int hkv, int ps, int d, int max_pages) {
  const int n = blockIdx.x;
  const bool is_v = blockIdx.y == 1;
  const int row = rows[n];
  if (row < 0 || row >= max_pages * ps) return;   // dropped: table unread
  const int page = table[(int64_t)n * max_pages + row / ps];
  if (page < 0 || page >= num_pages) return;
  const int off = row % ps;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const T* src = (is_v ? v_new : k_new) + (int64_t)n * hkv * d;
  int8_t* pool = is_v ? pool_v : pool_k;
  float* scales = is_v ? scale_v : scale_k;
  for (int h = threadIdx.x >> 5; h < hkv; h += warps) {
    const int64_t dst = ((((int64_t)layer * num_pages + page) * hkv + h) * ps
                         + off);
    quantize_row_warp(src + (int64_t)h * d, pool + dst * d, scales + dst, d,
                      lane);
  }
}

// K9: the dense cache's quantizing write. One CTA per (slot, row) and K or
// V, a warp per kv head.
template <typename T>
__global__ void cache_write_rows_quant_dense_kernel(
    int8_t* __restrict__ cache_k, int8_t* __restrict__ cache_v,
    float* __restrict__ scale_k, float* __restrict__ scale_v,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    const int32_t* __restrict__ rows, int r_rows, int layer, int n_slots,
    int hkv, int seq, int d) {
  const int i_row = blockIdx.x;                  // b * r_rows + r
  const bool is_v = blockIdx.y == 1;
  const int b = i_row / r_rows;
  const int row = rows[i_row];
  if (row < 0 || row >= seq) return;             // dropped
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const T* src = (is_v ? v_new : k_new) + (int64_t)i_row * hkv * d;
  int8_t* cache = is_v ? cache_v : cache_k;
  float* scales = is_v ? scale_v : scale_k;
  const int64_t slot_base = ((int64_t)layer * n_slots + b) * hkv;
  for (int h = threadIdx.x >> 5; h < hkv; h += warps) {
    const int64_t dst = (slot_base + h) * seq + row;
    quantize_row_warp(src + (int64_t)h * d, cache + dst * d, scales + dst, d,
                      lane);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
// row_bytes = D * element size; a multiple of 16 (the wrapper checks).
extern "C" int cache_write_rows_paged(
    void* pool_k, void* pool_v, const void* k_new, const void* v_new,
    const void* rows, const void* table, int n_rows, int layer,
    int num_pages, int hkv, int ps, int row_bytes, int max_pages,
    void* stream) {
  if (n_rows <= 0) return 0;
  const int vec_per_row = row_bytes / 16;
  int threads = hkv * vec_per_row;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  cache_write_rows_paged_kernel<<<n_rows, threads, 0,
                                  (cudaStream_t)stream>>>(
      (uint4*)pool_k, (uint4*)pool_v, (const uint4*)k_new,
      (const uint4*)v_new, (const int32_t*)rows, (const int32_t*)table,
      layer, num_pages, hkv, ps, vec_per_row, max_pages);
  return (int)cudaGetLastError();
}

// Quantizing row write into an int8 pool and its float32 scale pools
// [L, P, Hkv, ps]. dtype of the new rows: 0 = float32, 1 = bfloat16.
// D <= 256 (the wrapper checks). Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int cache_write_rows_quant_paged(
    void* pool_k, void* pool_v, void* scale_k, void* scale_v,
    const void* k_new, const void* v_new, const void* rows,
    const void* table, int n_rows, int layer, int num_pages, int hkv,
    int ps, int d, int max_pages, int dtype, void* stream) {
  if (n_rows <= 0) return 0;
  if (d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  int threads = 32 * hkv;
  threads = threads > 1024 ? 1024 : threads;
  dim3 grid(n_rows, 2);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    cache_write_rows_quant_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        (int8_t*)pool_k, (int8_t*)pool_v, (float*)scale_k, (float*)scale_v,
        (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
        (const int32_t*)rows, (const int32_t*)table, layer, num_pages, hkv,
        ps, d, max_pages);
  } else if (dtype == 0) {
    cache_write_rows_quant_kernel<float><<<grid, threads, 0, s>>>(
        (int8_t*)pool_k, (int8_t*)pool_v, (float*)scale_k, (float*)scale_v,
        (const float*)k_new, (const float*)v_new, (const int32_t*)rows,
        (const int32_t*)table, layer, num_pages, hkv, ps, d, max_pages);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Dense slot cache [L, n_slots, Hkv, seq, D]: new rows [n_slots, r_rows,
// Hkv, D] at rows [n_slots, r_rows]. row_bytes = D * element size; a
// multiple of 16 (the wrapper checks). Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int cache_write_rows_dense(
    void* cache_k, void* cache_v, const void* k_new, const void* v_new,
    const void* rows, int n_slots, int r_rows, int layer, int hkv, int seq,
    int row_bytes, void* stream) {
  if (n_slots <= 0 || r_rows <= 0) return 0;
  const int vec_per_row = row_bytes / 16;
  int threads = hkv * vec_per_row;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  cache_write_rows_dense_kernel<<<n_slots * r_rows, threads, 0,
                                  (cudaStream_t)stream>>>(
      (uint4*)cache_k, (uint4*)cache_v, (const uint4*)k_new,
      (const uint4*)v_new, (const int32_t*)rows, r_rows, layer, n_slots, hkv,
      seq, vec_per_row);
  return (int)cudaGetLastError();
}

// K9: quantizing write into the dense int8 cache [L, n_slots, Hkv, seq, D]
// and its float32 scales [L, n_slots, Hkv, seq]: new rows [n_slots, r_rows,
// Hkv, D] (dtype 0 = float32, 1 = bfloat16) at rows [n_slots, r_rows]; K
// and V in one launch. D <= 256 (the wrapper checks). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int cache_write_rows_quant_dense(
    void* cache_k, void* cache_v, void* scale_k, void* scale_v,
    const void* k_new, const void* v_new, const void* rows, int n_slots,
    int r_rows, int layer, int hkv, int seq, int d, int dtype, void* stream) {
  if (n_slots <= 0 || r_rows <= 0) return 0;
  if (d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  int threads = 32 * hkv;
  threads = threads > 1024 ? 1024 : threads;
  dim3 grid(n_slots * r_rows, 2);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    cache_write_rows_quant_dense_kernel<__nv_bfloat16>
        <<<grid, threads, 0, s>>>(
            (int8_t*)cache_k, (int8_t*)cache_v, (float*)scale_k,
            (float*)scale_v, (const __nv_bfloat16*)k_new,
            (const __nv_bfloat16*)v_new, (const int32_t*)rows, r_rows, layer,
            n_slots, hkv, seq, d);
  } else if (dtype == 0) {
    cache_write_rows_quant_dense_kernel<float><<<grid, threads, 0, s>>>(
        (int8_t*)cache_k, (int8_t*)cache_v, (float*)scale_k, (float*)scale_v,
        (const float*)k_new, (const float*)v_new, (const int32_t*)rows,
        r_rows, layer, n_slots, hkv, seq, d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
