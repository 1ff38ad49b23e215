// K/V row writes: one new K row and one new V row per packed query row,
// written in place into the page pool or the dense slot cache; copied as
// they are or quantized to int8 with a float32 scale per row and kv head;
// and the same writes with the layer's q/k prologue fused in (the q/k
// RMSNorm of Qwen3 and RoPE on q and k in the launch that writes K and V).
// One kernel serves all six entries: cache_write_rows_paged (K2),
// cache_write_rows_quant_paged (K3), prep_write_rows_paged (both with the
// prologue), cache_write_rows_dense (K8), cache_write_rows_quant_dense (K9)
// and prep_write_rows_dense (both with the prologue).
//
// Replaces: aws_k8s_ansible_provisioner_tpu/ops/pallas_attention.py:
//   cache_write_row_paged and cache_write_row_quant_paged (each called once
//   for K and once for V per layer, after models/layers.py's rms_norm and
//   apply_rope of q and k), cache_write_row (the dense cache, once for K and
//   once for V per layer and per verify row, after the same prologue), and
//   cache_write_row_quant (the dense int8 cache, the same calls).
//
// The paged contract (same as the TPU kernel): pool [L, P, Hkv, ps, D]; new
// rows [N, Hkv, D]; rows [N] int32; table [N, max_pages] int32. Row n lands
// at page table[n, rows[n] / ps], offset rows[n] % ps. A row outside
// [0, max_pages * ps) is dropped, and that check comes BEFORE the table is
// read: padding tables hold OOB_PAGE (INT32_MAX) and mixed_step's dead
// passenger carries row -1. A page id outside [0, P) is dropped as well.
//
// The dense contract (cache_write_row's and cache_write_row_quant's): cache
// [L, B, Hkv, S, D] (int8: scales [L, B, Hkv, S] float32); new rows
// [B, R, Hkv, D] packed as N = B R rows; rows [B, R] int32. Packed row
// n = b R + r lands at row rows[n] of slot b: the paged address with page
// b, a page size of S and no table read (RowWrite::r_rows > 0). A row
// outside [0, S) is dropped. The Pallas kernels rewrite the row's whole
// 8-row (int8: 32-row) block and, int8, the slot's whole scale row; the
// port writes the row and its scale alone, which is the same result since
// the rest is written back unchanged. A verify's R rows of one layer are
// one launch where the TPU made 2 R.
//
// The kernel, cache_write_rows_kernel, runs with the prologue on (PREP) or
// off, copying or quantizing (QUANT). One CTA of 8 warps per (packed row,
// group of 8 heads), one warp per head row: with the prologue the row's Hq
// q heads, then its Hkv k heads, then its Hkv v heads (the layer's raw
// projections); without it the k and v heads. A warp holds its head row in
// registers, E contiguous elements a lane, E the power of two from 1 to 8
// with 32 E >= D (D a multiple of 16 up to 256: at D = 128 four, loaded in
// 8 bytes; at Phi-2's 80 four on 20 lanes, the other 12 masked), and
// - q and k (prologue on): the norm (when the caller passes weights) as
//   sum of squares by a shuffle reduction (masked lanes add 0),
//   rsqrtf(sum / D + eps), times the weight, rounded to the rows' type;
//   then RoPE in float32 on that rounded value over the first r columns
//   (the rotary width: D, Phi-2's 32 of 80, or 0 with learned positions)
//   with the caller's float32 cos/sin tables [N, r]: x * cos +
//   rotate_half(x) * sin, where rotate_half's partner of column c < r is
//   c +- r / 2, taken from its lane by a shuffle (at r / 2 = 16 E the lane
//   16 away, as at Qwen3's D 128; any even r reaches it); rounded again.
//   Columns >= r pass through as the norm rounded them (or as they
//   came).
//   Each product and sum rounds on its own (__fmul_rn, __fadd_rn) as the
//   plain version's separate operations do; only the order of the sum of
//   squares differs from it. q goes out to q_out for every row, kept or
//   dropped;
// - k and v of a kept row are stored into the cache, or quantized
//   (quant_scale_warp, quant_code) and stored with their scale.
// Without the prologue (the standalone writes) a lane moves 8 elements a
// pass, masked at the row's end; the copy is of the elements' bits (any
// element size), so one kernel serves bf16 and float32 caches. Every
// offset into a cache is int64_t: Mistral's dense cache holds 32 x 16 x 8 x
// 8192 x 128 elements a leaf.
//
// What bounds it on the H100: bytes, and at the main path's sizes the
// launch. The fused write reads q, k and v once (N (Hq + 2 Hkv) D
// elements), the tables (2 N D float32) and weights, and writes q and the
// K/V rows once; at Qwen3's 32 decode rows that is ~0.56 MB, ~0.17 us at
// 3.35 TB/s, against a launch of ~2 us. So the design's point is the
// launches it removes: the plain prologue is ~30 elementwise launches a
// layer, each re-reading and re-writing q or k; here it is none, and the
// intermediate rows never leave registers.
//
// The quantizing writes follow serving/kv_cache.py's quantize_rows as the
// JAX engine's compiled programs compute it: per (row, kv head),
// scale = max(amax, 1e-6) * float32(1/127) (XLA turns the division by the
// constant into that product), q = round_half_even(x / scale) with an IEEE
// division, so their int8 rows and scales are bit-identical to the plain
// version on equal rows (the amax is exact in any order, the codes
// elementwise), and rows quantized by the prefill scatters and by these
// kernels are alike. Rows that share a page land at their own offsets,
// every one of them (the Pallas kernel's scale block spans a whole page;
// see ROADMAP C6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInv127 = 1.0f / 127.0f;
constexpr unsigned kFull = 0xffffffffu;
// warps (head rows) per CTA of the row writes
constexpr int kWriteWarps = 8;
// elements a lane moves per pass in the row writes without the prologue
constexpr int kPlainE = 8;

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
  return __float2bfloat16_rn(x);
}

// The int8 row's scale over one warp's values of it (E a lane; values a
// lane does not hold are 0): max(amax, 1e-6) * float32(1/127), amax by a
// shuffle reduction (the quantizer of every int8 row write).
template <int E>
__device__ __forceinline__ float quant_scale_warp(const float (&x)[E]) {
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < E; ++j) amax = fmaxf(amax, fabsf(x[j]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
  return fmaxf(amax, 1e-6f) * kInv127;
}

// round_half_even(x / scale) with an IEEE division
__device__ __forceinline__ int8_t quant_code(float x, float scale) {
  return (int8_t)rintf(__fdiv_rn(x, scale));
}

// The cache side of a row write: a page pool [L, P, Hkv, ps, D] read
// through a table (r_rows 0), or the dense slot cache [L, B, Hkv, S, D]
// as a pool of B pages of S rows, packed row n on page n / r_rows.
struct RowWrite {
  void* pool_k;
  void* pool_v;
  float* scale_k;          // int8: scales [L, P, Hkv, ps]
  float* scale_v;
  const void* k_new;       // [N, Hkv, D]
  const void* v_new;
  const int32_t* rows;     // [N]
  const int32_t* table;    // [N, max_pages]; dense: unused
  int layer, num_pages, hkv, ps, d, max_pages;
  int r_rows;              // dense: rows a slot; paged: 0
};

// The q/k prologue of a fused write.
struct QKPrologue {
  void* q_out;             // [N, Hq, D]
  const void* q;           // [N, Hq, D], raw
  const void* q_w;         // [D] RMSNorm weights, or null (no norm)
  const void* k_w;
  const float* cos;        // [N, rot] float32
  const float* sin;
  float eps;
  int hq;
  int rot;                 // rotary width: columns [0, rot); 0 no RoPE
};

// the largest head dim of the fused write (E = 8 elements a lane)
constexpr int kMaxPrepD = 256;

// E elements of one lane, moved in one access (two above 16 bytes).
template <typename T, int E>
struct alignas(sizeof(T) * E < 16 ? sizeof(T) * E : 16) Pack {
  T v[E];
};

// Row index (in rows of D) of packed row n's (layer, page, head 0, offset)
// in the pool, or -1 when the row drops. Paged: outside [0, max_pages * ps)
// before its table entry is read, or on a page outside [0, P). DENSE: page
// n / r_rows (the slot), offset the row itself, outside [0, S) dropped.
template <bool DENSE>
__device__ __forceinline__ int64_t kept_row(const RowWrite& w, int n) {
  const int row = w.rows[n];
  int page;
  if constexpr (DENSE) {
    if (row < 0 || row >= w.ps) return -1;
    page = n / w.r_rows;
  } else {
    if (row < 0 || row >= w.max_pages * w.ps) return -1;
    page = w.table[(int64_t)n * w.max_pages + row / w.ps];
    if (page < 0 || page >= w.num_pages) return -1;
  }
  return ((int64_t)w.layer * w.num_pages + page) * w.hkv * w.ps
         + row % w.ps;
}

// A lane's E elements from column c: one access when the row is exactly
// 32 E wide (the prologue's rows), else element by element below d.
template <typename T, int E, bool FULL>
__device__ __forceinline__ void load_row(const T* src, int c, int d,
                                         T (&x)[E]) {
  if constexpr (FULL) {
    const Pack<T, E> p = *reinterpret_cast<const Pack<T, E>*>(src + c);
#pragma unroll
    for (int j = 0; j < E; ++j) x[j] = p.v[j];
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (c + j < d) x[j] = src[c + j];
  }
}

template <typename T, int E, bool FULL>
__device__ __forceinline__ void store_row(T* dst, int c, int d,
                                          const T (&x)[E]) {
  if constexpr (FULL) {
    Pack<T, E> p;
#pragma unroll
    for (int j = 0; j < E; ++j) p.v[j] = x[j];
    *reinterpret_cast<Pack<T, E>*>(dst + c) = p;
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (c + j < d) dst[c + j] = x[j];
  }
}

// f[e] for an index e that the whole warp shares but the compiler does not
// know
template <int E>
__device__ __forceinline__ float pick(const float (&f)[E], int e) {
  float v = f[0];
#pragma unroll
  for (int k = 1; k < E; ++k) v = k == e ? f[k] : v;
  return v;
}

// Column lane E + j + off of the warp's row (E a lane), off shared by the
// warp: element (j + off) mod E of lane lane + floor((j + off) / E); a
// source lane outside the warp wraps (its value is not used)
template <int E>
__device__ __forceinline__ float column_at(const float (&f)[E], int j,
                                           int off, int lane) {
  const int t = j + off;
  const int dl = t >= 0 ? t / E : -((E - 1 - t) / E);
  return __shfl_sync(kFull, pick(f, t - dl * E), lane + dl);
}

// models/layers.py's rms_norm (when ``weight`` is given) then apply_rope on
// one head row held by the warp (the lane's E columns from c = lane E;
// lanes past the row, ``live`` false, hold zeros), rounding to T after
// each as the plain version does. RoPE covers columns [0, r), r = p.rot:
// rotate_half's partner of column c + j is c + j + r/2 (negated) below
// r/2 and c + j - r/2 above. When r/2 is a multiple of E (every family the
// port serves: r = D = 32 E, Phi-2's 32 of 80), the partner is element j
// of lane +- r/2E, one shuffle with the lane's own source, and the tables
// load as vectors; any other even r takes two shuffles an element and
// scalar table loads.
template <typename T, int E>
__device__ __forceinline__ void qk_prologue(T (&x)[E], const T* weight,
                                            const QKPrologue& p, int n,
                                            int c, int d, int lane,
                                            bool live) {
  float f[E];
#pragma unroll
  for (int j = 0; j < E; ++j) f[j] = to_float(x[j]);
  if (weight != nullptr) {
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < E; ++j) ss = __fadd_rn(ss, __fmul_rn(f[j], f[j]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, o));
    const float inv = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)d), p.eps));
    if (live) {
      const Pack<T, E> w = *reinterpret_cast<const Pack<T, E>*>(weight + c);
#pragma unroll
      for (int j = 0; j < E; ++j)
        f[j] = to_float(from_float<T>(
            __fmul_rn(__fmul_rn(f[j], inv), to_float(w.v[j]))));
    }
  }
  const int half = p.rot / 2;
  const float* cs = p.cos + (int64_t)n * p.rot;
  const float* sn = p.sin + (int64_t)n * p.rot;
  const bool rotated = live && c < p.rot;
  if (half > 0 && half % E == 0) {
    const int hl = half / E;
    const bool low = lane < hl;
    const int src = low ? lane + hl : lane - hl;
    Pack<float, E> cv{}, sv{};
    if (rotated) {
      cv = *reinterpret_cast<const Pack<float, E>*>(cs + c);
      sv = *reinterpret_cast<const Pack<float, E>*>(sn + c);
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float other = __shfl_sync(kFull, f[j], src);
      const float rot = low ? -other : other;
      if (rotated)
        f[j] = __fadd_rn(__fmul_rn(f[j], cv.v[j]), __fmul_rn(rot, sv.v[j]));
    }
  } else if (half > 0) {
    // every partner read before any column is rotated (a partner may be
    // another element of this lane's own row)
    float up[E], down[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      up[j] = column_at(f, j, half, lane);
      down[j] = column_at(f, j, -half, lane);
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int col = c + j;
      if (live && col < p.rot)
        f[j] = __fadd_rn(__fmul_rn(f[j], cs[col]),
                         __fmul_rn(col < half ? -up[j] : down[j], sn[col]));
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) x[j] = from_float<T>(f[j]);
}

// The row write (paged or dense), with the q/k prologue (PREP) or
// without, copying or quantizing (QUANT) K and V. Grid (N, head groups of
// kWriteWarps); warp w of group g takes head row g * kWriteWarps + w of
// the packed row: q heads (PREP only), then k heads, then v heads; DENSE
// addresses the dense slot cache (RowWrite::r_rows > 0). T: the rows' type
// (without PREP and QUANT an unsigned integer of the element's size).
// PREP needs D <= 32 E and D % E == 0 (the row on lanes [0, D / E), one
// pass); QUANT D <= 32 E.
template <typename T, int E, bool PREP, bool QUANT, bool DENSE>
__global__ void __launch_bounds__(32 * kWriteWarps)
cache_write_rows_kernel(const RowWrite w, const QKPrologue p) {
  const int n = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int hq = PREP ? p.hq : 0;
  const int h = blockIdx.y * kWriteWarps + (threadIdx.x >> 5);
  if (h >= hq + 2 * w.hkv) return;                   // whole warps
  const bool is_q = h < hq;
  const bool is_v = h >= hq + w.hkv;
  const int hh = is_q ? h : h - hq - (is_v ? w.hkv : 0);
  int64_t dst = 0;
  if (!is_q) {
    dst = kept_row<DENSE>(w, n);
    if (dst < 0) return;                     // dropped; q goes out anyway
    dst += (int64_t)hh * w.ps;
  }
  const T* src = is_q
      ? static_cast<const T*>(p.q) + ((int64_t)n * hq + hh) * w.d
      : static_cast<const T*>(is_v ? w.v_new : w.k_new)
            + ((int64_t)n * w.hkv + hh) * w.d;
  for (int base = 0; base < w.d; base += 32 * E) {  // PREP, QUANT: one pass
    const int c = base + lane * E;
    T x[E];
    if constexpr (PREP) {
      const bool live = c < w.d;
      if (live) {
        load_row<T, E, true>(src, c, w.d, x);
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) x[j] = from_float<T>(0.f);
      }
      if (!is_v)
        qk_prologue<T, E>(x, static_cast<const T*>(is_q ? p.q_w : p.k_w), p,
                          n, c, w.d, lane, live);
      if (is_q) {
        if (live)
          store_row<T, E, true>(
              static_cast<T*>(p.q_out) + ((int64_t)n * hq + hh) * w.d, c,
              w.d, x);
        continue;
      }
    } else {
      load_row<T, E, false>(src, c, w.d, x);
    }
    if constexpr (QUANT) {
      float f[E];
#pragma unroll
      for (int j = 0; j < E; ++j) f[j] = c + j < w.d ? to_float(x[j]) : 0.f;
      const float scale = quant_scale_warp(f);
      int8_t codes[E];
#pragma unroll
      for (int j = 0; j < E; ++j) codes[j] = quant_code(f[j], scale);
      if (!PREP || c < w.d)
        store_row<int8_t, E, PREP>(
            static_cast<int8_t*>(is_v ? w.pool_v : w.pool_k) + dst * w.d, c,
            w.d, codes);
      if (lane == 0) (is_v ? w.scale_v : w.scale_k)[dst] = scale;
    } else if (!PREP || c < w.d) {
      store_row<T, E, PREP>(static_cast<T*>(is_v ? w.pool_v : w.pool_k)
                                + dst * w.d, c, w.d, x);
    }
  }
}

template <typename T, int E, bool PREP, bool QUANT>
int launch_rows(const RowWrite& w, const QKPrologue& p, int n_rows,
                void* stream) {
  const int heads = (PREP ? p.hq : 0) + 2 * w.hkv;
  const dim3 grid(n_rows, (heads + kWriteWarps - 1) / kWriteWarps);
  if (w.r_rows > 0)
    cache_write_rows_kernel<T, E, PREP, QUANT, true>
        <<<grid, 32 * kWriteWarps, 0, (cudaStream_t)stream>>>(w, p);
  else
    cache_write_rows_kernel<T, E, PREP, QUANT, false>
        <<<grid, 32 * kWriteWarps, 0, (cudaStream_t)stream>>>(w, p);
  return (int)cudaGetLastError();
}

// D a multiple of 16 up to 256, the rotary width even and at most D
template <typename T, bool QUANT>
int launch_prep(const RowWrite& w, const QKPrologue& p, int n_rows,
                void* stream) {
  if (w.d < 16 || w.d > kMaxPrepD || w.d % 16 || p.rot < 0 || p.rot > w.d
      || p.rot % 2)
    return (int)cudaErrorInvalidValue;
  if (w.d <= 32) return launch_rows<T, 1, true, QUANT>(w, p, n_rows, stream);
  if (w.d <= 64) return launch_rows<T, 2, true, QUANT>(w, p, n_rows, stream);
  if (w.d <= 128) return launch_rows<T, 4, true, QUANT>(w, p, n_rows, stream);
  return launch_rows<T, 8, true, QUANT>(w, p, n_rows, stream);
}

// The copy without the prologue, over elements of elem_size bytes (1, 2, 4
// or 8; only their bits move).
int launch_copy(const RowWrite& w, int elem_size, int n_rows,
                void* stream) {
  const QKPrologue none{};
  constexpr int E = kPlainE;
  switch (elem_size) {
    case 1: return launch_rows<uint8_t, E, false, false>(w, none, n_rows,
                                                         stream);
    case 2: return launch_rows<uint16_t, E, false, false>(w, none, n_rows,
                                                          stream);
    case 4: return launch_rows<uint32_t, E, false, false>(w, none, n_rows,
                                                          stream);
    case 8: return launch_rows<uint64_t, E, false, false>(w, none, n_rows,
                                                          stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The quantizing write without the prologue; dtype of the new rows:
// 0 = float32, 1 = bfloat16; D <= 256.
int launch_quant(const RowWrite& w, int dtype, int n_rows, void* stream) {
  if (w.d < 1 || w.d > 32 * kPlainE) return (int)cudaErrorInvalidValue;
  const QKPrologue none{};
  if (dtype == 1)
    return launch_rows<__nv_bfloat16, kPlainE, false, true>(w, none, n_rows,
                                                            stream);
  if (dtype == 0)
    return launch_rows<float, kPlainE, false, true>(w, none, n_rows, stream);
  return (int)cudaErrorInvalidValue;
}

// The write with the prologue, copying (quant 0) or quantizing (1); dtype
// of q, k, v and the weights: 0 = float32, 1 = bfloat16.
int launch_prep_any(const RowWrite& w, const QKPrologue& p, int dtype,
                    int quant, int n_rows, void* stream) {
  if (dtype == 1)
    return quant ? launch_prep<__nv_bfloat16, true>(w, p, n_rows, stream)
                 : launch_prep<__nv_bfloat16, false>(w, p, n_rows, stream);
  if (dtype == 0)
    return quant ? launch_prep<float, true>(w, p, n_rows, stream)
                 : launch_prep<float, false>(w, p, n_rows, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Every entry returns cudaGetLastError() after its launch (0 = launched).

// K2: copies the new rows' elements (elem_size bytes each: 1, 2, 4 or 8)
// into the pool through the table: the paged write without the prologue.
extern "C" int cache_write_rows_paged(
    void* pool_k, void* pool_v, const void* k_new, const void* v_new,
    const void* rows, const void* table, int n_rows, int layer,
    int num_pages, int hkv, int ps, int d, int elem_size, int max_pages,
    void* stream) {
  if (n_rows <= 0) return 0;
  const RowWrite w{pool_k, pool_v, nullptr, nullptr, k_new, v_new,
                   (const int32_t*)rows, (const int32_t*)table, layer,
                   num_pages, hkv, ps, d, max_pages, 0};
  return launch_copy(w, elem_size, n_rows, stream);
}

// K3: quantizing row write into an int8 pool and its float32 scale pools
// [L, P, Hkv, ps]: the paged write without the prologue. dtype of the new
// rows: 0 = float32, 1 = bfloat16. D <= 256 (the wrapper checks).
extern "C" int cache_write_rows_quant_paged(
    void* pool_k, void* pool_v, void* scale_k, void* scale_v,
    const void* k_new, const void* v_new, const void* rows,
    const void* table, int n_rows, int layer, int num_pages, int hkv,
    int ps, int d, int max_pages, int dtype, void* stream) {
  if (n_rows <= 0) return 0;
  const RowWrite w{pool_k, pool_v, (float*)scale_k, (float*)scale_v, k_new,
                   v_new, (const int32_t*)rows, (const int32_t*)table, layer,
                   num_pages, hkv, ps, d, max_pages, 0};
  return launch_quant(w, dtype, n_rows, stream);
}

// The paged write with the q/k prologue: q [N, Hq, D] -> q_out (normed when
// q_w is given, RoPE'd over its first rot columns), k [N, Hkv, D] normed
// (k_w) and RoPE'd alike, and v as it is, into a pool of the rows' type
// (quant 0) or quantized into an int8 pool and its scale pools (quant 1).
// cos/sin [N, rot] float32 (rot even, 0 = no RoPE); weights [D] of the
// rows' type or null; dtype 0 = float32, 1 = bfloat16; D a multiple of 16
// up to 256.
extern "C" int prep_write_rows_paged(
    void* q_out, const void* q, const void* q_w, const void* k_w,
    const void* cos, const void* sin, float eps, int hq, int rot,
    void* pool_k, void* pool_v, void* scale_k, void* scale_v,
    const void* k_new, const void* v_new, const void* rows,
    const void* table, int n_rows, int layer, int num_pages, int hkv,
    int ps, int d, int max_pages, int dtype, int quant, void* stream) {
  if (n_rows <= 0) return 0;
  const RowWrite w{pool_k, pool_v, (float*)scale_k, (float*)scale_v, k_new,
                   v_new, (const int32_t*)rows, (const int32_t*)table, layer,
                   num_pages, hkv, ps, d, max_pages, 0};
  const QKPrologue p{q_out, q, q_w, k_w, (const float*)cos,
                     (const float*)sin, eps, hq, rot};
  return launch_prep_any(w, p, dtype, quant, n_rows, stream);
}

// The dense slot cache [L, n_slots, Hkv, seq, D] as the kernel's pool of
// n_slots pages of seq rows, r_rows packed rows a slot.
static RowWrite dense_rows(void* cache_k, void* cache_v, void* scale_k,
                           void* scale_v, const void* k_new,
                           const void* v_new, const void* rows, int n_slots,
                           int r_rows, int layer, int hkv, int seq, int d) {
  return RowWrite{cache_k, cache_v, (float*)scale_k, (float*)scale_v, k_new,
                  v_new, (const int32_t*)rows, nullptr, layer, n_slots, hkv,
                  seq, d, 0, r_rows};
}

// K8: the dense cache's copy, new rows [n_slots, r_rows, Hkv, D] at rows
// [n_slots, r_rows]: the dense write without the prologue, moving the
// rows' bits as 4-byte words. row_bytes = D * element size; a multiple of
// 16 (the wrapper checks; the kernel needs 4).
extern "C" int cache_write_rows_dense(
    void* cache_k, void* cache_v, const void* k_new, const void* v_new,
    const void* rows, int n_slots, int r_rows, int layer, int hkv, int seq,
    int row_bytes, void* stream) {
  if (n_slots <= 0 || r_rows <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 4) return (int)cudaErrorInvalidValue;
  const RowWrite w = dense_rows(cache_k, cache_v, nullptr, nullptr, k_new,
                                v_new, rows, n_slots, r_rows, layer, hkv,
                                seq, row_bytes / 4);
  return launch_copy(w, 4, n_slots * r_rows, stream);
}

// K9: quantizing write into the dense int8 cache [L, n_slots, Hkv, seq, D]
// and its float32 scales [L, n_slots, Hkv, seq]: new rows [n_slots, r_rows,
// Hkv, D] (dtype 0 = float32, 1 = bfloat16) at rows [n_slots, r_rows]; the
// dense write without the prologue. D <= 256 (the wrapper checks).
extern "C" int cache_write_rows_quant_dense(
    void* cache_k, void* cache_v, void* scale_k, void* scale_v,
    const void* k_new, const void* v_new, const void* rows, int n_slots,
    int r_rows, int layer, int hkv, int seq, int d, int dtype, void* stream) {
  if (n_slots <= 0 || r_rows <= 0) return 0;
  const RowWrite w = dense_rows(cache_k, cache_v, scale_k, scale_v, k_new,
                                v_new, rows, n_slots, r_rows, layer, hkv,
                                seq, d);
  return launch_quant(w, dtype, n_slots * r_rows, stream);
}

// The dense write with the q/k prologue: q [n_slots, r_rows, Hq, D] ->
// q_out (normed when q_w is given, RoPE'd; every row, kept or dropped),
// k [n_slots, r_rows, Hkv, D] normed and RoPE'd, and v as it is, at rows
// [n_slots, r_rows] into a cache of the rows' type (quant 0) or quantized
// into the int8 cache and its scales (quant 1). cos/sin [n_slots * r_rows,
// rot] float32 (RoPE over the first rot columns; 0 none); weights [D] of
// the rows' type or null; dtype 0 = float32, 1 = bfloat16; D a multiple of
// 16 up to 256.
extern "C" int prep_write_rows_dense(
    void* q_out, const void* q, const void* q_w, const void* k_w,
    const void* cos, const void* sin, float eps, int hq, int rot,
    void* cache_k, void* cache_v, void* scale_k, void* scale_v,
    const void* k_new, const void* v_new, const void* rows, int n_slots,
    int r_rows, int layer, int hkv, int seq, int d, int dtype, int quant,
    void* stream) {
  if (n_slots <= 0 || r_rows <= 0) return 0;
  const RowWrite w = dense_rows(cache_k, cache_v, scale_k, scale_v, k_new,
                                v_new, rows, n_slots, r_rows, layer, hkv,
                                seq, d);
  const QKPrologue p{q_out, q, q_w, k_w, (const float*)cos,
                     (const float*)sin, eps, hq, rot};
  return launch_prep_any(w, p, dtype, quant, n_slots * r_rows, stream);
}
