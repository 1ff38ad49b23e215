// Paged flash attention with per-row (table row, live-column limit), over a
// bf16/f32 pool or an int8 pool with per-row float32 scales, with or without
// a sliding window: split-KV over a pipelined page stream. Three entries:
// paged_attention (decode and ragged rows: one query row per table row),
// paged_attention_chunk (the ragged entry's prefill-chunk rows, which share
// one table row and have limits that rise by one) and
// paged_attention_verify (the speculative verify: R query rows per slot).
//
// Replaces: aws_k8s_ansible_provisioner_tpu/ops/pallas_attention.py:
//   _paged_flash_db / _paged_db_body, the body behind
//   decode_attend_pallas_paged and ragged_attend_pallas_paged (R=1;
//   paged_attention for decode rows, and paged_attention_chunk for the
//   chunk rows of a ragged call that passes its layout) and
//   decode_attend_pallas_spec_paged (spec=True, R>1;
//   paged_attention_verify): the bf16 body _paged_db_kernel and the int8
//   scale-folding body _paged_db_kernel_quant, each at window 0 and
//   window > 0.
//
// Contract of paged_attention (same as the TPU kernel): q [N, Hq, D]; pools
// [L, P, Hkv, ps, D]; limits [N] int32; table [N, max_pages] int32; output
// [N, Hq, D] in q's type. Query row n visits its logical pages lo .. hi
// with hi = min(max(cdiv(limit, ps) - 1, 0), max_pages - 1) and lo = 0, or
// with a window lo = min(max(limit - window, 0) / ps, hi), and reads no
// table entry and no page outside that range; its live columns are
// [limit - window, limit) (window 0: [0, limit)), the others are masked
// with NEG_INF = -1e30. Online softmax in float32 with the scale 1/sqrt(D)
// folded into q; output acc / max(l, 1e-9). A row with limit <= 0 still
// visits page table[n, 0] with every column masked, so p = exp(0) = 1
// there and the row returns the mean of V over that page, exactly as the
// TPU kernel does (mixed_step's dead passenger row; its output is
// discarded). Page ids are clamped into [0, P), as Pallas clamps a block
// index.
//
// Contract of paged_attention_verify: q [B, R, Hq, D]; lengths [B]; table
// [B, max_pages]; output [B, R, Hq, D]. Row r of slot b is the row above
// with limit lengths[b] + 1 + r and slot b's table row, and gets exactly
// that row's result (its visited pages, mask and C2 mean), up to the order
// of float32 sums. The slot's pages are streamed once for all R rows, from
// the page of row 0's window start (lengths + 1 - window, or 0) to the page
// of column lengths + R - 1, as the TPU verify walks them
// (pallas_attention.py:902-906): no other page or table entry is read. A
// page of that range outside a row's own range adds nothing to that row.
//
// Int8 pools (scale pools ks, vs [L, P, Hkv, ps] float32) fold the scales
// into the flash loop in the TPU body's order and never build a dequantized
// copy: s = (q * 1/sqrt(D)) . k_int8 * kscale[col], then the mask and the
// online max; l sums the UNSCALED p, and p * vscale[col] enters P.V.
//
// What bounds it on the H100: bytes. A decode row reads its live K and V
// pages once (2 * ps * D * elem bytes per page and kv head, plus 2 * ps * 4
// bytes of scales for int8) and does 4 * G * D flops per column, about one
// flop per byte against the card's ~295 flop/byte ridge. So the design is
// about bytes in flight: the G = Hq / Hkv query heads of a kv head share its
// page stream (GQA in the kernel, every byte read once per row), and
// - split-KV: the grid is (row, kv head, split). Split s of a row takes the
//   s-th of `splits` equal runs of its pages lo .. hi (runs start at lo, so
//   the window's mask arithmetic is unchanged; a run past hi is empty). The
//   launcher picks `splits` from shapes only (rows, Hkv, max_pages and the
//   card's SM count; ops/split_kv.split_count), so a decode step's 256 or
//   128 (row, kv head) pairs fill the 132 SMs several CTAs deep, the launch
//   geometry is fixed for an engine shape and results repeat bit for bit.
//   With one split the CTA writes the output; with more it writes its
//   float32 triple (acc, m, l) to a workspace and the combine
//   (split_merge.cuh, queued by this file's C entries right after the
//   kernel) merges the row's triples in split order. An empty run writes
//   (0, -1e30, 0), which the combine weighs by exp(m - M) like any other:
//   it adds exactly 0, and a row whose only visited page is wholly masked
//   (limit <= 0) keeps the mean of V above;
// - a pipelined page stream (split_decode.cuh): a page of one kv head (ps x
//   D, 16 KB in bf16 at ps 64, D 128) is contiguous in the pool, and the
//   next stage's cp.async copies (K, V and the int8 scales together; a
//   stage is the page, or 32 of its rows at G >= 4; a page of more than 64
//   rows streams as several stages, so any page size fits) are in flight
//   while the current one is computed, as the TPU body double-buffers its
//   page copies (pallas_attention.py:918-945);
// - the arithmetic in registers: one reduction per stage for the scores,
//   the max and the sum, the P.V accumulators held per thread.
// The verify reads the same bytes once per slot for R x G rows: R x G
// flops a byte (10 at Qwen3's R 5 x G 2, 20 at Mistral's 5 x 4), enough to
// need the tensor cores. Its body (split_verify.cuh) gives one CTA a slot's
// R x G rows of one kv head (up to 64; more take row groups) over a split
// of the slot's pages (grid slot x row group, kv head, split; the split
// count from the slots' shapes, so the verify is split like the decode),
// with mma.sync scores and P.V.
// A prefill chunk's C rows in a ragged call read the same pages of one
// slot, C x G rows a kv head (512-2048 at the main path's chunks): the
// per-row body would stream each page once per chunk row. The chunk body
// (split_chunk.cuh) gives one CTA a row tile of 128 of those rows and
// streams the pages once per tile, from its first row's first page to its
// last row's last, with mma.sync scores and P.V in 8 warps of 16 rows each
// (grid row tile, kv head, split; the split count from the tiles' shapes).
// The ragged wrapper launches it for the rows from chunk_start on and the
// per-row body for the decode rows before them, each with its own split
// count (ops/paged_attention.ragged_attend_paged).
// Still missing: wgmma and TMA (a decode row's G heads are too few for a
// tensor-core tile, and the decode is bound by bytes; the chunk body's 128
// rows a tile would fill a warpgroup's 64-row wgmma twice).

#include "split_chunk.cuh"
#include "split_decode.cuh"
#include "split_merge.cuh"
#include "split_verify.cuh"

namespace {

using namespace split_decode;

struct PagedSource {
  const int32_t* table_row;
  int num_pages, hkv, h, ps;
  int64_t layer_page0;   // layer * num_pages
  __device__ __forceinline__ int64_t row0(int t) const {
    int page = table_row[t];
    page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
    return ((layer_page0 + page) * hkv + h) * (int64_t)ps;
  }
  __device__ __forceinline__ int rows(int) const { return ps; }
};

// grid (n_rows, hkv, splits); ws_*: the split triples [splits, N, Hq, (D)]
// when splits > 1, else null
template <typename T, typename TP, int kG>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(T* __restrict__ out, float* __restrict__ ws_acc,
                       float* __restrict__ ws_m, float* __restrict__ ws_l,
                       const T* __restrict__ q, const TP* __restrict__ pool_k,
                       const TP* __restrict__ pool_v,
                       const float* __restrict__ pool_ks,
                       const float* __restrict__ pool_vs,
                       const int32_t* __restrict__ limits,
                       const int32_t* __restrict__ table, int layer,
                       int num_pages, int hkv, int ps, int d, int groups,
                       int max_pages, int window, float scale) {
  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int hq = hkv * groups;

  const int limit = limits[n];
  int hi = limit > 0 ? (limit + ps - 1) / ps - 1 : 0;
  hi = hi < max_pages - 1 ? hi : max_pages - 1;
  // window: live columns from wstart on; pages below its page never read
  const int wstart = window > 0 ? limit - window : 0;
  int lo = 0;
  if (window > 0) {
    lo = (wstart > 0 ? wstart : 0) / ps;
    lo = lo < hi ? lo : hi;
  }
  const int per = (hi - lo + splits) / splits;   // cdiv(hi - lo + 1, splits)
  const int t_begin = lo + split * per;
  const int t_end = t_begin + per < hi + 1 ? t_begin + per : hi + 1;

  const int64_t head0 = (int64_t)n * hq + (int64_t)h * groups;
  const PagedSource src{table + (int64_t)n * max_pages, num_pages, hkv, h, ps,
                        (int64_t)layer * num_pages};
  float* raw_acc = nullptr;
  float* raw_m = nullptr;
  float* raw_l = nullptr;
  if (ws_acc) {
    const int64_t w0 = (int64_t)split * gridDim.x * hq + head0;
    raw_acc = ws_acc + w0 * d;
    raw_m = ws_m + w0;
    raw_l = ws_l + w0;
  }
  attend_split<T, TP, kG>(src, q + head0 * d, scale, pool_k, pool_v, pool_ks,
                          pool_vs, ps, d, groups, t_begin,
                          t_end > t_begin ? t_end : t_begin, limit, wstart,
                          out + head0 * d, raw_acc, raw_m, raw_l);
}

template <typename T, typename TP, int kG>
int launch(void* out, void* ws_acc, void* ws_m, void* ws_l, const void* q,
           const void* pool_k, const void* pool_v, const void* pool_ks,
           const void* pool_vs, const void* limits, const void* table,
           int n_rows, int hkv, int groups, int d, int num_pages, int ps,
           int max_pages, int layer, int window, float scale, int splits,
           cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  const Layout lay(stage_rows<kG>(ps), d, groups, (int)sizeof(TP), kQuant,
                   stages<TP>());
  if (lay.npairs > kThreads) return (int)cudaErrorInvalidValue;
  auto kernel = paged_attention_kernel<T, TP, kG>;
  static int configured = 48 * 1024;   // dynamic shared memory allowed
  if (lay.total > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = lay.total;
  }
  dim3 grid(n_rows, hkv, splits);
  kernel<<<grid, kThreads, lay.total, stream>>>(
      (T*)out, (float*)ws_acc, (float*)ws_m, (float*)ws_l, (const T*)q,
      (const TP*)pool_k, (const TP*)pool_v, (const float*)pool_ks,
      (const float*)pool_vs, (const int32_t*)limits, (const int32_t*)table,
      layer, num_pages, hkv, ps, d, groups, max_pages, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename TP>
int launch_groups(int groups, void* out, void* ws_acc, void* ws_m, void* ws_l,
                  const void* q, const void* pool_k, const void* pool_v,
                  const void* pool_ks, const void* pool_vs,
                  const void* limits, const void* table, int n_rows, int hkv,
                  int d, int num_pages, int ps, int max_pages, int layer,
                  int window, float scale, int splits, cudaStream_t stream) {
#define PA_ARGS                                                              \
  out, ws_acc, ws_m, ws_l, q, pool_k, pool_v, pool_ks, pool_vs, limits,      \
      table, n_rows, hkv, groups, d, num_pages, ps, max_pages, layer, window, \
      scale, splits, stream
  if (groups <= 2) return launch<T, TP, 2>(PA_ARGS);
  if (groups <= 4) return launch<T, TP, 4>(PA_ARGS);
  return launch<T, TP, 8>(PA_ARGS);
#undef PA_ARGS
}


// The verify's pages of slot b and kv head h, and each row's visited and
// live columns (paged_attention's per-row contract)
struct PagedVerifySource : PagedSource {
  int tile, max_pages, window;
  // the first and last logical page a row of this limit visits
  __device__ __forceinline__ void pages(int lim, int& lo, int& hi) const {
    hi = lim > 0 ? (lim + ps - 1) / ps - 1 : 0;
    hi = hi < max_pages - 1 ? hi : max_pages - 1;
    lo = 0;
    if (window > 0) {
      lo = (lim - window > 0 ? lim - window : 0) / ps;
      lo = lo < hi ? lo : hi;
    }
  }
  __device__ __forceinline__ void columns(int lim, int& vlo, int& vhi,
                                          int& llo, int& lhi) const {
    int lo, hi;
    pages(lim, lo, hi);
    vlo = lo * ps;
    vhi = (hi + 1) * ps;
    llo = window > 0 ? lim - window : 0;
    lhi = lim;
  }
  __device__ __forceinline__ void prepare(int lim_first, int lim_last,
                                          int& t_lo, int& t_end) const {
    int lo, hi;
    pages(lim_first, t_lo, hi);
    pages(lim_last, lo, hi);
    t_end = hi + 1;
  }
};

// grid (n_slots * n_groups, hkv, splits)
template <typename T, typename TP, int kMT, int kD>
__global__ void __launch_bounds__(split_verify::kThreads)
paged_verify_kernel(split_verify::Args a, const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ table, int layer,
                    int num_pages, int hkv, int ps, int max_pages,
                    int window) {
  const int b = blockIdx.x / a.n_groups;
  const int h = blockIdx.y;
  const PagedVerifySource src{
      {table + (int64_t)b * max_pages, num_pages, hkv, h, ps,
       (int64_t)layer * num_pages},
      ps, max_pages, window};
  split_verify::attend_verify<T, TP, kMT, kD>(
      a, src, b, h, blockIdx.x - b * a.n_groups, lengths[b] + 1);
}

template <typename T, typename TP, int kMT, int kD>
int launch_verify(const split_verify::Args& a, const void* lengths,
                  const void* table, int hkv, int num_pages, int ps,
                  int max_pages, int layer, int window, int splits,
                  cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  const split_verify::Layout lay(a.d, (int)sizeof(TP), (int)sizeof(T),
                                 kQuant, kMma, split_verify::kStages,
                                 split_verify::stage_cols<kMma>(), kMT * 16);
  auto kernel = paged_verify_kernel<T, TP, kMT, kD>;
  static int configured = 48 * 1024;   // dynamic shared memory allowed
  if (lay.total > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = lay.total;
  }
  dim3 grid(a.n_slots * a.n_groups, hkv, splits);
  kernel<<<grid, split_verify::kThreads, lay.total, stream>>>(
      a, (const int32_t*)lengths, (const int32_t*)table, layer, num_pages,
      hkv, ps, max_pages, window);
  return (int)cudaGetLastError();
}

// the instance for the row tiles a CTA takes and D (up to 128 or 256)
template <typename T, typename TP>
int launch_verify_shapes(int row_tiles, const split_verify::Args& a,
                         const void* lengths, const void* table, int hkv,
                         int num_pages, int ps, int max_pages, int layer,
                         int window, int splits, cudaStream_t stream) {
#define PV_LAUNCH(MT, D)                                                     \
  return launch_verify<T, TP, MT, D>(a, lengths, table, hkv, num_pages, ps, \
                                     max_pages, layer, window, splits, stream)
  const bool wide = a.d > 128;
  if (row_tiles == 1) {
    if (wide) PV_LAUNCH(1, 256);
    PV_LAUNCH(1, 128);
  }
  if (row_tiles == 2) {
    if (wide) PV_LAUNCH(2, 256);
    PV_LAUNCH(2, 128);
  }
  if (wide) PV_LAUNCH(4, 256);
  PV_LAUNCH(4, 128);
#undef PV_LAUNCH
}

}  // namespace

// dtype (q and output): 0 = float32, 1 = bfloat16. pool_dtype: 0 = float32,
// 1 = bfloat16 (both the q type), 2 = int8 with the float32 scale pools
// pool_ks / pool_vs (ignored otherwise). window > 0: sliding window of that
// many columns; 0: none. splits >= 1 CTAs per (row, kv head); with splits >
// 1, ws_acc [splits, N, Hq, D], ws_m and ws_l [splits, N, Hq] float32
// receive each split's triple and the combine (split_merge.cuh), queued
// next on the same stream, writes out; else they are null. Returns
// cudaGetLastError() after the launches (0 = launched). groups <= 8, D % 8
// == 0 and D <= 256 and, for int8, D % 16 == 0 (the wrapper checks).
extern "C" int paged_attention(void* out, void* ws_acc, void* ws_m,
                               void* ws_l, const void* q, const void* pool_k,
                               const void* pool_v, const void* pool_ks,
                               const void* pool_vs, const void* limits,
                               const void* table, int n_rows, int hkv,
                               int groups, int d, int num_pages, int ps,
                               int max_pages, int layer, int window,
                               float scale, int dtype, int pool_dtype,
                               int splits, void* stream) {
  if (n_rows <= 0) return 0;
  if (groups < 1 || groups > kMaxGroups || window < 0 || splits < 1 ||
      (splits > 1) != (ws_acc != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = (int)cudaErrorInvalidValue;
#define PA_LAUNCH(T, TP)                                                    \
  rc = launch_groups<T, TP>(groups, out, ws_acc, ws_m, ws_l, q, pool_k,     \
                            pool_v, pool_ks, pool_vs, limits, table, n_rows, \
                            hkv, d, num_pages, ps, max_pages, layer, window, \
                            scale, splits, s)
  if (dtype == 1 && pool_dtype == 1) PA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  else if (dtype == 0 && pool_dtype == 0) PA_LAUNCH(float, float);
  else if (dtype == 1 && pool_dtype == 2) PA_LAUNCH(__nv_bfloat16, int8_t);
  else if (dtype == 0 && pool_dtype == 2) PA_LAUNCH(float, int8_t);
#undef PA_LAUNCH
  if (rc != 0 || splits == 1) return rc;
  // the combine, queued behind the attention kernel on the same stream
  return split_combine::launch(out, nullptr, nullptr, nullptr, ws_acc, ws_m,
                               ws_l, splits, (long long)n_rows * hkv * groups,
                               d, dtype, s);
}

// The speculative verify: q [B, R, Hq, D] (B = n_slots, R = r_rows), out
// the same; lengths [B] int32 (row r of slot b has the limit lengths[b] + 1
// + r); table [B, max_pages] int32. dtype, pool_dtype, window and the int8
// scale pools as for paged_attention. splits >= 1 CTAs per (slot, row
// group, kv head); with splits > 1, ws_acc [splits, B * R, Hq, D], ws_m and
// ws_l [splits, B * R, Hq] float32 receive each split's triples and the
// combine, queued next on the same stream, writes out; else they are null.
// Returns cudaGetLastError() after the launches (0 = launched). groups <=
// 8, D % 8 == 0 and D <= 256 and, for int8, D % 16 == 0 (the wrapper
// checks).
extern "C" int paged_attention_verify(
    void* out, void* ws_acc, void* ws_m, void* ws_l, const void* q,
    const void* pool_k, const void* pool_v, const void* pool_ks,
    const void* pool_vs, const void* lengths, const void* table, int n_slots,
    int r_rows, int hkv, int groups, int d, int num_pages, int ps,
    int max_pages, int layer, int window, float scale, int dtype,
    int pool_dtype, int splits, void* stream) {
  if (n_slots <= 0 || r_rows <= 0) return 0;
  if (groups < 1 || groups > kMaxGroups || d < 8 || d > 256 || d % 8 ||
      window < 0 || splits < 1 || (splits > 1) != (ws_acc != nullptr))
    return (int)cudaErrorInvalidValue;
  const int tiles = split_verify::row_tiles(r_rows * groups);
  split_verify::Args a{q, out, (float*)ws_acc, (float*)ws_m, (float*)ws_l,
                       pool_k, pool_v, (const float*)pool_ks,
                       (const float*)pool_vs, n_slots, r_rows, groups,
                       hkv * groups, d,
                       (r_rows * groups + tiles * 16 - 1) / (tiles * 16),
                       scale};
  cudaStream_t s = (cudaStream_t)stream;
  int rc = (int)cudaErrorInvalidValue;
#define PV_SHAPES(T, TP)                                                    \
  rc = launch_verify_shapes<T, TP>(tiles, a, lengths, table, hkv, num_pages, \
                                   ps, max_pages, layer, window, splits, s)
  if (dtype == 1 && pool_dtype == 1) PV_SHAPES(__nv_bfloat16, __nv_bfloat16);
  else if (dtype == 0 && pool_dtype == 0) PV_SHAPES(float, float);
  else if (dtype == 1 && pool_dtype == 2) PV_SHAPES(__nv_bfloat16, int8_t);
  else if (dtype == 0 && pool_dtype == 2) PV_SHAPES(float, int8_t);
#undef PV_SHAPES
  if (rc != 0 || splits == 1) return rc;
  return split_combine::launch(out, nullptr, nullptr, nullptr, ws_acc, ws_m,
                               ws_l, splits,
                               (long long)n_slots * r_rows * hkv * groups, d,
                               dtype, s);
}

// The ragged entry's chunk rows (split_chunk.cuh): q [C, Hq, D] bf16 (the
// chunk's rows of the packed batch), out the same; lim0 the chunk's first
// limit (int32 on the device; row r has lim0 + r); table_row the slot's
// table row [max_pages] int32, shared by every chunk row. pool_dtype: 1 =
// bfloat16, 2 = int8 with the float32 scale pools pool_ks / pool_vs.
// window as for paged_attention. splits >= 1 CTAs per (row tile of 128
// query rows, kv head); with splits > 1, ws_acc [splits, C, Hq, D], ws_m
// and ws_l [splits, C, Hq] float32 receive each split's triples and the
// combine, queued next on the same stream, writes out; else they are null.
// Returns cudaGetLastError() after the launches (0 = launched). groups <=
// 8, D % 16 == 0 and D <= 128, or D 256 (the wrapper checks).
extern "C" int paged_attention_chunk(
    void* out, void* ws_acc, void* ws_m, void* ws_l, const void* q,
    const void* pool_k, const void* pool_v, const void* pool_ks,
    const void* pool_vs, const void* lim0, const void* table_row,
    int n_rows, int hkv, int groups, int d, int num_pages, int ps,
    int max_pages, int layer, int window, float scale, int pool_dtype,
    int splits, void* stream) {
  if (n_rows <= 0) return 0;
  if (groups < 1 || groups > kMaxGroups || d < 16 ||
      (d > split_chunk::kD && d != split_chunk::kDWide) || d % 16 ||
      window < 0 || splits < 1 ||
      (splits > 1) != (ws_acc != nullptr))
    return (int)cudaErrorInvalidValue;
  const split_chunk::Args a{
      (const __nv_bfloat16*)q, (__nv_bfloat16*)out, (float*)ws_acc,
      (float*)ws_m, (float*)ws_l, pool_k, pool_v, (const float*)pool_ks,
      (const float*)pool_vs, (const int32_t*)lim0,
      (const int32_t*)table_row, n_rows, groups, hkv * groups, d, ps,
      num_pages, hkv, max_pages, window, layer, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (pool_dtype == 1) return split_chunk::launch<__nv_bfloat16>(a, splits, s);
  if (pool_dtype == 2) return split_chunk::launch<int8_t>(a, splits, s);
  return (int)cudaErrorInvalidValue;
}
