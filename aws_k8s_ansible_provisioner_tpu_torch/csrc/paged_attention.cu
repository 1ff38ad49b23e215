// Paged flash attention with per-row (table row, live-column limit), over a
// bf16/f32 pool or an int8 pool with per-row float32 scales, with or without
// a sliding window: split-KV over a pipelined page stream.
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
// live page then scales what it summed by exp(-1e30 - m) = 0.
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
//   (split_merge.cuh, queued by this file's C entry right after the
//   kernel) merges the row's triples in split order. An empty run writes
//   (0, -1e30, 0), which the combine weighs by exp(m - M) like any other:
//   it adds exactly 0, and a row whose only visited page is wholly masked
//   (limit <= 0) keeps the mean of V above;
// - a pipelined page stream (split_decode.cuh): a page of one kv head (ps x
//   D, 16 KB in bf16 at ps 64, D 128) is contiguous in the pool, and the
//   next stage's cp.async copies (K, V and the int8 scales together; a
//   stage is the page, or 32 of its rows at G >= 4; a page of more than 64
//   rows streams as several stages, so any page size fits) are in flight
//   while the
//   current one is computed, as the TPU body double-buffers its page copies
//   (pallas_attention.py:918-945);
// - the arithmetic in registers: one reduction per stage for the scores,
//   the max and the sum, the P.V accumulators held per thread.
// Still missing: wgmma and TMA (q rows are too few for a tensor-core tile,
// and the kernel is bound by bytes), a page stream shared by a verify's R
// rows (each packed row re-reads its slot's pages), and tiling of the
// ragged entry's chunk rows (each chunk row re-reads its slot's pages).

#include "split_decode.cuh"
#include "split_merge.cuh"

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
