// Flash attention over one layer of the dense slot cache [L, B, Hkv, S, D]
// (the dense engine's cache, paged=False, and the draft model's), bf16 or
// float32, or int8 with a float32 scale per (row, kv head), with or without
// a sliding window: split-KV over a pipelined tile stream.
//
// Replaces: aws_k8s_ansible_provisioner_tpu/ops/pallas_attention.py:
//   decode_attend_pallas_layer with bblock 1 (K4: bodies
//   _decode_kernel_layer and, int8, _decode_kernel_layer_q) and with
//   bblock > 1 (K5: _decode_kernel_layer_bb and _decode_kernel_layer_q_bb),
//   the entry dense_attention; decode_attend_pallas_spec (K7:
//   _spec_accumulate through _spec_kernel_plain and _spec_kernel_quant),
//   the entry dense_attention_verify; each at window 0 and window > 0; and
//   decode_attend_pallas_layer with return_stats=True (K6:
//   _decode_kernel_layer_stats and, int8, _decode_kernel_layer_q_stats),
//   the entry dense_attention_stats.
//
// Contract (same as the TPU kernels): q [B, R, Hq, D], R query rows per slot
// (R = 1 for a decode step, R > 1 for a speculative verify); cache_k/v
// [L, B, Hkv, S, D] of q's type, or int8 with cache_ks/vs [L, B, Hkv, S]
// float32; output [B, R, Hq, D] in q's type. Query row (b, r) has a limit
// lim (the decode entry: limits[b] = lengths, the just-written row
// counted; the verify entry: lengths[b] + 1 + r) and attends the rows
// [0, min(lim, S)) of slot b, or with a window the rows
// [max(lim - window, 0), min(lim, S)). No row past that is read; with a
// window the 64-row tiles start at the tile of the window start, no
// earlier row is read, and the columns of that tile below the start are
// masked with -1e30 (the tile holds a live column, so they add exp(-1e30 -
// m) = 0). Online softmax in float32; output acc / max(l, 1e-9). A row
// with no row to visit (a decode row of length 0) accumulates nothing and
// returns 0 / 1e-9 = zeros, where the paged kernel returns the mean of V
// over its first page (the TPU kernels differ the same way).
//
// Int8 (TC = int8_t) folds the scales into the loop in the TPU body's order
// and never builds a dequantized copy: s = (q * 1/sqrt(D)) . k_int8 *
// kscale[col], then the mask and the online max; l sums the UNSCALED p, and
// p * vscale[col] enters P.V (as the paged kernel's int8 instance does).
//
// K5, the batch-blocked form, is this kernel: the TPU body gives one grid
// step BB slots so that each step's DMAs are larger (pallas_attention.py:
// 440-444), and walks the union of their chunk ranges. On the H100 the
// slots of a block share no bytes, so a block only trades CTAs for serial
// work (a CTA walking its block's slots in turn ran 3.2-5.7x slower than
// one CTA per slot, NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py). Here a
// block's BB slots are BB x splits CTAs, each over its slot's own tile
// range, so K5 computes exactly what K4 computes: a row with no live
// column returns K4's zeros (ROADMAP C11: the TPU body returns a mean of V
// over the chunks its block visits). The wrapper keeps the block for its
// contract and its launch counters only.
//
// What bounds it on the H100: bytes. A decode row reads its slot's live K
// and V rows (2 * D * elem bytes per row and kv head, plus 8 bytes of scales
// for int8) and does 4 * G * D flops per column, about one flop per byte
// against the card's ~295 flop/byte ridge. So the design is about bytes in
// flight; the G = Hq / Hkv query heads of a kv head share its row stream
// (GQA in the kernel). The decode body is the paged kernel's
// (split_decode.cuh):
// - split-KV: the grid is (slot, kv head, split); split s takes the s-th of
//   `splits` equal runs of the row's 64-row tiles, from its window start's
//   tile (0 without a window) to its last row; `splits` comes from shapes
//   only (slots, Hkv, S and the SM count; ops/split_kv.split_count), so a
//   27,000-row slot does not walk its rows in one CTA. One split writes the
//   output (K6: its triple); more write float32 triples to a workspace that
//   the combine (split_merge.cuh, queued by this file's C entries right
//   after the kernel) merges in split order (K6: into the shard's
//   un-normalized triple, which ops/attention.merge_stats merges across
//   shards as before). An empty run writes (0, -1e30, 0), which adds
//   exactly 0 in the combine, so a row of length 0 still gives zeros and an
//   empty shard (0, -1e30, 0);
// - a pipelined tile stream: a tile of one slot's kv head is 64 contiguous
//   rows, streamed whole or, at G >= 4, as two 32-row stages; a stage's
//   cp.async copies (K, V and the int8 scales together) are in flight
//   while the previous stage is computed; rows past the slot's limit are
//   never copied;
// - the arithmetic in registers: one reduction per stage for the scores,
//   the max and the sum, the P.V accumulators held per thread.
// The verify (K7) streams a slot's tiles once for its R x G rows (R x G
// flops a byte: 10 at Qwen3's shapes, 20 at Mistral's), from the tile of
// row 0's window start to its last row, as the TPU body does
// (pallas_attention.py:546, :637-643). Its body (split_verify.cuh) gives
// one CTA a slot's R x G rows of one kv head (up to 64; more take row
// groups) over a split of those tiles, with mma.sync scores and P.V; each
// row keeps the per-row contract above.
// Still missing: wgmma and TMA (a decode row's G heads are too few for a
// tensor-core tile, and the kernel is bound by bytes).

#include "split_decode.cuh"
#include "split_merge.cuh"
#include "split_verify.cuh"

namespace {

using namespace split_decode;

constexpr int kTile = 64;

struct DenseSource {
  int64_t head_row0;   // first row of the slot's kv head
  int extent;          // rows that exist for this query row
  __device__ __forceinline__ int64_t row0(int t) const {
    return head_row0 + (int64_t)t * kTile;
  }
  __device__ __forceinline__ int rows(int t) const {
    const int left = extent - t * kTile;
    return left < kTile ? left : kTile;
  }
};

// grid (n_slots * r_rows, hkv, splits). out [B * R, Hq, D] of T, or with
// `raw` the float32 triple: into ws_* [splits, B * R, Hq, (D)] (splits > 1)
// or, one split, into the K6 outputs passed there. The C entries launch it
// with r_rows = 1 (the verify has its own body, split_verify.cuh); the
// packed-row form stays, since dropping it moved nvcc's output for this
// loop by 2-4 % on an H100 (kernel_ab.py) without changing its arithmetic.
template <typename T, typename TC, int kG>
__global__ void __launch_bounds__(kThreads)
dense_attention_kernel(T* __restrict__ out, float* __restrict__ ws_acc,
                       float* __restrict__ ws_m, float* __restrict__ ws_l,
                       const T* __restrict__ q, const TC* __restrict__ cache_k,
                       const TC* __restrict__ cache_v,
                       const float* __restrict__ cache_ks,
                       const float* __restrict__ cache_vs,
                       const int32_t* __restrict__ limits, int layer,
                       int n_slots, int hkv, int seq, int d, int groups,
                       int r_rows, int window, float scale) {
  const int n = blockIdx.x;          // packed row b * R + r
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int hq = hkv * groups;
  const int b = n / r_rows;
  const int lim = limits[b] + (n - b * r_rows);
  const int extent = lim < 0 ? 0 : (lim > seq ? seq : lim);
  // window: live rows from wstart on; tiles below its tile never read
  const int wstart = window > 0 && lim - window > 0 ? lim - window : 0;
  const int lo = wstart / kTile;
  const int n_tiles = extent > 0 ? (extent - 1) / kTile + 1 - lo : 0;
  const int per = (n_tiles + splits - 1) / splits;
  const int t_begin = lo + split * per;
  int t_end = lo + n_tiles < t_begin + per ? lo + n_tiles : t_begin + per;
  t_end = t_end > t_begin ? t_end : t_begin;

  const int64_t head0 = (int64_t)n * hq + (int64_t)h * groups;
  const DenseSource src{
      (((int64_t)layer * n_slots + b) * hkv + h) * (int64_t)seq, extent};
  float* raw_acc = nullptr;
  float* raw_m = nullptr;
  float* raw_l = nullptr;
  if (ws_acc) {
    const int64_t w0 = (int64_t)split * gridDim.x * hq + head0;
    raw_acc = ws_acc + w0 * d;
    raw_m = ws_m + w0;
    raw_l = ws_l + w0;
  }
  attend_split<T, TC, kG>(src, q + head0 * d, scale, cache_k, cache_v,
                          cache_ks, cache_vs, kTile, d, groups, t_begin,
                          t_end, extent, wstart, out + head0 * d, raw_acc,
                          raw_m, raw_l);
}

template <typename T, typename TC, int kG>
int launch(void* out, void* ws_acc, void* ws_m, void* ws_l, const void* q,
           const void* cache_k, const void* cache_v, const void* cache_ks,
           const void* cache_vs, const void* limits, int n_slots, int hkv,
           int groups, int r_rows, int d, int seq, int layer, int window,
           float scale, int splits, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  const Layout lay(stage_rows<kG>(kTile), d, groups, (int)sizeof(TC), kQuant,
                   stages<TC>());
  if (lay.npairs > kThreads) return (int)cudaErrorInvalidValue;
  auto kernel = dense_attention_kernel<T, TC, kG>;
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
  dim3 grid(n_slots * r_rows, hkv, splits);
  kernel<<<grid, kThreads, lay.total, stream>>>(
      (T*)out, (float*)ws_acc, (float*)ws_m, (float*)ws_l, (const T*)q,
      (const TC*)cache_k, (const TC*)cache_v, (const float*)cache_ks,
      (const float*)cache_vs, (const int32_t*)limits, layer, n_slots, hkv,
      seq, d, groups, r_rows, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename TC>
int launch_groups(int groups, void* out, void* ws_acc, void* ws_m, void* ws_l,
                  const void* q, const void* cache_k, const void* cache_v,
                  const void* cache_ks, const void* cache_vs,
                  const void* limits, int n_slots, int hkv, int r_rows, int d,
                  int seq, int layer, int window, float scale, int splits,
                  cudaStream_t stream) {
#define DA_ARGS                                                             \
  out, ws_acc, ws_m, ws_l, q, cache_k, cache_v, cache_ks, cache_vs, limits, \
      n_slots, hkv, groups, r_rows, d, seq, layer, window, scale, splits,   \
      stream
  if (groups <= 2) return launch<T, TC, 2>(DA_ARGS);
  if (groups <= 4) return launch<T, TC, 4>(DA_ARGS);
  return launch<T, TC, 8>(DA_ARGS);
#undef DA_ARGS
}

int dispatch(int dtype, int cache_dtype, int groups, void* out, void* ws_acc,
             void* ws_m, void* ws_l, const void* q, const void* cache_k,
             const void* cache_v, const void* cache_ks, const void* cache_vs,
             const void* limits, int n_slots, int hkv, int r_rows, int d,
             int seq, int layer, int window, float scale, int splits,
             cudaStream_t s) {
#define DA_LAUNCH(T, TC)                                                    \
  return launch_groups<T, TC>(groups, out, ws_acc, ws_m, ws_l, q, cache_k,  \
                              cache_v, cache_ks, cache_vs, limits, n_slots, \
                              hkv, r_rows, d, seq, layer, window, scale,    \
                              splits, s)
  if (dtype == 1 && cache_dtype == 1) DA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 0 && cache_dtype == 0) DA_LAUNCH(float, float);
  if (dtype == 1 && cache_dtype == 2) DA_LAUNCH(__nv_bfloat16, int8_t);
  if (dtype == 0 && cache_dtype == 2) DA_LAUNCH(float, int8_t);
#undef DA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The verify's tiles of slot b and kv head h, and each row's visited and
// live columns (the decode's per-row contract at lim = lengths + 1 + r):
// visited [tile of the window start, min(lim, S)), live [window start,
// min(lim, S)); rows(t) counts the rows below the group's last limit
struct DenseVerifySource : DenseSource {
  int tile, seq, window;
  __device__ __forceinline__ int wstart(int lim) const {
    return window > 0 && lim - window > 0 ? lim - window : 0;
  }
  __device__ __forceinline__ int clamp_seq(int lim) const {
    return lim < 0 ? 0 : (lim > seq ? seq : lim);
  }
  __device__ __forceinline__ void columns(int lim, int& vlo, int& vhi,
                                          int& llo, int& lhi) const {
    llo = wstart(lim);
    vlo = llo / kTile * kTile;
    vhi = lhi = clamp_seq(lim);
  }
  __device__ __forceinline__ void prepare(int lim_first, int lim_last,
                                          int& t_lo, int& t_end) {
    extent = clamp_seq(lim_last);
    t_lo = wstart(lim_first) / kTile;
    t_end = extent > 0 ? (extent - 1) / kTile + 1 : 0;
  }
};

// grid (n_slots * n_groups, hkv, splits)
template <typename T, typename TC, int kMT, int kD>
__global__ void __launch_bounds__(split_verify::kThreads)
dense_verify_kernel(split_verify::Args a, const int32_t* __restrict__ lengths,
                    int layer, int hkv, int seq, int window) {
  const int b = blockIdx.x / a.n_groups;
  const int h = blockIdx.y;
  const DenseVerifySource src{
      {(((int64_t)layer * a.n_slots + b) * hkv + h) * (int64_t)seq, 0},
      kTile, seq, window};
  split_verify::attend_verify<T, TC, kMT, kD>(
      a, src, b, h, blockIdx.x - b * a.n_groups, lengths[b] + 1);
}

template <typename T, typename TC, int kMT, int kD>
int launch_verify(const split_verify::Args& a, const void* lengths, int hkv,
                  int seq, int layer, int window, int splits,
                  cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  const split_verify::Layout lay(a.d, (int)sizeof(TC), (int)sizeof(T),
                                 kQuant, kMma, split_verify::kStages,
                                 split_verify::stage_cols<kMma>(), kMT * 16);
  auto kernel = dense_verify_kernel<T, TC, kMT, kD>;
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
      a, (const int32_t*)lengths, layer, hkv, seq, window);
  return (int)cudaGetLastError();
}

// the instance for the row tiles a CTA takes and D (up to 128 or 256)
template <typename T, typename TC>
int launch_verify_shapes(int row_tiles, const split_verify::Args& a,
                         const void* lengths, int hkv, int seq, int layer,
                         int window, int splits, cudaStream_t stream) {
#define DV_LAUNCH(MT, D)                                                   \
  return launch_verify<T, TC, MT, D>(a, lengths, hkv, seq, layer, window, \
                                     splits, stream)
  const bool wide = a.d > 128;
  if (row_tiles == 1) {
    if (wide) DV_LAUNCH(1, 256);
    DV_LAUNCH(1, 128);
  }
  if (row_tiles == 2) {
    if (wide) DV_LAUNCH(2, 256);
    DV_LAUNCH(2, 128);
  }
  if (wide) DV_LAUNCH(4, 256);
  DV_LAUNCH(4, 128);
#undef DV_LAUNCH
}

}  // namespace

// The decode (K4, K5): q [B, 1, Hq, D], limits [B] int32 (slot b attends
// its rows < limits[b]). dtype (q and output): 0 = float32, 1 = bfloat16.
// cache_dtype: 0 = float32, 1 = bfloat16 (both the q type), 2 = int8 with
// the float32 scale caches cache_ks / cache_vs (ignored otherwise). window
// > 0: sliding window of that many rows; 0: none. splits >= 1 CTAs per
// (slot, kv head); with splits > 1, ws_acc [splits, B, Hq, D], ws_m and
// ws_l [splits, B, Hq] float32 receive each split's triple and the combine
// (split_merge.cuh), queued next on the same stream, writes out; else they
// are null. Returns cudaGetLastError() after the launches (0 = launched).
// groups <= 8, D % 8 == 0, D <= 256 (int8: D % 16 == 0; the wrapper
// checks).
extern "C" int dense_attention(void* out, void* ws_acc, void* ws_m,
                               void* ws_l, const void* q, const void* cache_k,
                               const void* cache_v, const void* cache_ks,
                               const void* cache_vs, const void* limits,
                               int n_slots, int hkv, int groups, int d,
                               int seq, int layer, int window, float scale,
                               int dtype, int cache_dtype, int splits,
                               void* stream) {
  if (n_slots <= 0) return 0;
  if (groups < 1 || groups > kMaxGroups || window < 0 || splits < 1 ||
      (splits > 1) != (ws_acc != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = dispatch(dtype, cache_dtype, groups, out, ws_acc, ws_m, ws_l,
                          q, cache_k, cache_v, cache_ks, cache_vs, limits,
                          n_slots, hkv, 1, d, seq, layer, window, scale,
                          splits, s);
  if (rc != 0 || splits == 1) return rc;
  return split_combine::launch(out, nullptr, nullptr, nullptr, ws_acc, ws_m,
                               ws_l, splits, (long long)n_slots * hkv * groups,
                               d, dtype, s);
}

// K6, the stats form: one query row per slot (q [n_slots, 1, Hq, D]), no
// window; limits = each slot's rows in this cache (shard). With one split
// the float32 triple goes to acc [n_slots, Hq, D], m and l [n_slots, Hq];
// with more, into ws_* as above, and the combine, queued next, writes acc,
// m and l. dtype and cache_dtype as above. Returns cudaGetLastError() after
// the launches.
extern "C" int dense_attention_stats(void* acc, void* m, void* l,
                                     void* ws_acc, void* ws_m, void* ws_l,
                                     const void* q, const void* cache_k,
                                     const void* cache_v,
                                     const void* cache_ks,
                                     const void* cache_vs,
                                     const void* limits, int n_slots, int hkv,
                                     int groups, int d, int seq, int layer,
                                     float scale, int dtype, int cache_dtype,
                                     int splits, void* stream) {
  if (n_slots <= 0) return 0;
  if (groups < 1 || groups > kMaxGroups || splits < 1 ||
      (splits > 1) != (ws_acc != nullptr))
    return (int)cudaErrorInvalidValue;
  if (splits == 1) {
    ws_acc = acc;
    ws_m = m;
    ws_l = l;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = dispatch(dtype, cache_dtype, groups, nullptr, ws_acc, ws_m,
                          ws_l, q, cache_k, cache_v, cache_ks, cache_vs,
                          limits, n_slots, hkv, 1, d, seq, layer, 0, scale,
                          splits, s);
  if (rc != 0 || splits == 1) return rc;
  return split_combine::launch(nullptr, acc, m, l, ws_acc, ws_m, ws_l, splits,
                               (long long)n_slots * hkv * groups, d, -1, s);
}

// K7, the speculative verify: q [B, R, Hq, D] (B = n_slots, R = r_rows),
// out the same; lengths [B] int32 (row r of slot b has the limit
// lengths[b] + 1 + r). dtype, cache_dtype, window and the int8 scale
// caches as for dense_attention. splits >= 1 CTAs per (slot, row group,
// kv head); with splits > 1, ws_acc [splits, B * R, Hq, D], ws_m and ws_l
// [splits, B * R, Hq] float32 receive each split's triples and the
// combine, queued next on the same stream, writes out; else they are null.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int dense_attention_verify(
    void* out, void* ws_acc, void* ws_m, void* ws_l, const void* q,
    const void* cache_k, const void* cache_v, const void* cache_ks,
    const void* cache_vs, const void* lengths, int n_slots, int r_rows,
    int hkv, int groups, int d, int seq, int layer, int window, float scale,
    int dtype, int cache_dtype, int splits, void* stream) {
  if (n_slots <= 0 || r_rows <= 0) return 0;
  if (groups < 1 || groups > kMaxGroups || d < 8 || d > 256 || d % 8 ||
      window < 0 || splits < 1 || (splits > 1) != (ws_acc != nullptr))
    return (int)cudaErrorInvalidValue;
  const int tiles = split_verify::row_tiles(r_rows * groups);
  split_verify::Args a{q, out, (float*)ws_acc, (float*)ws_m, (float*)ws_l,
                       cache_k, cache_v, (const float*)cache_ks,
                       (const float*)cache_vs, n_slots, r_rows, groups,
                       hkv * groups, d,
                       (r_rows * groups + tiles * 16 - 1) / (tiles * 16),
                       scale};
  cudaStream_t s = (cudaStream_t)stream;
  int rc = (int)cudaErrorInvalidValue;
#define DV_SHAPES(T, TC)                                                  \
  rc = launch_verify_shapes<T, TC>(tiles, a, lengths, hkv, seq, layer,    \
                                   window, splits, s)
  if (dtype == 1 && cache_dtype == 1) DV_SHAPES(__nv_bfloat16, __nv_bfloat16);
  else if (dtype == 0 && cache_dtype == 0) DV_SHAPES(float, float);
  else if (dtype == 1 && cache_dtype == 2) DV_SHAPES(__nv_bfloat16, int8_t);
  else if (dtype == 0 && cache_dtype == 2) DV_SHAPES(float, int8_t);
#undef DV_SHAPES
  if (rc != 0 || splits == 1) return rc;
  return split_combine::launch(out, nullptr, nullptr, nullptr, ws_acc, ws_m,
                               ws_l, splits,
                               (long long)n_slots * r_rows * hkv * groups, d,
                               dtype, s);
}
