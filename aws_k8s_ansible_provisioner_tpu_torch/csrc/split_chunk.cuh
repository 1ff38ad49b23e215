// The ragged entry's chunk body, used by paged_attention.cu: the C rows of
// one prefill chunk (rows chunk_start.. of the packed batch) share their
// slot's table row and have limits lim0, lim0 + 1, ..., lim0 + C - 1. One
// CTA takes a ROW TILE, 128 consecutive rows of the chunk's C x G query
// rows of one kv head (ordered (chunk row, head)), and streams the slot's
// pages ONCE for the whole tile through a ring of shared-memory stages
// filled by cp.async, where the per-row body read them once per chunk row.
//
// Replaces, in aws_k8s_ansible_provisioner_tpu/ops/pallas_attention.py:
// _paged_flash_db / _paged_db_body behind ragged_attend_pallas_paged for
// the chunk's rows (the bf16 body _paged_db_kernel and the int8 body
// _paged_db_kernel_quant, window 0 and window > 0). The TPU body walks a
// block of bblock packed rows over the pages of each; this body walks one
// range of pages for 128 rows of one slot.
//
// What bounds it on the H100: the arithmetic once the pages are shared. A
// chunk of C rows over a window of W columns does 4 C Hq W D flops and
// reads its slot's K/V once per row tile, so a page byte feeds 128 query
// rows (G heads of 128 / G chunk rows): ~128 flops a byte, beyond what
// the CUDA cores can do at the memory's rate. So:
// - S = Q K^T and P.V run on the tensor cores, mma.sync m16n8k16 (bf16 in,
//   float32 accumulate), with split_verify.cuh's fragments: q unscaled in
//   bf16 (exact), 1/sqrt(D) and the int8 K scale on the float32 score; p
//   (times the int8 V scale) enters P.V as two bf16 halves, hi + lo, so the
//   products keep 16 of p's bits and each row stays within one bf16 ulp of
//   the float32 plain version;
// - over an int8 pool the 256 threads convert each landed stage's K and V
//   to bf16 (exact for |x| <= 127) once, into shared memory, and the warps
//   read it as the bf16 pool's stage: the 8 warps would otherwise each
//   convert every K and V value of the stage for their own fragments;
// - each of the 8 warps owns 16 of the tile's rows across ALL columns of a
//   stage (FlashAttention-2's split over rows): its online softmax (m, l,
//   acc) lives in registers in the MMA's accumulator layout, and the warps
//   never merge with each other;
// - masks only where needed: a stage whose columns lie inside every live
//   range of the warp's rows (and inside the stage's rows) skips the mask;
//   elsewhere a column a row would not visit scores -inf (p = 0) and a
//   visited column outside [limit - window, limit) scores -1e30, so each
//   row gets exactly its own per-row result, the C2 mean of a row without
//   a live column included;
// - the grid is (row tile, kv head, split): split s takes the s-th of
//   `splits` equal runs of the tile's pages, from the page of its first
//   row's first visited column to the page of its last row's last one,
//   and with more than one split leaves the float32 triples (acc, m, l)
//   for the combine (split_merge.cuh). `splits` comes from shapes only
//   (row tiles, Hkv, max_pages, the SM count: ops/split_kv.chunk_splits),
//   so the launch geometry is fixed for a dispatch shape (a CUDA graph can
//   hold it).
// Shared memory: two stages of 64 columns (K and V rows padded by 16 bytes,
// the int8 scales), the int8 stage's bf16 copy, then q [128][D + 8] bf16:
// 102 KB at D 128 over a bf16 pool, 105 KB over an int8 one, two CTAs an
// SM. Two instances of the output width KD: 128 (any D a multiple of 16 up
// to 128) and 256 (Gemma's D). At 256 a warp's accumulators are 32 tiles of
// 4 floats (128 registers a thread) and the CTA's shared memory 198 KB
// (bf16 pool) or 201 KB (int8): one CTA an SM, launch bounds (256, 1), so
// that the 255 registers a thread hold the accumulators, the scores and
// the fragments; the row tile stays 128 rows (8 warps of 16), so a page
// still feeds 128 query rows (8 chunk rows of an MQA head group of 8).

#pragma once

#include "split_merge.cuh"
#include "split_verify.cuh"

namespace split_chunk {

using split_decode::kNegInf;
using split_verify::int8x2_to_bf16;
using split_verify::ldsm_x4;
using split_verify::ldsm_x4_trans;
using split_verify::mma_bf16;
using split_verify::smem_addr;
using split_verify::split_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;   // query rows of a row tile
constexpr int kS = 64;               // columns of a stage
constexpr int kStages = 2;
// the largest D of each instance (a multiple of 16)
constexpr int kD = 128;
constexpr int kDWide = 256;
// CTAs an SM the instance of output width KD is built for
template <int KD>
constexpr int ctas_per_sm() { return KD <= kD ? 2 : 1; }
constexpr int kPad = 16;             // bytes after each shared row

// Dynamic shared memory of one CTA (byte offsets), alike on the host and in
// the kernel: the ring (K rows, V rows [kS][d * elem + kPad], int8: K and
// V scales [kS] float32); over an int8 pool the stage's K and V rows
// converted to bf16 [kS][2 d + kPad] each; then q [kRows][2 d + kPad].
struct Layout {
  int row_bytes, stage_bytes, cvt_row, cvt_off, q_row, q_off, total;
  __host__ __device__ Layout(int d, int elem, bool quant) {
    row_bytes = d * elem + kPad;
    stage_bytes = (2 * kS * row_bytes + (quant ? 8 * kS : 0) + 15) & ~15;
    cvt_row = 2 * d + kPad;
    cvt_off = kStages * stage_bytes;
    q_off = cvt_off + (quant ? 2 * kS * cvt_row : 0);
    q_row = 2 * d + kPad;
    total = q_off + kRows * q_row;
  }
};

// The launch's operands: q and out point at the chunk's first row ([C, Hq,
// D] bf16); ws_* the split triples [splits, C, Hq, (D)] or null; k, v, ks,
// vs the whole pools; lim0 the chunk's first limit (on the device);
// table_row the slot's table row [max_pages].
struct Args {
  const __nv_bfloat16* q;
  __nv_bfloat16* out;
  float* ws_acc;
  float* ws_m;
  float* ws_l;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int32_t* lim0;
  const int32_t* table_row;
  int n_rows, groups, hq, d, ps, num_pages, hkv, max_pages, window, layer;
  float scale;
};

// the first and last logical page a row of limit `lim` visits (the per-row
// contract of paged_attention.cu)
__device__ __forceinline__ void row_pages(const Args& a, int lim, int& lo,
                                          int& hi) {
  hi = lim > 0 ? (lim + a.ps - 1) / a.ps - 1 : 0;
  hi = hi < a.max_pages - 1 ? hi : a.max_pages - 1;
  lo = 0;
  if (a.window > 0) {
    lo = (lim - a.window > 0 ? lim - a.window : 0) / a.ps;
    lo = lo < hi ? lo : hi;
  }
}

// grid (row tiles, hkv, splits); TC: the pool's type (bf16 or int8); KD:
// the largest D the accumulators hold
template <typename TC, int KD>
__global__ void __launch_bounds__(kThreads, ctas_per_sm<KD>())
chunk_kernel(Args a) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  constexpr int kNT = kS / 8;    // a stage's columns in 8-column tiles
  constexpr int kDN = KD / 8;    // output columns in 8-column tiles
  const float kInf = __int_as_float(0x7f800000);
  extern __shared__ __align__(16) unsigned char smem[];

  const int d = a.d, G = a.groups, ps = a.ps;
  const int h = blockIdx.y;
  const int row_base = blockIdx.x * kRows;
  const int n_valid = min(kRows, a.n_rows * G - row_base);
  const Layout lay(d, (int)sizeof(TC), kQuant);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;   // the lane's rows gq and gq + 8 of its warp's
  const int tq = lane & 3;    // ... and its columns 2 tq, 2 tq + 1 of each
                              // 8-column tile
  const int lim0 = *a.lim0;

  // the tile's pages and this split's run of them
  int t_lo, t_hi, other;
  row_pages(a, lim0 + row_base / G, t_lo, other);
  row_pages(a, lim0 + (row_base + n_valid - 1) / G, other, t_hi);
  const int n_tiles = t_hi + 1 - t_lo;
  const int per = (n_tiles + (int)gridDim.z - 1) / (int)gridDim.z;
  const int t_begin = t_lo + (int)blockIdx.z * per;
  const int t_stop = min(t_hi + 1, t_begin + per);
  const int64_t n_heads = (int64_t)a.n_rows * a.hq;

  // the lane's two rows: visited [vlo, vhi) and live [llo, lhi) columns;
  // a row past the chunk visits none
  int vlo[2], vhi[2], llo[2], lhi[2];
  int64_t head[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int i = warp * 16 + gq + 8 * ri;
    vlo[ri] = vhi[ri] = llo[ri] = lhi[ri] = 0;
    head[ri] = -1;
    if (i < n_valid) {
      const int rr = row_base + i;
      const int r = rr / G;
      const int lim = lim0 + r;
      int lo, hi;
      row_pages(a, lim, lo, hi);
      vlo[ri] = lo * ps;
      vhi[ri] = (hi + 1) * ps;
      llo[ri] = a.window > 0 ? lim - a.window : 0;
      lhi[ri] = lim;
      head[ri] = (int64_t)r * a.hq + h * G + (rr - r * G);
    }
  }

  if (t_stop <= t_begin) {
    // an empty split: (0, -1e30, 0) for every row of the tile
    for (int x = tid; x < n_valid * d; x += kThreads) {
      const int rr = row_base + x / d;
      const int r = rr / G;
      const int64_t hd = (int64_t)r * a.hq + h * G + (rr - r * G);
      const int64_t wi = (int64_t)blockIdx.z * n_heads + hd;
      a.ws_acc[wi * d + x % d] = 0.f;
      if (x % d == 0) {
        a.ws_m[wi] = kNegInf;
        a.ws_l[wi] = 0.f;
      }
    }
    return;
  }

  const int sub = (ps + kS - 1) / kS;   // stages per page
  auto k_tile = [&](int buf) { return smem + buf * lay.stage_bytes; };
  auto v_tile = [&](int buf) { return k_tile(buf) + kS * lay.row_bytes; };
  auto k_scale = [&](int buf) {
    return reinterpret_cast<float*>(v_tile(buf) + kS * lay.row_bytes);
  };
  auto v_scale = [&](int buf) { return k_scale(buf) + kS; };
  auto stage_n = [&](int st) {
    const int left = ps - (st % sub) * kS;
    return left < kS ? left : kS;
  };
  const int64_t layer_page0 = (int64_t)a.layer * a.num_pages;
  auto row0 = [&](int t) {
    int page = a.table_row[t];
    page = page < 0 ? 0 : (page >= a.num_pages ? a.num_pages - 1 : page);
    return ((layer_page0 + page) * a.hkv + h) * (int64_t)ps;
  };
  const int vpr = d * (int)sizeof(TC) / 16;   // 16-byte vectors of a row

  auto load = [&](int st, int buf) {
    const int nr = stage_n(st);
    const int64_t r0 = row0(st / sub) + (st % sub) * kS;
    const unsigned char* gk =
        reinterpret_cast<const unsigned char*>(a.k) + r0 * d * sizeof(TC);
    const unsigned char* gv =
        reinterpret_cast<const unsigned char*>(a.v) + r0 * d * sizeof(TC);
    unsigned char* sk = k_tile(buf);
    unsigned char* sv = v_tile(buf);
    for (int i = tid; i < nr * vpr; i += kThreads) {
      const int j = i / vpr;
      const int off = j * lay.row_bytes + (i - j * vpr) * 16;
      split_decode::cp_async16(sk + off, gk + (int64_t)i * 16);
      split_decode::cp_async16(sv + off, gv + (int64_t)i * 16);
    }
    if (kQuant) {
      for (int i = tid; i < nr; i += kThreads) {
        split_decode::cp_async4(k_scale(buf) + i, a.ks + r0 + i);
        split_decode::cp_async4(v_scale(buf) + i, a.vs + r0 + i);
      }
    } else {
      // rows past the stage's: p is 0 there, so V must hold no NaN (int8
      // bytes are always finite numbers)
      for (int i = nr * vpr + tid; i < kS * vpr; i += kThreads) {
        const int j = i / vpr;
        *reinterpret_cast<uint4*>(sv + j * lay.row_bytes +
                                  (i - j * vpr) * 16) = make_uint4(0, 0, 0,
                                                                   0);
      }
    }
  };

  const int s_begin = t_begin * sub;
  const int s_end = t_stop * sub;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (s_begin + i < s_end) load(s_begin + i, i);
    split_decode::cp_async_commit();
  }
  // q: the tile's rows, (chunk row, head) order, unscaled bf16; rows past
  // the chunk zero
  {
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + lay.q_off);
    const int q_cols = lay.q_row / 2;
    const int nq = d / 8;   // 16-byte vectors of a q row
    for (int i = tid; i < kRows * nq; i += kThreads) {
      const int row = i / nq;
      const int vv = i - row * nq;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row < n_valid) {
        const int rr = row_base + row;
        const int r = rr / G;
        val = *reinterpret_cast<const uint4*>(
            a.q + ((int64_t)r * a.hq + h * G + (rr - r * G)) * d + vv * 8);
      }
      *reinterpret_cast<uint4*>(qs + row * q_cols + vv * 8) = val;
    }
  }

  const bool warp_live = warp * 16 < n_valid;
  const unsigned qa = smem_addr(smem + lay.q_off) +
                      (warp * 16 + (lane & 15)) * lay.q_row +
                      (lane >> 4) * 16;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  float acc[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) acc[n][0] = acc[n][1] = acc[n][2] =
      acc[n][3] = 0.f;

  for (int st = s_begin; st < s_end; ++st) {
    const int i = st - s_begin;
    const int buf = i % kStages;
    split_decode::cp_async_wait<kStages - 2>();
    __syncthreads();   // stage st landed for all; stage st - 1 consumed
    if (st + kStages - 1 < s_end)
      load(st + kStages - 1, (i + kStages - 1) % kStages);
    split_decode::cp_async_commit();
    if constexpr (kQuant) {
      // the stage's int8 K and V rows as bf16 (exact), once for all warps;
      // rows past the stage's convert stale bytes, finite numbers whose p
      // is 0
      const int wpr = d / 4;   // 32-bit words of an int8 row
      for (int x = tid; x < kS * wpr; x += kThreads) {
        const int j = x / wpr;
        const int w = x - j * wpr;
        const unsigned wk = *reinterpret_cast<const unsigned*>(
            k_tile(buf) + j * lay.row_bytes + 4 * w);
        const unsigned wv = *reinterpret_cast<const unsigned*>(
            v_tile(buf) + j * lay.row_bytes + 4 * w);
        unsigned char* dst = smem + lay.cvt_off + j * lay.cvt_row + 8 * w;
        *reinterpret_cast<uint2*>(dst) = make_uint2(
            int8x2_to_bf16(wk, 0x4140), int8x2_to_bf16(wk, 0x4342));
        *reinterpret_cast<uint2*>(dst + kS * lay.cvt_row) = make_uint2(
            int8x2_to_bf16(wv, 0x4140), int8x2_to_bf16(wv, 0x4342));
      }
      __syncthreads();   // converted for all
    }
    if (!warp_live) continue;

    const int nr = stage_n(st);
    const int col0 = (st / sub) * ps + (st % sub) * kS;
    // the bf16 K and V rows the products read, and their stride
    const unsigned char* kb = kQuant ? smem + lay.cvt_off : k_tile(buf);
    const unsigned char* vb = kb + kS * lay.cvt_row;
    const int kv_row = lay.cvt_row;
    // scores of the warp's 16 rows x kS columns, in the MMA's layout:
    // s[nt][2 ri + e] = row gq + 8 ri, column nt * 8 + 2 tq + e
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] =
        s[nt][3] = 0.f;
    {
      const unsigned ka = smem_addr(kb) +
                          ((lane >> 4) * 8 + (lane & 7)) * kv_row +
                          ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int kk = 0; kk < KD / 16; ++kk) {
        if (kk * 16 >= d) break;
        unsigned a0, a1, a2, a3;
        ldsm_x4(qa + kk * 32, a0, a1, a2, a3);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          unsigned b0, b1, b2, b3;
          ldsm_x4(ka + np * 16 * kv_row + kk * 32, b0, b1, b2, b3);
          mma_bf16(s[2 * np], a0, a1, a2, a3, b0, b1);
          mma_bf16(s[2 * np + 1], a0, a1, a2, a3, b2, b3);
        }
      }
    }

    // scale and mask. A stage inside every live range of the warp's rows
    // needs no mask (a row's live columns lie inside its visited ones)
    const float* ksc = kQuant ? k_scale(buf) : nullptr;
    const float* vsc = kQuant ? v_scale(buf) : nullptr;
    const bool inside =
        nr == kS && col0 >= llo[0] && col0 >= llo[1] &&
        col0 + kS <= lhi[0] && col0 + kS <= lhi[1] && col0 >= vlo[0] &&
        col0 >= vlo[1] && col0 + kS <= vhi[0] && col0 + kS <= vhi[1];
    const bool no_mask = __all_sync(0xffffffffu, inside);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * tq + e;
        const int col = col0 + j;
        const float kscale = kQuant ? ksc[j] : 1.f;
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          float x = s[nt][2 * ri + e] * a.scale;
          if (kQuant) x *= kscale;
          if (!no_mask) {
            const bool visited = j < nr && col >= vlo[ri] && col < vhi[ri];
            const bool live = col >= llo[ri] && col < lhi[ri];
            x = visited ? (live ? x : kNegInf) : -kInf;
          }
          s[nt][2 * ri + e] = x;
          mx[ri] = fmaxf(mx[ri], x);
        }
      }
    }
    // online softmax per row (a row's columns are spread over the four
    // lanes of its quad)
    float corr[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
      const float m_new = fmaxf(m_run[ri], mx[ri]);
      corr[ri] = expf(m_run[ri] - m_new);
      m_run[ri] = m_new;
      l_run[ri] *= corr[ri];
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * tq + e;
        const float vscale = kQuant ? vsc[j] : 1.f;
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const float p = expf(s[nt][2 * ri + e] - m_run[ri]);
          l_run[ri] += p;
          // the int8 V scale enters P.V; a column past the stage's rows
          // (p = 0) may have a stale scale
          s[nt][2 * ri + e] = kQuant ? (j < nr ? p * vscale : 0.f) : p;
        }
      }
    }
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < kDN; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
    }

    // acc += P . V over the stage's columns
    const unsigned va = smem_addr(vb) +
                        (((lane >> 3) & 1) * 8 + (lane & 7)) * kv_row +
                        (lane >> 4) * 16;
#pragma unroll
    for (int kc = 0; kc < kNT / 2; ++kc) {
      unsigned h0, h1, h2, h3, l0, l1, l2, l3;
      split_bf16(s[2 * kc][0], s[2 * kc][1], h0, l0);
      split_bf16(s[2 * kc][2], s[2 * kc][3], h1, l1);
      split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], h2, l2);
      split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], h3, l3);
#pragma unroll
      for (int dp = 0; dp < KD / 16; ++dp) {
        if (dp * 16 >= d) break;
        unsigned b0, b1, b2, b3;
        ldsm_x4_trans(va + kc * 16 * kv_row + dp * 32, b0, b1, b2, b3);
        mma_bf16(acc[2 * dp], h0, h1, h2, h3, b0, b1);
        mma_bf16(acc[2 * dp], l0, l1, l2, l3, b0, b1);
        mma_bf16(acc[2 * dp + 1], h0, h1, h2, h3, b2, b3);
        mma_bf16(acc[2 * dp + 1], l0, l1, l2, l3, b2, b3);
      }
    }
  }
  split_decode::cp_async_wait<0>();

  // each warp's rows are its own: the output, or this split's triples
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    l_run[ri] += __shfl_xor_sync(0xffffffffu, l_run[ri], 1);
    l_run[ri] += __shfl_xor_sync(0xffffffffu, l_run[ri], 2);
  }
  // the output column of acc[n][e] (and of acc[n][2 + e], 8 rows down)
  auto out_col = [&](int n, int e) { return 8 * n + 2 * tq + e; };
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (head[ri] < 0) continue;
    if (a.ws_acc) {
      const int64_t wi = (int64_t)blockIdx.z * n_heads + head[ri];
      float* dst = a.ws_acc + wi * d;
#pragma unroll
      for (int n = 0; n < kDN; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = out_col(n, e);
          if (c < d) dst[c] = acc[n][2 * ri + e];
        }
      }
      if (tq == 0) {
        a.ws_m[wi] = m_run[ri];
        a.ws_l[wi] = l_run[ri];
      }
    } else {
      const float l = fmaxf(l_run[ri], 1e-9f);
      __nv_bfloat16* dst = a.out + head[ri] * d;
#pragma unroll
      for (int n = 0; n < kDN; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = out_col(n, e);
          if (c < d) dst[c] = __float2bfloat16(acc[n][2 * ri + e] / l);
        }
      }
    }
  }
}

// Queue the chunk body's kernel (the instance of output width KD) and, with
// more than one split, the combine on `s`. TC: the pool's type. Returns
// cudaGetLastError() (0 = launched).
template <typename TC, int KD>
int launch_width(const Args& a, int splits, cudaStream_t s) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  const Layout lay(a.d, (int)sizeof(TC), kQuant);
  auto kernel = chunk_kernel<TC, KD>;
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
  const int tiles = (a.n_rows * a.groups + kRows - 1) / kRows;
  dim3 grid(tiles, a.hkv, splits);
  kernel<<<grid, kThreads, lay.total, s>>>(a);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || splits == 1) return rc;
  return split_combine::launch(a.out, nullptr, nullptr, nullptr, a.ws_acc,
                               a.ws_m, a.ws_l, splits,
                               (long long)a.n_rows * a.hq, a.d, 1, s);
}

// D a multiple of 16 up to 128 takes the KD 128 instance, D 256 the KD 256
// one; any other D is refused.
template <typename TC>
int launch(const Args& a, int splits, cudaStream_t s) {
  if (a.d >= 16 && a.d <= kD && a.d % 16 == 0)
    return launch_width<TC, kD>(a, splits, s);
  if (a.d == kDWide) return launch_width<TC, kDWide>(a, splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace split_chunk
