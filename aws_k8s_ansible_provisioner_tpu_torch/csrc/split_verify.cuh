// The speculative verify's body, shared by paged_attention.cu (K1's verify
// entry) and dense_attention.cu (K7): one CTA attends ALL the query rows of
// one slot and one kv head (R draft rows x G query heads, ordered (r, g)),
// or a group of 64 of them, over a contiguous run of the slot's tiles (a
// page, or 64 dense rows), streaming each tile ONCE through a ring of
// shared-memory stages filled by cp.async, and leaves either the
// normalized output or the float32 flash triples (acc, m, l) that the
// combine (split_merge.cuh) merges.
//
// Replaces, in aws_k8s_ansible_provisioner_tpu/ops/pallas_attention.py:
// the verify form of _paged_db_body (spec=True, behind
// decode_attend_pallas_spec_paged) and _spec_accumulate (through
// _spec_kernel_plain and _spec_kernel_quant, behind
// decode_attend_pallas_spec). Both TPU bodies stream a slot's K/V once for
// all R rows; so does this one.
//
// What bounds it on the H100: bytes, and then the arithmetic on them. A
// slot's tiles are read once for its R x G rows, so a byte of bf16 K/V
// feeds R x G flops (10 at Qwen3's R 5, G 2; 20 at Mistral's G 4): at 3.35
// TB/s that is 33-67 TFLOP/s, the whole float32 rate of the CUDA cores. So
// the products go to the tensor cores:
// - scores: S = Q K^T per stage with mma.sync m16n8k16 (bf16 in, float32
//   accumulate). q stays unscaled in bf16, where it is exact; 1/sqrt(D) and
//   the int8 K scale multiply the float32 score. ldmatrix serves Q and K
//   from padded shared rows, ldmatrix.trans serves V. int8 K and V convert
//   to bf16 exactly (|x| <= 127) in registers, four instructions a pair,
//   straight from the int8 stage: a lane's K fragment is one 32-bit load
//   (q's columns are stored in the matching order), its V fragments come
//   from ldmatrix.trans of the int8 rows read as 16-bit pairs (even and odd
//   columns in separate 8-column tiles of the output);
// - P.V: mma.sync with p (times the int8 V scale) split into two bf16
//   halves, p = hi + lo (lo = bf16(p - hi)), so P.V keeps 16 of p's bits;
// - online softmax in float32 in the MMA's accumulator layout: each warp
//   owns 16 query rows and a share of each stage's columns, keeps its own
//   running (m, l, acc) and needs no barrier per stage beyond the ring's;
//   its partial triples merge at the end, weighed by exp(m - M) like the
//   combine's;
// - the grid is (slot x row group, kv head, split): split s takes the s-th
//   of `splits` equal runs of the group's tiles, from the tile of its first
//   row's first visited column to the tile of its last row's last one.
//   `splits` comes from shapes only (slots, Hkv, the tiles a slot may
//   have, the SM count: ops/split_kv.split_count), as the decode's does.
// float32 q (the tests' type) takes the same stream and layouts with the
// products on the CUDA cores in float32 (no bf16 rounding of q or p).
//
// Each row keeps the per-row contract of the plain version (and of the
// decode body): row r of slot b has the limit lim = lim0 + r and visits
// the columns [vlo, vhi) that its own per-row walk would visit; its live
// columns [llo, lhi) are the others masked to -1e30. A column of the
// group's range that the row would not visit adds nothing (p = 0, from a
// score of -inf), so a row whose visited columns are all masked still gets
// the mean of V over exactly its own visited columns, and a split that
// holds only masked columns for a row leaves (acc, -1e30, l) that the
// combine weighs by exp(-1e30 - M) = 0 wherever the row has a live column.
//
// Each kernel file gives the body a tile source: row0(t), the first row of
// tile t in the [*, D] view of its K/V arrays (and of the [*] scale
// arrays); rows(t), how many rows of that tile exist; `tile`, its rows;
// columns(lim, ...), a row's visited and live columns; and prepare(lim of
// the group's first row, lim of its last, t_lo, t_end), the group's tiles.

#pragma once

#include "split_decode.cuh"

namespace split_verify {

using split_decode::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;   // query rows of a CTA: four 16-row tiles
constexpr int kPad = 16;       // bytes after each shared row

// columns of a stage: 16 per warp on the tensor-core path at one 16-row
// tile (four warps share a stage's columns), 8 on the float32 path, whose
// rows are twice as wide
template <bool kMma>
__host__ __device__ constexpr int stage_cols() {
  return kMma ? 64 : 32;
}

// ring stages: one in flight while one is consumed (three cost the int8
// forms more in CTAs per SM than they gained, kernel_ab.py on an H100)
constexpr int kStages = 2;

// 16-row tiles of a CTA for R x G query rows: 1, 2 or 4 (then groups of 64)
__host__ __device__ inline int row_tiles(int rows) {
  const int t = (rows < kMaxRows ? rows : kMaxRows) + 15;
  return t / 16 <= 1 ? 1 : (t / 16 <= 2 ? 2 : 4);
}

// Dynamic shared memory of one CTA (byte offsets), alike on the host (its
// size) and in the kernel: the ring of n_stages stages (K rows, V rows
// [cols][dp * elem + kPad], int8: K and V scales [cols] float32), then q
// [q_rows][dp * q_elem + kPad]. Where shared memory, not registers, bounds
// the CTAs an SM holds (bf16 K/V at two 16-row tiles and D <= 128: 78 KB
// allow two, 70 KB three), q's fragments live in registers and q passes
// through the ring's last stage (which the first stage's copies leave
// free) instead; elsewhere that cost more registers than it saved (NVIDIA
// H100 80GB HBM3, kernel_ab.py). After the last stage the ring holds the
// warps' partial triples: m, l [warps][16], acc [warps][16][d]. dp: D
// rounded up to 16 on the tensor-core path (its k-steps), else D.
struct Layout {
  int dp, row_bytes, stage_bytes, q_row, q_off, total;
  __host__ __device__ Layout(int d, int elem, int q_elem, bool quant,
                             bool mma, int n_stages, int cols, int q_rows) {
    dp = mma ? (d + 15) & ~15 : d;
    row_bytes = dp * elem + kPad;
    stage_bytes = (2 * cols * row_bytes + (quant ? 8 * cols : 0) + 15) & ~15;
    const int ring = n_stages * stage_bytes;
    const int merge = 2 * kWarps * 16 * 4 + kWarps * 16 * d * 4;
    const int top = ((ring > merge ? ring : merge) + 15) & ~15;
    q_row = dp * q_elem + kPad;
    const bool q_regs = mma && !quant && d <= 128 && q_rows == 32;
    q_off = q_regs ? (n_stages - 1) * stage_bytes : top;
    total = q_regs ? top : top + q_rows * q_row;
  }
};

// The launch's operands (pointers to the layer's arrays; q [B, R, Hq, D],
// out [B, R, Hq, D]; ws_* the split triples [splits, B * R, Hq, (D)] or
// null).
struct Args {
  const void* q;
  void* out;
  float* ws_acc;
  float* ws_m;
  float* ws_l;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  int n_slots, r_rows, groups, hq, d, n_groups;
  float scale;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned& r0,
                                        unsigned& r1, unsigned& r2,
                                        unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned& r0,
                                              unsigned& r1, unsigned& r2,
                                              unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

// c += a (16 x 16 bf16, row-major fragment) . b (16 x 8 bf16, col-major)
__device__ __forceinline__ void mma_bf16(float* c, unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<unsigned*>(&h);
}

// (x, y) as two bf16 halves: hi = bf16(x, y), lo = bf16(x - hi, y - hi)
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - f.x, y - f.y));
}

// Two int8 bytes of a 32-bit word (the byte_perm selector picks them into
// the low bytes of its 16-bit halves) as a bf16 pair, exactly: a byte's
// low 7 bits under the bf16 bits of 128 are the bf16 128 + (x & 127), and
// subtracting 128, or 256 where the byte's sign bit is set, leaves x
__device__ __forceinline__ unsigned int8x2_to_bf16(unsigned w,
                                                   unsigned sel) {
  const unsigned x = __byte_perm(w, 0, sel);
  const unsigned v = (x & 0x007f007fu) | 0x43004300u;
  const unsigned base = (x & 0x00800080u) | 0x43004300u;
  return bf16x2_bits(
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              *reinterpret_cast<const __nv_bfloat162*>(&base)));
}

// One CTA of the verify: slot b, kv head h, row group grp (rows grp * kMT
// * 16 .. of the slot's R x G rows), split blockIdx.z of gridDim.z; lim0,
// the limit of the slot's row 0. T: q and output; TC: K/V; kMT: 16-row
// tiles; kD: D rounded up to 128 or 256.
template <typename T, typename TC, int kMT, int kD, class Src>
__device__ __forceinline__ void attend_verify(const Args& a, Src src, int b,
                                              int h, int grp, int lim0) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kS = stage_cols<kMma>();
  constexpr int kCG = kWarps / kMT;   // warps that share a row tile
  constexpr int kWC = kS / kCG;       // a warp's columns of a stage
  constexpr int kNT = kWC / 8;        // ... in 8-column tiles
  constexpr int kDN = kD / 8;         // output columns in 8-column tiles
  static_assert(!kMma || kWC % 16 == 0, "P.V takes 16 columns a step");
  const float kInf = __int_as_float(0x7f800000);
  extern __shared__ __align__(16) unsigned char smem[];

  const int d = a.d, G = a.groups, R = a.r_rows;
  const int row_base = grp * kMT * 16;
  const int n_valid = min(kMT * 16, R * G - row_base);
  const Layout lay(d, (int)sizeof(TC), (int)sizeof(T), kQuant, kMma,
                   kStages, kS, kMT * 16);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mt = warp % kMT;
  const int cg = warp / kMT;
  const int gq = lane >> 2;   // the lane's rows gq and gq + 8 of its tile
  const int tq = lane & 3;    // ... and its columns 2 tq, 2 tq + 1 of each
                              // 8-column tile

  // the group's tiles and this split's run of them
  int t_lo, t_end;
  src.prepare(lim0 + row_base / G, lim0 + (row_base + n_valid - 1) / G,
              t_lo, t_end);
  const int n_tiles = t_end > t_lo ? t_end - t_lo : 0;
  const int per = (n_tiles + (int)gridDim.z - 1) / (int)gridDim.z;
  const int t_begin = t_lo + (int)blockIdx.z * per;
  int t_stop = t_lo + n_tiles < t_begin + per ? t_lo + n_tiles
                                              : t_begin + per;
  t_stop = t_stop > t_begin ? t_stop : t_begin;

  // the lane's two rows: visited [vlo, vhi) and live [llo, lhi) columns
  int vlo[2], vhi[2], llo[2], lhi[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int i = mt * 16 + gq + 8 * ri;
    vlo[ri] = vhi[ri] = llo[ri] = lhi[ri] = 0;
    if (i < n_valid)
      src.columns(lim0 + (row_base + i) / G, vlo[ri], vhi[ri], llo[ri],
                  lhi[ri]);
  }

  const int tile = src.tile;
  const int sub = (tile + kS - 1) / kS;   // stages per tile
  auto k_tile = [&](int buf) { return smem + buf * lay.stage_bytes; };
  auto v_tile = [&](int buf) { return k_tile(buf) + kS * lay.row_bytes; };
  auto k_scale = [&](int buf) {
    return reinterpret_cast<float*>(v_tile(buf) + kS * lay.row_bytes);
  };
  auto v_scale = [&](int buf) { return k_scale(buf) + kS; };
  auto stage_n = [&](int st) {
    const int left = src.rows(st / sub) - (st % sub) * kS;
    return left < kS ? left : kS;
  };
  const int vpr = d * (int)sizeof(TC) / 16;   // 16-byte vectors of a row

  auto load = [&](int st, int buf) {
    const int nr = stage_n(st);
    const int64_t r0 = src.row0(st / sub) + (st % sub) * kS;
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
  const int s_end = t_stop > t_begin
      ? (t_stop - 1) * sub + (src.rows(t_stop - 1) + kS - 1) / kS
      : s_begin;

  // the tensor-core k-steps read K columns [d, dp) of every ring row: zero
  // them once (cp.async writes only [0, d))
  if (kMma && !kQuant && lay.dp != d) {
    for (int j = tid; j < kStages * kS; j += kThreads)
      *reinterpret_cast<uint4*>(k_tile(j / kS) + (j % kS) * lay.row_bytes +
                                d * 2) = make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (s_begin + i < s_end) load(s_begin + i, i);
    split_decode::cp_async_commit();
  }
  // q: the group's rows, (r, g) order, unscaled in T; pad rows and columns
  // zero. Over int8 K the k-steps take a lane's four contiguous K bytes
  // 4 t .. 4 t + 3 of each 16 as the MMA's k = 2 t, 2 t + 1, 2 t + 8,
  // 2 t + 9: q's columns are stored in that order
  if (kMma && kQuant) {
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + lay.q_off);
    const int q_cols = lay.q_row / 2;
    const __nv_bfloat16* q = reinterpret_cast<const __nv_bfloat16*>(a.q);
    for (int i = tid; i < kMT * 16 * lay.dp; i += kThreads) {
      const int row = i / lay.dp;
      const int c = i - row * lay.dp;
      __nv_bfloat16 val = __float2bfloat16(0.f);
      if (row < n_valid && c < d) {
        const int rr = row_base + row;
        const int r = rr / G;
        const int64_t n = (int64_t)b * R + r;
        val = q[(n * a.hq + h * G + (rr - r * G)) * d + c];
      }
      const int x = c & 15;
      qs[row * q_cols + (c & ~15) + (x >> 2) * 2 + (x & 1) +
         ((x >> 1) & 1) * 8] = val;
    }
  } else {
    unsigned char* qs = smem + lay.q_off;
    constexpr int kQV = 16 / (int)sizeof(T);   // q values a 16-byte vector
    const int nq = lay.dp / kQV;
    const T* q = reinterpret_cast<const T*>(a.q);
    for (int i = tid; i < kMT * 16 * nq; i += kThreads) {
      const int row = i / nq;
      const int v = i - row * nq;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row < n_valid && v * kQV < d) {
        const int rr = row_base + row;
        const int r = rr / G;
        const int64_t n = (int64_t)b * R + r;
        const T* src_row = q + (n * a.hq + h * G + (rr - r * G)) * d;
        val = *reinterpret_cast<const uint4*>(src_row + v * kQV);
      }
      *reinterpret_cast<uint4*>(qs + row * lay.q_row + v * 16) = val;
    }
  }

  // q's fragments of the warp's 16 rows, k-step by k-step (Layout says
  // where)
  constexpr bool kQRegs = kMma && !kQuant && kD == 128 && kMT == 2;
  unsigned qf[kQRegs ? kD / 16 : 1][4];
  const unsigned qa = smem_addr(smem + lay.q_off) +
                      (mt * 16 + (lane & 15)) * lay.q_row + (lane >> 4) * 16;
  if constexpr (kQRegs) {
    __syncthreads();   // q stored; the ring's last stage is read before
                       // the first barrier of the stream refills it
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      if (kk * 16 < d)
        ldsm_x4(qa + kk * 32, qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
  }

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

    const int nr = stage_n(st);
    const int col0 = (st / sub) * tile + (st % sub) * kS;
    // the K and V rows the products read, and their stride
    const unsigned char* kb = k_tile(buf);
    const unsigned char* vb = v_tile(buf);
    const int kv_row = lay.row_bytes;
    // scores of the warp's 16 rows x kWC columns, in the MMA's layout:
    // s[nt][2 ri + e] = row gq + 8 ri, column nt * 8 + 2 tq + e
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] =
        s[nt][3] = 0.f;
    const int wc0 = cg * kWC;   // the warp's first column of the stage
    if constexpr (kMma) {
      const unsigned ka = smem_addr(kb) +
                          (wc0 + (lane >> 4) * 8 + (lane & 7)) * kv_row +
                          ((lane >> 3) & 1) * 16;
      // int8: the lane's K row of each 8-column tile, bytes 4 tq ..
      const unsigned char* k8 = kb + (wc0 + gq) * kv_row + 4 * tq;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        if (kk * 16 >= d) break;
        unsigned a0, a1, a2, a3;
        if constexpr (kQRegs) {
          a0 = qf[kk][0];
          a1 = qf[kk][1];
          a2 = qf[kk][2];
          a3 = qf[kk][3];
        } else {
          ldsm_x4(qa + kk * 32, a0, a1, a2, a3);
        }
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          unsigned b0, b1, b2, b3;
          if constexpr (kQuant) {
            const unsigned w0 = *reinterpret_cast<const unsigned*>(
                k8 + np * 16 * kv_row + kk * 16);
            const unsigned w1 = *reinterpret_cast<const unsigned*>(
                k8 + (np * 16 + 8) * kv_row + kk * 16);
            b0 = int8x2_to_bf16(w0, 0x4140);
            b1 = int8x2_to_bf16(w0, 0x4342);
            b2 = int8x2_to_bf16(w1, 0x4140);
            b3 = int8x2_to_bf16(w1, 0x4342);
          } else {
            ldsm_x4(ka + np * 16 * kv_row + kk * 32, b0, b1, b2, b3);
          }
          mma_bf16(s[2 * np], a0, a1, a2, a3, b0, b1);
          mma_bf16(s[2 * np + 1], a0, a1, a2, a3, b2, b3);
        }
      }
    } else {
      const float* q0 = reinterpret_cast<const float*>(
          smem + lay.q_off + (mt * 16 + gq) * lay.q_row);
      const float* q1 = reinterpret_cast<const float*>(
          smem + lay.q_off + (mt * 16 + gq + 8) * lay.q_row);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const unsigned char* kr =
              kb + (wc0 + nt * 8 + 2 * tq + e) * kv_row;
          float x0 = 0.f, x1 = 0.f;
          for (int c = 0; c < d; c += 4) {
            const float4 qa = *reinterpret_cast<const float4*>(q0 + c);
            const float4 qb = *reinterpret_cast<const float4*>(q1 + c);
            float4 kf;
            if constexpr (kQuant) {
              const unsigned w =
                  *reinterpret_cast<const unsigned*>(kr + c) ^ 0x80808080u;
              kf = make_float4(split_decode::byte_to_float(w, 0),
                               split_decode::byte_to_float(w, 1),
                               split_decode::byte_to_float(w, 2),
                               split_decode::byte_to_float(w, 3));
            } else {
              kf = *reinterpret_cast<const float4*>(kr + c * 4);
            }
            x0 += qa.x * kf.x + qa.y * kf.y + qa.z * kf.z + qa.w * kf.w;
            x1 += qb.x * kf.x + qb.y * kf.y + qb.z * kf.z + qb.w * kf.w;
          }
          s[nt][e] = x0;
          s[nt][2 + e] = x1;
        }
      }
    }

    // scale, mask, online softmax per row (a row's columns are spread over
    // the four lanes of its quad)
    const float* ksc = kQuant ? k_scale(buf) : nullptr;
    const float* vsc = kQuant ? v_scale(buf) : nullptr;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = wc0 + nt * 8 + 2 * tq + e;
        const int col = col0 + j;
        const float kscale = kQuant ? ksc[j] : 1.f;
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          float x = s[nt][2 * ri + e] * a.scale;
          if (kQuant) x *= kscale;
          const bool visited = j < nr && col >= vlo[ri] && col < vhi[ri];
          const bool live = col >= llo[ri] && col < lhi[ri];
          x = visited ? (live ? x : kNegInf) : -kInf;
          s[nt][2 * ri + e] = x;
          mx[ri] = fmaxf(mx[ri], x);
        }
      }
    }
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
        const int j = wc0 + nt * 8 + 2 * tq + e;
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
    // a warp's rows mostly keep their max from stage to stage
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < kDN; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
    }

    // acc += P . V over the warp's columns
    if constexpr (kMma) {
      const unsigned va = smem_addr(vb) +
                          (wc0 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                              kv_row +
                          (lane >> 4) * 16;
#pragma unroll
      for (int kc = 0; kc < kNT / 2; ++kc) {
        unsigned h0, h1, h2, h3, l0, l1, l2, l3;
        split_bf16(s[2 * kc][0], s[2 * kc][1], h0, l0);
        split_bf16(s[2 * kc][2], s[2 * kc][3], h1, l1);
        split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], h2, l2);
        split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], h3, l3);
        if constexpr (kQuant) {
          // ldmatrix.trans of int8 rows as 16-bit pairs: 16 keys x 32
          // columns a call, a lane's word of each 8 x 8 block holding
          // columns 2 gq, 2 gq + 1 of keys 2 tq, 2 tq + 1; the even
          // columns make one 8-column tile, the odd ones another
          // (out_col)
#pragma unroll
          for (int c32 = 0; c32 < kD / 32; ++c32) {
            if (c32 * 32 >= d) break;
            unsigned w[4];
            ldsm_x4_trans(va + kc * 16 * kv_row + c32 * 32, w[0], w[1], w[2],
                          w[3]);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
#pragma unroll
              for (int odd = 0; odd < 2; ++odd) {
                const unsigned sel = odd ? 0x4341 : 0x4240;
                const unsigned b0 = int8x2_to_bf16(w[2 * half], sel);
                const unsigned b1 = int8x2_to_bf16(w[2 * half + 1], sel);
                float* c = acc[4 * c32 + 2 * half + odd];
                mma_bf16(c, h0, h1, h2, h3, b0, b1);
                mma_bf16(c, l0, l1, l2, l3, b0, b1);
              }
            }
          }
        } else {
#pragma unroll
          for (int dp = 0; dp < kD / 16; ++dp) {
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
    } else {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int t2 = 0; t2 < 4; ++t2) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int src_lane = (lane & ~3) | t2;
            const float p0 =
                __shfl_sync(0xffffffffu, s[nt][e], src_lane);
            const float p1 =
                __shfl_sync(0xffffffffu, s[nt][2 + e], src_lane);
            const unsigned char* vr =
                vb + (wc0 + nt * 8 + 2 * t2 + e) * kv_row;
#pragma unroll
            for (int n = 0; n < kDN; ++n) {
              if (n * 8 >= d) break;
              const float2 vv = split_decode::load_pair<TC>(
                  vr + (n * 8 + 2 * tq) * (int)sizeof(TC));
              acc[n][0] += p0 * vv.x;
              acc[n][1] += p0 * vv.y;
              acc[n][2] += p1 * vv.x;
              acc[n][3] += p1 * vv.y;
            }
          }
        }
      }
    }
  }

  split_decode::cp_async_wait<0>();
  __syncthreads();   // every stage consumed: the ring takes the triples
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    l_run[ri] += __shfl_xor_sync(0xffffffffu, l_run[ri], 1);
    l_run[ri] += __shfl_xor_sync(0xffffffffu, l_run[ri], 2);
  }
  float* mg = reinterpret_cast<float*>(smem);   // [warps][16]
  float* lg = mg + kWarps * 16;                 // [warps][16]
  float* ag = lg + kWarps * 16;                 // [warps][16][d]
  if (tq == 0) {
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      mg[warp * 16 + gq + 8 * ri] = m_run[ri];
      lg[warp * 16 + gq + 8 * ri] = l_run[ri];
    }
  }
  // the output column of acc[n][e] (and of acc[n][2 + e], 8 rows down):
  // 8 n + 2 tq + e, but on the int8 tensor-core path tile 4 j + 2 h + o
  // holds the columns 32 j + 16 h + o + 2 (2 tq + e)
  auto out_col = [&](int n, int e) {
    if (kMma && kQuant)
      return 32 * (n / 4) + 16 * ((n / 2) % 2) + n % 2 + 2 * (2 * tq + e);
    return 8 * n + 2 * tq + e;
  };
#pragma unroll
  for (int n = 0; n < kDN; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = out_col(n, e);
      if (c < d) {
        float* r0 = ag + (warp * 16 + gq) * d + c;
        r0[0] = acc[n][e];
        r0[8 * d] = acc[n][2 + e];
      }
    }
  }
  __syncthreads();
  // merge the kCG warps' triples of each row (weights exp(m - M), as the
  // combine's), then the output or this split's triple
  const int64_t n_rows = (int64_t)a.n_slots * R;
  for (int x = tid; x < n_valid * d; x += kThreads) {
    const int row = x / d;   // row % 16 of warp (cg * kMT + row / 16)
    const int c = x - row * d;
    float m_max = kNegInf;
#pragma unroll
    for (int k = 0; k < kCG; ++k) m_max = fmaxf(m_max, mg[k * kMT * 16 + row]);
    float l_sum = 0.f, sum = 0.f;
#pragma unroll
    for (int k = 0; k < kCG; ++k) {
      const int wr = k * kMT * 16 + row;
      const float w = expf(mg[wr] - m_max);
      l_sum += lg[wr] * w;
      sum += ag[wr * d + c] * w;
    }
    const int rr = row_base + row;
    const int r = rr / G;
    const int64_t head = ((int64_t)b * R + r) * a.hq + h * G + (rr - r * G);
    if (a.ws_acc) {
      const int64_t wi = (int64_t)blockIdx.z * n_rows * a.hq + head;
      a.ws_acc[wi * d + c] = sum;
      if (c == 0) {
        a.ws_m[wi] = m_max;
        a.ws_l[wi] = l_sum;
      }
    } else {
      reinterpret_cast<T*>(a.out)[head * d + c] =
          split_decode::from_float<T>(sum / fmaxf(l_sum, 1e-9f));
    }
  }
}

}  // namespace split_verify
