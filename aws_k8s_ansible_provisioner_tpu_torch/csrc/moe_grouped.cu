// Grouped expert product of the Qwen3-MoE MLP (ops/moe.py grouped_matmul,
// grouped_gate_up).
//
// Replaces no pallas_call: the JAX package's ops/moe.py leaves
// _expert_ffn_ragged's jax.lax.ragged_dot to XLA, which fuses the int8
// upcast of the experts into the grouped product. Here:
//
//   y[r] = x[src(r)] @ W[e] for the sorted rows r in [offsets[e],
//   offsets[e + 1]), src(r) = row_src[r] (the token of a sorted row) or r;
//   W [E, K, N] bf16, or int8 beside float32 scales [E, N]: the product
//   summed in float32, rounded to bf16, times the scale of its expert and
//   column, rounded again (the JAX order). With a second weight (w_up) one
//   launch computes g and u of the same rows and writes silu(g) * u, each
//   of silu(g) and the product rounded to bf16 (F.silu(g) * u in bf16).
//
// Bound: bytes, in every serving case up to a mixed dispatch of 32 + 512
// tokens (27 GFLOP against 0.12 ms of weight bytes at Qwen3-30B-A3B's
// widths): a launch reads the touched experts' K x N weights once. At
// decode an expert has 1 to 8 rows and at skew a few experts hold every
// row, so the design keeps many weight bytes in flight whatever the groups:
//
// - Roles swapped: the weight columns are the M side of mma.sync m16n8k16
//   and an expert's rows its N side, so a group of 1 to 8 rows fills one n8
//   tile. A row tile holds 4 n8 tiles (narrow, 32 rows) or 8 (wide, 64
//   rows); only the live ones are loaded and multiplied, the product loop
//   instantiated for each count so that it has no branch. A larger group
//   takes several row tiles. The caller's rows an expert (m / E) pick the
//   tiles: under 16, narrow (more warps busy at decode and skew); from 16,
//   wide (half the passes over each weight tile for mixed and prefill
//   dispatches).
// - Every warp on the product: a work item (expert, column tile of 128
//   weight bytes a row, row tile) goes to one worker: a warp a weight, or
//   two for int8 wide (64 columns each); with gate + up the up warps hand
//   their rounded u to the gate warps through shared memory for silu(g) *
//   u. A warp owns its tile's whole contraction, so each output is one
//   float32 chain over k in 16-deep steps from k = 0, as cuBLAS sums the
//   plain version's products: no split of the contraction, no cross-warp
//   or cross-CTA sum; the result is the plain one bit for bit and never
//   depends on scheduling. (A contraction split over warps and CTAs, tried
//   first, differed from plain by up to 3 bf16 ulps a row after the
//   silu(g) * u and int8 scale roundings.)
// - int8 converted in registers: a thread reads 16 bytes (narrow; 8 wide)
//   of one k row from each of the 4 k rows of its fragment, one shared load
//   each, conflict-free under the box's swizzle. A byte becomes a float by
//   one byte permute into the mantissa of 2^23 and one subtraction (exact
//   for |q| <= 128), two floats one bf16 pair by one more permute (their
//   low halves are zero). The column order inside a tile is the fragments'
//   (column kThreadCols * g + 2j + h of the thread's g); the epilogue
//   writes each value to its true column. bf16 weights pair their two k
//   rows with one permute.
// - A deep asynchronous ring a worker: a stage is kSK = 32 k rows of its
//   weights, one TMA box a weight (32 x 128 bytes, 128-byte swizzled) from
//   a 3-D tensor map over [E, K, N] encoded on the host, and the same k
//   columns of its rows, gathered through row_src by cp.async (TMA gathers
//   no rows; one bulk copy a row measured slower); both land on the
//   stage's mbarrier. The CTA's ring memory is shared among its busy
//   workers, so a CTA with fewer items keeps more stages in flight for each
//   (3 to kMaxDepth = 16 stages a worker).
// - A persistent walk: the grid is the card's SMs (one CTA an SM), fixed by
//   the device, so the decode graphs capture it. Each CTA reads offsets,
//   counts each expert's row tiles (an empty expert gives no item and reads
//   no byte) and its worker w walks the items b + G * (w + P * j) (G CTAs,
//   P workers a CTA): the row tiles of one weight tile sit on neighbouring
//   CTAs (read once from memory, again from L2), and every CTA's first
//   worker is busy before any second one.
//
// All products are mma.sync; wgmma is not used: a warpgroup's 64-column
// tile would need the converted weights in its register layout, and the
// measured limit at decode is the conversion and the instruction rate of
// a few warps an SM, not the tensor rate.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace grouped_gemm {

constexpr int kThreads = 256;              // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 128;            // weight bytes of a tile row
constexpr int kSK = 32;                    // k rows a stage
constexpr int kXStride = kSK + 8;          // bf16 a shared row of a stage
constexpr int kMaxDepth = 16;              // stages of a worker's ring
constexpr int kMaxExperts = 256;
constexpr int kSmem = 226 * 1024;          // dynamic shared memory a CTA

struct Params {
  const __nv_bfloat16* x;
  const int* row_src;
  int K, N, E;
  const void* w0;
  const void* w1;
  const float* s0;
  const float* s1;
  const int* offsets;
  __nv_bfloat16* out;
};

// A warp computes kCols / kHalves columns x kRows rows of one weight:
// narrow, 32 rows (4 n8 tiles) of the tile's 128 int8 columns (8 m16
// tiles, 16 bytes a k row a thread) or 64 bf16 ones (4 m16 tiles, 16
// bytes); wide, 64 rows (8 n8 tiles) of 64 columns (4 m16 tiles), an int8
// tile taking two warps a weight (8 bytes a k row a thread). At most 128
// accumulators a thread.
template <typename W, int kWeights_, bool kWide = false>
struct Tile {
  using Weight = W;
  static constexpr int kWeights = kWeights_;
  static constexpr int kCols = kTileBytes / (int)sizeof(W);  // 128 or 64
  static constexpr int kHalves = kWide ? kCols / 64 : 1;     // warps a weight
  static constexpr int kMT = kCols / kHalves / 16;           // m16 tiles
  static constexpr int kNT = kWide ? 8 : 4;                  // n8 tiles
  static constexpr int kRows = 8 * kNT;                      // a row tile
  static constexpr int kThreadCols = kCols / kHalves / 8;    // a thread's
  static constexpr int kReadBytes = kThreadCols * (int)sizeof(W);
  static constexpr int kWorkerWarps = kWeights * kHalves;
  static constexpr int kWorkers = kWarps / kWorkerWarps;
  static constexpr int kWorkerThreads = 32 * kWorkerWarps;
  // the 16-byte row copies (two a row of a stage) a worker thread makes
  static constexpr int kRowCopies = kRows * 2 / kWorkerThreads;
  static constexpr int kBox = kSK * kTileBytes;  // one weight's TMA box
  static constexpr int kWBytes = kWeights * kBox;
  // a stage: the weight boxes, then the rows; 1024-byte aligned (swizzle)
  static constexpr int kStage =
      (kWBytes + kRows * kXStride * 2 + 1023) / 1024 * 1024;
  // the up warps' rounded u for the gate warps, bf16, [half][value][lane]
  static constexpr int kXch =
      kWeights > 1 ? kHalves * kMT * kNT * 4 * 32 * 2 : 0;
  static constexpr int kSched = 2 * (kMaxExperts + 1) * 4 + 8;
  static constexpr int kHeader = kSched + kWorkers * (kMaxDepth * 8 + kXch);
  static constexpr int kRing = kSmem - kHeader - 1024;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the stage's barrier: one arrival a worker thread when its row copies
// land, one with the weight boxes' byte count
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n));
}

// an arrival on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// one box of a weight's tensor map (3-D: column, k row, expert) into
// shared memory, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int k, int e,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(k), "r"(e),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two floats holding integers of at most 8 significant bits as a bf16 pair:
// their high halves (the low halves are zero, so this is exact)
__device__ __forceinline__ uint32_t pack_int(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// byte b of a word of int8 (already xor 0x80: q + 128) as a float: the byte
// in the mantissa of 2^23, minus 2^23 + 128
__device__ __forceinline__ float i8(uint32_t biased, int b) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | b)) -
         8388736.0f;
}

// The A fragment of m16 tile j from the thread's 16 bytes of the k rows
// 2t, 2t + 1, 2t + 8, 2t + 9 (r0..r3): rows g and g + 8 of the tile are
// the thread's columns 2j and 2j + 1.
template <typename W>
struct Frag;
template <>
struct Frag<int8_t> {
  __device__ __forceinline__ static void get(const uint32_t* r0,
                                             const uint32_t* r1,
                                             const uint32_t* r2,
                                             const uint32_t* r3, int j,
                                             uint32_t* a) {
    const int w = j >> 1;
    const int b = 2 * (j & 1);
    a[0] = pack_int(i8(r0[w], b), i8(r1[w], b));
    a[1] = pack_int(i8(r0[w], b + 1), i8(r1[w], b + 1));
    a[2] = pack_int(i8(r2[w], b), i8(r3[w], b));
    a[3] = pack_int(i8(r2[w], b + 1), i8(r3[w], b + 1));
  }
  __device__ __forceinline__ static uint32_t prep(uint32_t v) {
    return v ^ 0x80808080u;
  }
};
template <>
struct Frag<__nv_bfloat16> {
  __device__ __forceinline__ static void get(const uint32_t* r0,
                                             const uint32_t* r1,
                                             const uint32_t* r2,
                                             const uint32_t* r3, int j,
                                             uint32_t* a) {
    a[0] = __byte_perm(r0[j], r1[j], 0x5410);
    a[1] = __byte_perm(r0[j], r1[j], 0x7632);
    a[2] = __byte_perm(r2[j], r3[j], 0x5410);
    a[3] = __byte_perm(r2[j], r3[j], 0x7632);
  }
  __device__ __forceinline__ static uint32_t prep(uint32_t v) { return v; }
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the epilogue of one product: rounded to bf16; int8: times the scale,
// rounded again
__device__ __forceinline__ float finish(float acc, const float* scale,
                                        int col) {
  const float v = round_bf16(acc);
  return scale ? round_bf16(v * scale[col]) : v;
}



struct Item {
  int e, row0, rows, n0;
};

// The work items of a launch: each expert's row tiles prefix-summed in
// pre[E + 1]; cols column tiles of kcols columns an expert's row tile.
struct Walk {
  const int* pre;
  const int* off;
  int E, cols, kcols, tile_rows;

  __device__ __forceinline__ Item item(int i) const {
    const int q = i / cols;
    int lo = 0, hi = E - 1;  // the last expert whose first tile is <= q
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pre[mid] <= q) lo = mid; else hi = mid - 1;
    }
    const int tiles = pre[lo + 1] - pre[lo];
    const int l = i - pre[lo] * cols;
    const int rt = l % tiles;
    Item it;
    it.e = lo;
    it.row0 = off[lo] + rt * tile_rows;
    it.rows = min(tile_rows, off[lo + 1] - it.row0);
    it.n0 = (l / tiles) * kcols;
    return it;
  }
};

// the worker's own barrier: its warp, or its warps (barrier 1 + w)
template <int kWorkerWarps>
__device__ __forceinline__ void worker_sync(int worker) {
  if (kWorkerWarps == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + worker),
                 "r"(32 * kWorkerWarps));
  }
}

// The products of one stage over NT live n8 tiles: for each 16-deep step,
// the thread's 4 k rows of 8 columns of weights (16 bf16 or 8 int8 bytes at
// byte `part` of its row; the box's 128-byte swizzle puts 16-byte chunk c
// of row r at c ^ (r & 7)), its B fragments of the rows, then kMT m16
// tiles converted and multiplied.
template <class T, int NT>
__device__ __forceinline__ void stage_products(
    float (&acc)[T::kMT][T::kNT][4], const unsigned char* box, int part,
    const __nv_bfloat16* xs, int g, int t) {
  using F = Frag<typename T::Weight>;
  constexpr int kMT = T::kMT;
#pragma unroll
  for (int kk = 0; kk < kSK; kk += 16) {
    uint32_t r[4][4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int row = kk + 2 * t + (h & 1) + 8 * (h >> 1);
      const unsigned char* src = box + row * kTileBytes +
                                 ((((part >> 4) ^ (row & 7)) << 4) |
                                  (part & 15));
      if (T::kReadBytes == 8) {
        const uint2 v2 = *reinterpret_cast<const uint2*>(src);
        r[h][0] = F::prep(v2.x);
        r[h][1] = F::prep(v2.y);
      } else {
        const uint4 v4 = *reinterpret_cast<const uint4*>(src);
        r[h][0] = F::prep(v4.x);
        r[h][1] = F::prep(v4.y);
        r[h][2] = F::prep(v4.z);
        r[h][3] = F::prep(v4.w);
      }
    }
    uint32_t bf[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* xr = xs + (8 * n + g) * kXStride + kk + 2 * t;
      bf[n][0] = *reinterpret_cast<const uint32_t*>(xr);
      bf[n][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
    }
#pragma unroll
    for (int j = 0; j < kMT; ++j) {
      uint32_t a[4];
      F::get(r[0], r[1], r[2], r[3], j, a);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma16816(acc[j][n], a, bf[n][0], bf[n][1]);
    }
  }
}

// stage_products for the live n8 tiles nt, branch-free inside
template <class T, int NT>
__device__ __forceinline__ void products_upto(
    int nt, float (&acc)[T::kMT][T::kNT][4], const unsigned char* box,
    int part, const __nv_bfloat16* xs, int g, int t) {
  if constexpr (NT < T::kNT) {
    if (nt > NT) {
      products_upto<T, NT + 1>(nt, acc, box, part, xs, g, t);
      return;
    }
  }
  stage_products<T, NT>(acc, box, part, xs, g, t);
}

template <class T>
__global__ void __launch_bounds__(kThreads, 1)
grouped_kernel(const Params p, const __grid_constant__ CUtensorMap map0,
               const __grid_constant__ CUtensorMap map1) {
  using W = typename T::Weight;
  constexpr int kWeights = T::kWeights;
  constexpr int kMT = T::kMT;
  constexpr int kNT = T::kNT;
  constexpr int kRows = T::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  int* pre = reinterpret_cast<int*>(smem);
  int* off = pre + kMaxExperts + 1;
  __shared__ int warp_sum[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int E = p.E;
  const int K = p.K;
  const int N = p.N;

  // each expert's row tiles, an inclusive scan over the experts
  for (int i = tid; i <= E; i += kThreads) off[i] = p.offsets[i];
  int v = 0;
  if (tid < E) {
    const int rows = p.offsets[tid + 1] - p.offsets[tid];
    v = rows > 0 ? (rows + kRows - 1) / kRows : 0;
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += warp_sum[w];
  pre[tid + 1] = base + v;
  if (tid == 0) pre[0] = 0;
  __syncthreads();

  // the items of this CTA's workers: b + G * (w + P * j)
  constexpr int P = T::kWorkers;
  const int cols = N / T::kCols;
  const int units = pre[E] * cols;
  const int b = blockIdx.x;
  const int G = gridDim.x;
  const int busy = min(P, max(0, (units - b + G - 1) / G));
  const int worker = warp / T::kWorkerWarps;
  if (worker >= busy) return;  // no barrier of the CTA follows
  const int depth = min(kMaxDepth, T::kRing / (busy * T::kStage));
  const unsigned smem_base = smem_u32(smem);
  unsigned char* ring = smem + (((smem_base + T::kHeader + 1023) & ~1023u) -
                                smem_base) +
                        worker * depth * T::kStage;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + T::kSched) + worker * kMaxDepth;
  __nv_bfloat16* xch = reinterpret_cast<__nv_bfloat16*>(
      smem + T::kSched + P * kMaxDepth * 8 + worker * T::kXch);
  const int first = b + G * worker;
  const int stride = G * P;
  const int n_items = (units - first + stride - 1) / stride;
  const int nk = K / kSK;  // stages an item
  const int steps = n_items * nk;
  const Walk walk{pre, off, E, cols, T::kCols, kRows};
  const int wt = tid - worker * T::kWorkerThreads;  // thread of the worker
  const int lw = warp % T::kWorkerWarps;
  const int wq = lw / T::kHalves;  // the warp's weight
  const int wh = lw % T::kHalves;  // and its part of the tile's columns
  // the byte of a box row where this thread's columns start
  const int part = (wh * 8 + g) * T::kReadBytes;
  if (wt == 0)
    for (int s = 0; s < depth; ++s) mbar_init(bars + s, T::kWorkerThreads + 1);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  worker_sync<T::kWorkerWarps>(worker);

  // the loads run depth - 1 stages ahead of the products, across items;
  // a thread copies the same half of one row's k columns each stage (16
  // bytes at a time; a row past the group reads as zeros)
  Item load_it = walk.item(first);
  int load_kc = 0;
  int load_slot = 0;
  long long xsrc[T::kRowCopies];
  auto rows_of = [&](const Item& it) {
#pragma unroll
    for (int h = 0; h < T::kRowCopies; ++h) {
      const int r = (wt + h * T::kWorkerThreads) >> 1;
      const int row = it.row0 + r;
      xsrc[h] = r < it.rows ? (p.row_src ? p.row_src[row] : row) : -1;
    }
  };
  rows_of(load_it);
  auto load = [&](int step) {
    const Item& it = load_it;
    const int k0 = load_kc * kSK;
    unsigned char* st = ring + load_slot * T::kStage;
    uint64_t* bar = bars + load_slot;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + T::kWBytes);
    const int live = (it.rows + 7) & ~7;
#pragma unroll
    for (int h = 0; h < T::kRowCopies; ++h) {
      const int c = wt + h * T::kWorkerThreads;
      if (c < live * 2) {
        const int r = c >> 1;
        const bool valid = xsrc[h] >= 0;
        const __nv_bfloat16* src = p.x + (valid ? xsrc[h] : 0) * K + k0;
#pragma unroll
        for (int ch = c & 1; ch < kSK / 8; ch += 2)
          cp_async16(xs + r * kXStride + 8 * ch, src + 8 * ch, valid);
      }
    }
    cp_async_arrive(bar);
    if (wt == 0) {
      mbar_expect_tx(bar, T::kWBytes);
      tma_load(st, &map0, it.n0, k0, it.e, bar);
      if (kWeights > 1) tma_load(st + T::kBox, &map1, it.n0, k0, it.e, bar);
    }
    load_slot = load_slot + 1 == depth ? 0 : load_slot + 1;
    if (++load_kc == nk && step + 1 < steps) {
      load_kc = 0;
      load_it = walk.item(first + ((step + 1) / nk) * stride);
      rows_of(load_it);
    }
  };

  float acc[kMT][kNT][4];
  Item it = load_it;  // the item of the products
  int kc = 0;
  int slot = 0;
  unsigned parity = 0;  // bit s: the phase stage slot s waits for
  int nt = (it.rows + 7) >> 3;

  for (int s = 0; s < depth - 1 && s < steps; ++s) load(s);
  for (int step = 0; step < steps; ++step) {
    mbar_wait(bars + slot, (parity >> slot) & 1u);
    parity ^= 1u << slot;
    worker_sync<T::kWorkerWarps>(worker);
    if (step + depth - 1 < steps) load(step + depth - 1);
    if (kc == nk) {
      kc = 0;
      it = walk.item(first + (step / nk) * stride);
      nt = (it.rows + 7) >> 3;
    }
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < kMT; ++j)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][n][i] = 0.f;
    }
    const unsigned char* st = ring + slot * T::kStage;
    slot = slot + 1 == depth ? 0 : slot + 1;
    const unsigned char* box = st + wq * T::kBox;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(st + T::kWBytes);
    products_upto<T, 1>(nt, acc, box, part, xs, g, t);
    if (++kc != nk) continue;
    // the item's epilogue: acc[j][n][h + 2c] is row 8n + 2t + h, column
    // kThreadCols * g + 2j + c of the tile
    const float* scale = wq ? p.s1 : p.s0;
    const float* sc = scale ? scale + (size_t)it.e * N + it.n0 : nullptr;
    if (kWeights > 1 && wq == 1) {
#pragma unroll
      for (int j = 0; j < kMT; ++j) {
        const int col = T::kThreadCols * (8 * wh + g) + 2 * j;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (n >= nt) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            xch[(((wh * kMT + j) * kNT + n) * 4 + i) * 32 + lane] =
                __float2bfloat16(finish(acc[j][n][i], sc, col + (i >> 1)));
        }
      }
    }
    if (kWeights > 1) worker_sync<T::kWorkerWarps>(worker);
    if (wq == 0) {
#pragma unroll
      for (int j = 0; j < kMT; ++j) {
        const int col = T::kThreadCols * (8 * wh + g) + 2 * j;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (n >= nt) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 8 * n + 2 * t + h;
            if (row >= it.rows) continue;
            float o[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int i = h + 2 * c;
              const float y = finish(acc[j][n][i], sc, col + c);
              if (kWeights == 1) {
                o[c] = y;
              } else {
                const float u = __bfloat162float(
                    xch[(((wh * kMT + j) * kNT + n) * 4 + i) * 32 + lane]);
                o[c] = round_bf16(y / (1.0f + expf(-y))) * u;
              }
            }
            *reinterpret_cast<uint32_t*>(
                p.out + (size_t)(it.row0 + row) * N + it.n0 + col) =
                pack_bf16(o[0], o[1]);
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime's
// entry-point query (nothing new is linked)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// the tensor map of one weight [E, K, N]: boxes of kSK k rows x 128 bytes
template <typename W>
static bool weight_map(CUtensorMap* map, const void* w, int E, int K, int N) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N * sizeof(W),
                                 (cuuint64_t)K * N * sizeof(W)};
  const cuuint32_t box[3] = {(cuuint32_t)(kTileBytes / sizeof(W)),
                             (cuuint32_t)kSK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map,
                sizeof(W) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(w), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class T>
int launch_tile(const Params& p, int sms, cudaStream_t stream) {
  using W = typename T::Weight;
  constexpr int kWeights = T::kWeights;
  static_assert(T::kRing >= 3 * T::kWorkers * T::kStage,
                "a busy CTA keeps 3 stages a worker");
  auto kernel = grouped_kernel<T>;
  if (p.K % kSK || p.N % T::kCols) return (int)cudaErrorInvalidValue;
  CUtensorMap map0, map1;
  if (!weight_map<W>(&map0, p.w0, p.E, p.K, p.N) ||
      !weight_map<W>(&map1, kWeights > 1 ? p.w1 : p.w0, p.E, p.K, p.N))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  kernel<<<sms, kThreads, kSmem, stream>>>(p, map0, map1);
  return (int)cudaGetLastError();
}


// rows: the sorted rows over the experts (m / E). Groups of 16 rows or
// more on average take the wide tiles (64 rows: half the passes over each
// weight tile for mixed and prefill dispatches); smaller ones the narrow
// (int8: one warp a weight's 128 columns, half the items; bf16: half the
// rows a warp; more of the card busy at decode and skew).
template <typename W, int kWeights>
int launch(const Params& p, int sms, int rows, cudaStream_t stream) {
  if (rows >= 16) return launch_tile<Tile<W, kWeights, true>>(p, sms, stream);
  return launch_tile<Tile<W, kWeights>>(p, sms, stream);
}

}  // namespace grouped_gemm

// x [*, K] bf16; row_src [m] int32 or null; w0 (and w1 for gate + up)
// [E, K, N] int8 (quant = 1, with s0 / s1 [E, N] float32) or bf16;
// offsets [E + 1] int32; out [m, N] bf16; grid: CTAs of the persistent
// walk (the card's SMs). K a multiple of 32, N of 128 (int8) or 64 (bf16),
// E <= 256; the weights 16-byte aligned. Returns cudaGetLastError() after
// the launch (0 = launched; cudaErrorInvalidValue also when a tensor map
// cannot be encoded).
extern "C" int moe_grouped(const void* x, const void* row_src, int m, int K,
                           int N, int E, const void* w0, const void* s0,
                           const void* w1, const void* s1, int quant,
                           const void* offsets, void* out, int grid,
                           void* stream) {
  using namespace grouped_gemm;
  if (m <= 0 || E < 1 || E > kMaxExperts || grid < 1 || (quant && !s0) ||
      (quant && w1 && !s1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = (const __nv_bfloat16*)x;
  p.row_src = (const int*)row_src;
  p.K = K;
  p.N = N;
  p.E = E;
  p.w0 = w0;
  p.w1 = w1;
  p.s0 = quant ? (const float*)s0 : nullptr;
  p.s1 = quant ? (const float*)s1 : nullptr;
  p.offsets = (const int*)offsets;
  p.out = (__nv_bfloat16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = m / E;
  if (quant)
    return w1 ? launch<int8_t, 2>(p, grid, rows, s)
              : launch<int8_t, 1>(p, grid, rows, s);
  return w1 ? launch<__nv_bfloat16, 2>(p, grid, rows, s)
            : launch<__nv_bfloat16, 1>(p, grid, rows, s);
}
