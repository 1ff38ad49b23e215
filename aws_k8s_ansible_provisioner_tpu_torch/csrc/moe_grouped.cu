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
//   rounded to bf16, times the scale of its expert and column, rounded
//   again (the JAX order). With a second weight (w_up) one launch computes
//   g and u of the same rows and writes silu(g) * u, each of silu(g) and
//   the product rounded to bf16 (F.silu(g) * u in bf16).
//
// Grid (N / kBN, E): fixed by the shapes, so a CUDA graph captures it. A
// CTA reads its expert's offsets and exits before it touches a weight when
// the expert has no rows, so an untouched expert costs no bytes. The CTA
// (4 warps) walks its expert's rows in tiles of kBM = 64 (warp w: rows 16w
// to 16w + 15; a warp whose rows are all past the group skips the
// products) and the contraction in stages of kBK = 64, with a two-deep
// cp.async ring (the A rows gathered through row_src and zero-filled past
// the group, the weight stage as stored: int8 or bf16, k-major). The
// products are mma.sync m16n8k16 (bf16 in, float32 sums); an int8 weight
// is converted to bf16 as its fragment is loaded (exact: |q| <= 127), so
// no dequantized copy is ever written.
//
// Bound: at decode, bytes. A launch reads the touched experts' K x N
// weights once (tiles of later row groups come from L2) plus the rows; the
// operations are 2 x rows x K x N (x 2 with the gate and up weights).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace grouped_gemm {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr int kAStride = kBK + 8;           // bf16 elements a shared A row

template <typename W>
struct WeightTraits;
template <>
struct WeightTraits<int8_t> {
  static constexpr int kStride = kBN + 16;  // bytes a shared weight row
  __device__ static float get(const int8_t* p) { return (float)*p; }
};
template <>
struct WeightTraits<__nv_bfloat16> {
  static constexpr int kStride = kBN + 8;   // elements a shared weight row
  __device__ static float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

template <typename W, int kWeights>
struct Smem {
  __nv_bfloat16 a[2][kBM][kAStride];
  W b[2][kWeights][kBK][WeightTraits<W>::kStride];
};

template <typename W, int kWeights>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const __nv_bfloat16* __restrict__ x,
               const int* __restrict__ row_src, int K, int N,
               const W* __restrict__ w0, const float* __restrict__ s0,
               const W* __restrict__ w1, const float* __restrict__ s1,
               const int* __restrict__ offsets,
               __nv_bfloat16* __restrict__ out) {
  using Tr = WeightTraits<W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<W, kWeights>& sm = *reinterpret_cast<Smem<W, kWeights>*>(smem_raw);
  const int e = blockIdx.y;
  const int begin = offsets[e];
  const int end = offsets[e + 1];
  if (end <= begin) return;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k_stages = K / kBK;
  const int row_tiles = (end - begin + kBM - 1) / kBM;
  const int total = row_tiles * k_stages;
  const long long w_off = (long long)e * K * N;
  const W* wp[2] = {w0 + w_off, kWeights > 1 ? w1 + w_off : nullptr};
  const float* sp[2] = {s0 ? s0 + (long long)e * N : nullptr,
                        (kWeights > 1 && s1) ? s1 + (long long)e * N
                                             : nullptr};

  auto load = [&](int buf, int it) {
    const int rt = it / k_stages;
    const int k0 = (it % k_stages) * kBK;
    // A: kBM rows x kBK bf16, 16 bytes (8 elements) a copy
#pragma unroll
    for (int c = tid; c < kBM * kBK / 8; c += kThreads) {
      const int r = c / (kBK / 8);
      const int col = (c % (kBK / 8)) * 8;
      const int row = begin + rt * kBM + r;
      const bool valid = row < end;
      const long long src = valid ? (row_src ? row_src[row] : row) : 0;
      cp_async16(&sm.a[buf][r][col], x + src * K + k0 + col, valid);
    }
    // weights: kBK rows of kBN columns, as stored
    constexpr int kPerRow = kBN * (int)sizeof(W) / 16;
#pragma unroll
    for (int q = 0; q < kWeights; ++q) {
      for (int c = tid; c < kBK * kPerRow; c += kThreads) {
        const int r = c / kPerRow;
        const int col = (c % kPerRow) * (16 / (int)sizeof(W));
        cp_async16(&sm.b[buf][q][r][col],
                   wp[q] + (long long)(k0 + r) * N + n0 + col, true);
      }
    }
  };

  float acc[kWeights][kBN / 8][4];
  load(0, 0);
  cp_async_commit();
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) load((it + 1) & 1, it + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int buf = it & 1;
    const int rt = it / k_stages;
    const int kc = it % k_stages;
    if (kc == 0) {
#pragma unroll
      for (int q = 0; q < kWeights; ++q)
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[q][j][i] = 0.f;
    }
    const int row_base = begin + rt * kBM + warp * 16;
    if (row_base < end) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(
            &sm.a[buf][warp * 16 + g][kk + 2 * t]);
        a[1] = *reinterpret_cast<const uint32_t*>(
            &sm.a[buf][warp * 16 + g + 8][kk + 2 * t]);
        a[2] = *reinterpret_cast<const uint32_t*>(
            &sm.a[buf][warp * 16 + g][kk + 2 * t + 8]);
        a[3] = *reinterpret_cast<const uint32_t*>(
            &sm.a[buf][warp * 16 + g + 8][kk + 2 * t + 8]);
#pragma unroll
        for (int q = 0; q < kWeights; ++q) {
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j) {
            const int n = j * 8 + g;
            const uint32_t b0 =
                pack_bf16(Tr::get(&sm.b[buf][q][kk + 2 * t][n]),
                          Tr::get(&sm.b[buf][q][kk + 2 * t + 1][n]));
            const uint32_t b1 =
                pack_bf16(Tr::get(&sm.b[buf][q][kk + 2 * t + 8][n]),
                          Tr::get(&sm.b[buf][q][kk + 2 * t + 9][n]));
            mma16816(acc[q][j], a, b0, b1);
          }
        }
      }
      if (kc == k_stages - 1) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int col = n0 + j * 8 + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row_base + g + 8 * h;
            if (row >= end) continue;
            float v[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float y = finish(acc[0][j][2 * h + i], sp[0], col + i);
              if (kWeights == 1) {
                v[i] = y;
              } else {
                const float u = finish(acc[kWeights - 1][j][2 * h + i],
                                       sp[kWeights - 1], col + i);
                const float act = round_bf16(y / (1.0f + expf(-y)));
                v[i] = act * u;
              }
            }
            *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * N +
                                               col) =
                __floats2bfloat162_rn(v[0], v[1]);
          }
        }
      }
    }
    __syncthreads();
  }
}

template <typename W, int kWeights>
int launch(const void* x, const void* row_src, int m, int K, int N, int E,
           const void* w0, const void* s0, const void* w1, const void* s1,
           const void* offsets, void* out, cudaStream_t stream) {
  (void)m;
  auto kernel = grouped_kernel<W, kWeights>;
  const int smem = (int)sizeof(Smem<W, kWeights>);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(N / kBN, E);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const int*)row_src, K, N, (const W*)w0,
      (const float*)s0, (const W*)w1, (const float*)s1, (const int*)offsets,
      (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}

}  // namespace grouped_gemm

// x [*, K] bf16; row_src [m] int32 or null; w0 (and w1 for gate + up)
// [E, K, N] int8 (quant = 1, with s0 / s1 [E, N] float32) or bf16;
// offsets [E + 1] int32; out [m, N] bf16. K and N multiples of 64. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int moe_grouped(const void* x, const void* row_src, int m, int K,
                           int N, int E, const void* w0, const void* s0,
                           const void* w1, const void* s1, int quant,
                           const void* offsets, void* out, void* stream) {
  using namespace grouped_gemm;
  if (m <= 0 || K % kBK || N % kBN || E < 1 || (quant && !s0) ||
      (quant && w1 && !s1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (quant) {
    return w1 ? launch<int8_t, 2>(x, row_src, m, K, N, E, w0, s0, w1, s1,
                                  offsets, out, s)
              : launch<int8_t, 1>(x, row_src, m, K, N, E, w0, s0, w1, s1,
                                  offsets, out, s);
  }
  return w1 ? launch<__nv_bfloat16, 2>(x, row_src, m, K, N, E, w0, nullptr,
                                       w1, nullptr, offsets, out, s)
            : launch<__nv_bfloat16, 1>(x, row_src, m, K, N, E, w0, nullptr,
                                       w1, nullptr, offsets, out, s);
}
