// Route and sort of the Qwen3-MoE MLP (ops/moe.py route_sort).
//
// Replaces no pallas_call: the JAX package's ops/moe.py leaves route (the
// softmax over the experts and jax.lax.top_k) and moe_mlp_ragged's
// argsort / bincount / gather to XLA. On the card a plain torch version
// would need the group sizes on the host (a sync a layer, which breaks the
// decode graphs) and CUDA torch.topk, whose tie order is not specified.
//
// Input: float32 router logits [N, E] (E <= kMaxExperts, k <= kMaxTopK).
// Three launches on one stream, no sync to the host, no atomics:
//   1. route_topk: one warp a token. Softmax over all E (max, expf of the
//      differences, a warp sum in a fixed order, a division), then k rounds
//      of a warp argmax (the larger probability, on a tie the lower expert
//      index: jax.lax.top_k's order), the renormalization by
//      max(sum of the k, 1e-9) when asked, the weights rounded to the
//      activation dtype. Each block of kBlockTokens tokens then counts its
//      assignments per expert and ranks each assignment among the block's
//      earlier ones of the same expert (one thread an expert walks the
//      block's assignments in flat order), into counts[block][e] and pos.
//   2. route_scan: one CTA, one thread an expert: the expert's total over
//      the blocks, an exclusive scan over the experts (offsets [E + 1]),
//      then counts[block][e] turned into the block's first sorted row of e.
//   3. route_scatter: pos[f] += counts[block(f)][e(f)], and the sorted row
//      p = pos[f] gets its token f / k and expert. The order is stable by
//      (expert, flat index): torch.argsort(flat, stable=True).
// Bounded by launches and latency at serving sizes (N * k * 4 bytes a
// tensor, a few KB at decode).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace moe_route {

constexpr int kMaxExperts = 256;
constexpr int kMaxTopK = 32;
constexpr int kBlockTokens = 32;
constexpr int kThreads = 256;            // 8 warps, 4 tokens each
constexpr int kPerLane = kMaxExperts / 32;

__global__ void __launch_bounds__(kThreads)
route_topk(const float* __restrict__ logits, int n, int e_count, int k,
           int norm, void* __restrict__ weights, int w_bf16,
           int* __restrict__ experts, int* __restrict__ pos,
           int* __restrict__ counts) {
  __shared__ int sh_e[kBlockTokens * kMaxTopK];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tok0 = blockIdx.x * kBlockTokens;
  const int n_tok = min(kBlockTokens, n - tok0);
  for (int t = warp; t < n_tok; t += kThreads / 32) {
    const int tok = tok0 + t;
    const float* row = logits + (long long)tok * e_count;
    float v[kPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int e = lane + 32 * i;
      v[i] = e < e_count ? row[e] : -INFINITY;
      m = fmaxf(m, v[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      v[i] = lane + 32 * i < e_count ? expf(v[i] - m) : 0.f;
      s += v[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    unsigned taken = 0;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      v[i] = v[i] / s;
      if (lane + 32 * i >= e_count) taken |= 1u << i;
    }
    float sel_w = 0.f, total = 0.f;
    int sel_e = 0;
    for (int j = 0; j < k; ++j) {
      float bv = -1.f;
      int bi = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        // ascending expert index within the lane: strict > keeps the lower
        if (!(taken >> i & 1u) && v[i] > bv) {
          bv = v[i];
          bi = lane + 32 * i;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if ((bi & 31) == lane) taken |= 1u << (bi >> 5);
      total += bv;
      if (lane == j) {
        sel_w = bv;
        sel_e = bi;
      }
    }
    if (lane < k) {
      float w = sel_w;
      if (norm) w = w / fmaxf(total, 1e-9f);
      const long long f = (long long)tok * k + lane;
      if (w_bf16)
        reinterpret_cast<__nv_bfloat16*>(weights)[f] = __float2bfloat16(w);
      else
        reinterpret_cast<float*>(weights)[f] = w;
      experts[f] = sel_e;
      sh_e[t * k + lane] = sel_e;
    }
  }
  __syncthreads();
  // per-expert count of the block and each assignment's rank among the
  // block's earlier assignments of its expert
  const int n_asg = n_tok * k;
  const long long f0 = (long long)tok0 * k;
  for (int e = threadIdx.x; e < e_count; e += kThreads) {
    int c = 0;
    for (int a = 0; a < n_asg; ++a) {
      if (sh_e[a] == e) pos[f0 + a] = c++;
    }
    counts[(long long)blockIdx.x * e_count + e] = c;
  }
}

__global__ void __launch_bounds__(kMaxExperts)
route_scan(int* __restrict__ counts, int blocks, int e_count,
           int* __restrict__ offsets) {
  __shared__ int sh_total[kMaxExperts];
  const int e = threadIdx.x;
  int total = 0;
  if (e < e_count) {
    for (int b = 0; b < blocks; ++b) total += counts[(long long)b * e_count + e];
  }
  sh_total[e] = total;
  __syncthreads();
  if (e == 0) {
    int run = 0;
    for (int i = 0; i < e_count; ++i) {
      const int t = sh_total[i];
      sh_total[i] = run;
      run += t;
    }
    offsets[e_count] = run;
  }
  __syncthreads();
  if (e < e_count) {
    int run = sh_total[e];
    offsets[e] = run;
    for (int b = 0; b < blocks; ++b) {
      int* c = counts + (long long)b * e_count + e;
      const int here = *c;
      *c = run;
      run += here;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
route_scatter(const int* __restrict__ experts, const int* __restrict__ counts,
              int n, int e_count, int k, int* __restrict__ pos,
              int* __restrict__ row_token, int* __restrict__ row_expert) {
  const int tok0 = blockIdx.x * kBlockTokens;
  const int n_asg = min(kBlockTokens, n - tok0) * k;
  const long long f0 = (long long)tok0 * k;
  for (int a = threadIdx.x; a < n_asg; a += kThreads) {
    const long long f = f0 + a;
    const int e = experts[f];
    const int p = counts[(long long)blockIdx.x * e_count + e] + pos[f];
    pos[f] = p;
    row_token[p] = (int)(f / k);
    row_expert[p] = e;
  }
}

}  // namespace moe_route

// w_dtype: 0 = float32 weights, 1 = bfloat16. counts: [cdiv(n, 32), E]
// int32 scratch. Returns cudaGetLastError() after the launches (0 = all
// three launched).
extern "C" int moe_route_sort(const void* logits, int n, int e_count, int k,
                              int norm, void* weights, int w_dtype,
                              void* experts, void* offsets, void* row_token,
                              void* row_expert, void* pos, void* counts,
                              void* stream) {
  using namespace moe_route;
  if (n <= 0 || e_count < 1 || e_count > kMaxExperts || k < 1 ||
      k > kMaxTopK || k > e_count)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n + kBlockTokens - 1) / kBlockTokens;
  route_topk<<<blocks, kThreads, 0, s>>>(
      (const float*)logits, n, e_count, k, norm, weights, w_dtype,
      (int*)experts, (int*)pos, (int*)counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  route_scan<<<1, kMaxExperts, 0, s>>>((int*)counts, blocks, e_count,
                                       (int*)offsets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  route_scatter<<<blocks, kThreads, 0, s>>>(
      (const int*)experts, (const int*)counts, n, e_count, k, (int*)pos,
      (int*)row_token, (int*)row_expert);
  return (int)cudaGetLastError();
}
