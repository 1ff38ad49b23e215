// The combine step of the split-KV decode attention: merges each (row,
// head)'s split triples in split order, no atomics, so a result repeats bit
// for bit. paged_attention.cu and dense_attention.cu queue it from their own
// C entries, right after the attention kernel on the same stream (one call
// from the host for both launches); split_merge.cu exposes it alone.
//
// Replaces no TPU kernel of its own: the TPU bodies walk a row's pages in
// one grid loop (pallas_attention.py _paged_db_body, _decode_kernel_layer*)
// and need no combine. It is the log-sum-exp merge of the JAX package's
// sequence-parallel decode (ops/attention.py:157-162, a pmax and two psums
// over sp) applied to the splits of one launch, with one difference that
// the paged contract needs: a split is weighed by exp(m_s - M) whatever its
// m_s. An empty split (acc 0, m -1e30, l 0) then adds exactly 0, and a row
// whose only visited page is wholly masked (a paged row of limit <= 0: m
// -1e30, p = 1 on every column) keeps the mean of V it had unsplit, where
// the merge's "m <= -1e29 weighs 0" rule would zero it.
//
// Contract: ws_acc [splits, H, D], ws_m and ws_l [splits, H] float32 (H =
// rows x heads). M = max_s m_s, w_s = exp(m_s - M), l = sum_s l_s w_s, acc =
// sum_s acc_s w_s. Writes out [H, D] = acc / max(l, 1e-9) in the output
// type, or (raw) the triple acc_out [H, D], m_out = M, l_out = l.
//
// What bounds it on the H100: bytes, (splits x (D + 2) x 4 + D x out
// bytes) per (row, head); one thread per output value, each re-reading its
// head's splits' m and l (from L1).

#pragma once

#include "split_decode.cuh"

namespace split_combine {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
split_merge_kernel(T* __restrict__ out, float* __restrict__ acc_out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   const float* __restrict__ ws_acc,
                   const float* __restrict__ ws_m,
                   const float* __restrict__ ws_l, int splits, int64_t heads,
                   int d) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= heads * d) return;
  const int64_t hd = i / d;
  float m_max = split_decode::kNegInf;
  for (int s = 0; s < splits; ++s) m_max = fmaxf(m_max, ws_m[s * heads + hd]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(ws_m[s * heads + hd] - m_max);
    l += ws_l[s * heads + hd] * w;
    acc += ws_acc[s * heads * d + i] * w;
  }
  if (out) {
    out[i] = split_decode::from_float<T>(acc / fmaxf(l, 1e-9f));
  } else {
    acc_out[i] = acc;
    if (i - hd * d == 0) {
      m_out[hd] = m_max;
      l_out[hd] = l;
    }
  }
}

// Queue the combine on `stream`. dtype: 0 = float32 output, 1 = bfloat16
// output (into out), -1 = the raw triple (into acc_out, m_out, l_out);
// heads = rows x heads per row. Returns cudaGetLastError() after the
// launch (0 = launched).
inline int launch(void* out, void* acc_out, void* m_out, void* l_out,
                  const void* ws_acc, const void* ws_m, const void* ws_l,
                  int splits, long long heads, int d, int dtype,
                  cudaStream_t s) {
  if (heads <= 0 || d <= 0) return 0;
  if (splits < 1 || dtype < -1 || dtype > 1) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)heads * d;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  const float* a = (const float*)ws_acc;
  const float* m = (const float*)ws_m;
  const float* l = (const float*)ws_l;
  if (dtype == 1)
    split_merge_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (__nv_bfloat16*)out, nullptr, nullptr, nullptr, a, m, l, splits,
        heads, d);
  else if (dtype == 0)
    split_merge_kernel<float><<<blocks, kThreads, 0, s>>>(
        (float*)out, nullptr, nullptr, nullptr, a, m, l, splits, heads, d);
  else
    split_merge_kernel<float><<<blocks, kThreads, 0, s>>>(
        nullptr, (float*)acc_out, (float*)m_out, (float*)l_out, a, m, l,
        splits, heads, d);
  return (int)cudaGetLastError();
}

}  // namespace split_combine
