// The split-KV combine (split_merge.cuh) alone, for the callers that hold
// split triples of their own (ops/split_kv.split_merge); the attention
// kernels' C entries queue it themselves.

#include "split_merge.cuh"

// dtype: 0 = float32 output, 1 = bfloat16 output (into out), -1 = the raw
// triple (into acc_out, m_out, l_out). heads = rows x heads per row.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int split_merge(void* out, void* acc_out, void* m_out, void* l_out,
                           const void* ws_acc, const void* ws_m,
                           const void* ws_l, int splits, long long heads,
                           int d, int dtype, void* stream) {
  return split_combine::launch(out, acc_out, m_out, l_out, ws_acc, ws_m,
                               ws_l, splits, heads, d, dtype,
                               (cudaStream_t)stream);
}
