// Paged K/V row write: one new K row and one new V row per packed query row,
// written in place into the page pool.
//
// Replaces: aws_k8s_ansible_provisioner_tpu/ops/pallas_attention.py:
//   cache_write_row_paged (called once for K and once for V per layer).
//
// Contract (same as the TPU kernel): pool [L, P, Hkv, ps, D]; new rows
// [N, Hkv, D]; rows [N] int32; table [N, max_pages] int32. Row n lands at
// page table[n, rows[n] / ps], offset rows[n] % ps. A row outside
// [0, max_pages * ps) is dropped, and that check comes BEFORE the table is
// read: padding tables hold OOB_PAGE (INT32_MAX) and mixed_step's dead
// passenger carries row -1. A page id outside [0, P) is dropped as well.
//
// What bounds it on the H100: bytes. It moves N * Hkv * D * elem bytes in
// and the same out, for K and for V, and does no arithmetic. The design
// keeps those bytes in as few transactions as the layout allows: one CTA per
// packed row; each thread copies 16 bytes, so a warp covers 512 contiguous
// bytes of a head row (one D=128 bf16 row is 256 bytes); K and V go in one
// launch (the attention paths always write both). The copy is byte-exact,
// so one kernel serves bf16 and float32 pools.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void cache_write_rows_paged_kernel(
    uint4* __restrict__ pool_k, uint4* __restrict__ pool_v,
    const uint4* __restrict__ k_new, const uint4* __restrict__ v_new,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ table,
    int layer, int num_pages, int hkv, int ps, int vec_per_row,
    int max_pages) {
  const int n = blockIdx.x;
  const int row = rows[n];
  if (row < 0 || row >= max_pages * ps) return;   // dropped: table unread
  const int page = table[(int64_t)n * max_pages + row / ps];
  if (page < 0 || page >= num_pages) return;
  const int off = row % ps;
  const int total = hkv * vec_per_row;
  const int64_t page_base =
      ((int64_t)layer * num_pages + page) * hkv * ps * vec_per_row;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int h = i / vec_per_row;
    const int c = i - h * vec_per_row;
    const int64_t dst = page_base + ((int64_t)h * ps + off) * vec_per_row + c;
    const int64_t src = (int64_t)n * total + i;
    pool_k[dst] = k_new[src];
    pool_v[dst] = v_new[src];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
// row_bytes = D * element size; a multiple of 16 (the wrapper checks).
extern "C" int cache_write_rows_paged(
    void* pool_k, void* pool_v, const void* k_new, const void* v_new,
    const void* rows, const void* table, int n_rows, int layer,
    int num_pages, int hkv, int ps, int row_bytes, int max_pages,
    void* stream) {
  if (n_rows <= 0) return 0;
  const int vec_per_row = row_bytes / 16;
  int threads = hkv * vec_per_row;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  cache_write_rows_paged_kernel<<<n_rows, threads, 0,
                                  (cudaStream_t)stream>>>(
      (uint4*)pool_k, (uint4*)pool_v, (const uint4*)k_new,
      (const uint4*)v_new, (const int32_t*)rows, (const int32_t*)table,
      layer, num_pages, hkv, ps, vec_per_row, max_pages);
  return (int)cudaGetLastError();
}
