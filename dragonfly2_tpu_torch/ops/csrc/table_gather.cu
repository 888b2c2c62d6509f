// Row gather out[r, :] = table[idx[r], :] for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gather_kernel` / `table_gather`
// (dragonfly2_tpu/ops/table_gather.py), which pins the [N, D] table in
// VMEM and copies one row per loop step. The GraphTransformer's gather
// mode calls it with the concatenated [k|v] table: at BASELINE config #3
// that is N = 20000 rows of D = 256 bf16 (512 bytes), gathered into
// M = N * K = 1.28 M output rows.
//
// What bounds it on this card: bytes. The output (M * 512 B = 655 MB) is
// written once and dominates; the 10 MB table is read many times but fits
// in the 50 MB L2, so its repeated reads are L2 hits. Design: one warp
// copies a row as 16-byte vectors (a 512-byte row is exactly one vector
// per lane, one fully coalesced transaction), each warp owns
// kRowsPerWarp consecutive rows and issues all their loads before any
// store so several row reads are in flight per warp, and stores are
// streaming (__stcs) so the output stream does not evict the table from
// L2. The wrapper guarantees 16-byte aligned rows whose width is a
// multiple of 16 bytes and indices inside [0, N); the kernel trusts both.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerWarp = 4;

__global__ void __launch_bounds__(kThreads)
table_gather_kernel(const uint4* __restrict__ table,
                    const int32_t* __restrict__ idx,
                    uint4* __restrict__ out, long long m, int words) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long row0 = warp * kRowsPerWarp;
  if (row0 >= m) return;
  long long src[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    src[r] = row0 + r < m ? static_cast<long long>(__ldg(idx + row0 + r)) : 0;
  }
  for (int w = lane; w < words; w += 32) {
    uint4 buf[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (row0 + r < m) buf[r] = __ldg(table + src[r] * words + w);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (row0 + r < m) __stcs(out + (row0 + r) * words + w, buf[r]);
    }
  }
}

}  // namespace

// table: [n, row_bytes] bytes, idx: [m] int32, out: [m, row_bytes] bytes.
extern "C" int df2_table_gather(const void* table, const void* idx, void* out,
                                long long m, long long row_bytes,
                                void* stream) {
  if (m > 0) {
    const long long rows_per_block = (kThreads / 32) * kRowsPerWarp;
    const long long blocks = (m + rows_per_block - 1) / rows_per_block;
    table_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(table), static_cast<const int32_t*>(idx),
        static_cast<uint4*>(out), m, static_cast<int>(row_bytes / 16));
  }
  return static_cast<int>(cudaGetLastError());
}
