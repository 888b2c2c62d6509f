// Row gather out[r, :] = table[idx[r], :] for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gather_kernel` / `table_gather`
// (dragonfly2_tpu/ops/table_gather.py), which pins the [N, D] table in
// VMEM and copies one row per loop step. Two paths call it: the
// GraphTransformer's gather mode with the concatenated [k|v] table (at
// BASELINE config #3, N = 20000 rows of D = 256 bf16, 512 bytes, gathered
// into M = N * K = 1.28 M output rows), and GraphSAGE's node-feature
// gather (config #2: a [2000, 8] f32 table, 32-byte rows, about 1 M
// indices a step).
//
// What bounds it on this card: bytes. The output (M rows) is written once
// and dominates; the table is read many times but fits in the 50 MB L2,
// so its repeated reads are L2 hits. Design: threads are mapped over the
// output's 16-byte words. A row of W words gets L lanes, L the power of
// two at or above W (at most 32), so one warp instruction covers 32 / L
// consecutive rows (a 32-byte row: 16 rows, 2 lanes each; a 512-byte row:
// one row, a word a lane) and every lane of a power-of-two width is busy
// on consecutive output addresses; rows wider than 32 words take 32 words
// a step. Powers of two make the lane-to-(row, word) map two shifts and a
// mask, with no division; the widths on the paths (2 and 32 words) are
// powers of two, and any other width keeps more than half its lanes busy.
// Each warp owns kSteps such row groups and issues all their loads before
// any store, so several reads are in flight per thread; lanes of one row
// read its index from the same address; stores are streaming (__stcs) so
// the output stream does not evict the table from L2. The wrapper
// guarantees 16-byte aligned rows whose width is a multiple of 16 bytes
// and indices inside [0, N); the kernel trusts both.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 4;  // row groups a warp

__global__ void __launch_bounds__(kThreads)
table_gather_kernel(const uint4* __restrict__ table,
                    const int32_t* __restrict__ idx,
                    uint4* __restrict__ out, long long m, int words,
                    int lane_shift) {
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << lane_shift;             // lanes a row
  const int group_rows = 32 >> lane_shift;       // rows a warp instruction
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long row0 =
      warp * kSteps * group_rows + (lane >> lane_shift);
  const int word0 = lane & (lanes - 1);
  long long src[kSteps];
  bool live[kSteps];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const long long r = row0 + j * group_rows;
    live[j] = r < m && word0 < words;
    src[j] = live[j] ? static_cast<long long>(__ldg(idx + r)) : 0;
  }
  for (int w = word0; w < words; w += lanes) {
    uint4 buf[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (live[j]) buf[j] = __ldg(table + src[j] * words + w);
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (live[j]) {
        __stcs(out + (row0 + j * group_rows) * words + w, buf[j]);
      }
    }
  }
}

}  // namespace

// table: [n, row_bytes] bytes, idx: [m] int32, out: [m, row_bytes] bytes.
extern "C" int df2_table_gather(const void* table, const void* idx, void* out,
                                long long m, long long row_bytes,
                                void* stream) {
  if (m > 0) {
    const int words = static_cast<int>(row_bytes / 16);
    int lane_shift = 0;
    while (lane_shift < 5 && (1 << lane_shift) < words) ++lane_shift;
    const long long rows_per_block =
        (kThreads / 32) * kSteps * (32 >> lane_shift);
    const long long blocks = (m + rows_per_block - 1) / rows_per_block;
    table_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(table), static_cast<const int32_t*>(idx),
        static_cast<uint4*>(out), m, words, lane_shift);
  }
  return static_cast<int>(cudaGetLastError());
}
