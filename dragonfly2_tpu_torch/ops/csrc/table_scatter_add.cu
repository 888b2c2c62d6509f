// Row scatter-add out[j, :] = sum over {r : idx[r] = j} of ct[r, :] for
// Hopper (sm_90a), through the transpose of idx.
//
// Replaces the Pallas TPU kernel `_scatter_add_kernel` /
// `table_scatter_add` (dragonfly2_tpu/ops/table_gather.py), the backward
// of the neighbor gather. The TPU kernel keeps an f32 [N, D] accumulator
// in VMEM and adds the streamed cotangent rows into it in a serial loop.
// On this card blocks run in parallel and in no order, so an accumulator
// shared between them needs atomics, whose f32 adds land in a different
// order on every run. This kernel instead consumes the transpose of idx:
// for each output row j the ascending list of positions r with
// idx[r] = j. One warp owns one output row, walks its positions in order,
// adds each ct row into f32 registers and writes the row once in ct's
// dtype. No atomics, no zero-fill pass, no f32 [N, D] temporary, and the
// result is bit-identical run to run: each element is summed in ascending
// position order, the order of a sequential index_add_.
//
// The transpose comes in one of two layouts:
// - padded (offsets == nullptr): row j is pos[j * stride, (j + 1) * stride),
//   entries < 0 are padding. This is build_inverse_index's [N, D_max]
//   layout, which the trainer builds once per graph. It omits the
//   neighbor lists' pad slots. That is exact because in the
//   GraphTransformer a pad slot gathers row 0 and carries exactly zero
//   cotangent: its score is masked to -1e9, so its probability underflows
//   to 0 and both of its gradient paths are products with 0.
// - CSR (offsets != nullptr): row j is pos[offsets[j], offsets[j + 1]),
//   the stable sort of idx; every entry counts.
//
// What bounds it on this card: bytes. At BASELINE config #3 the
// cotangent is [1.28 M, 256] bf16 (655 MB), of which the ~1.02 M non-pad
// rows are read once each; the output is [20000, 256] bf16 (10 MB). A
// 512-byte row is one 16-byte vector per lane, and each warp issues
// kUnroll row loads before it adds any of them, so several rows are in
// flight per warp while the additions stay in position order. ct rows
// are read with streaming loads (__ldcs): each is used exactly once.
//
// The wrapper guarantees 16-byte aligned rows whose width is a multiple
// of 16 bytes, positions inside [-1, M) and offsets inside [0, M]; the
// kernel trusts all three.

#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr unsigned kFull = 0xffffffffu;

// Elements of one 16-byte vector: 8 bf16 or 4 f32.
template <bool kBf16>
struct Vec {
  static constexpr int kElems = kBf16 ? 8 : 4;

  __device__ static void add(float* acc, const uint4& v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kBf16) {
        acc[2 * i] += __uint_as_float(w[i] << 16);
        acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
      } else {
        acc[i] += __uint_as_float(w[i]);
      }
    }
  }

  __device__ static uint4 pack(const float* acc) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kBf16) {
        const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i]));
        const uint32_t hi =
            __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i + 1]));
        w[i] = lo | (hi << 16);
      } else {
        w[i] = __float_as_uint(acc[i]);
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
table_scatter_add_kernel(const uint4* __restrict__ ct,
                         const long long* __restrict__ pos,
                         const long long* __restrict__ offsets,
                         long long stride, uint4* __restrict__ out,
                         long long n_rows, int words) {
  using V = Vec<kBf16>;
  const int lane = threadIdx.x & 31;
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (row >= n_rows) return;
  const long long begin = offsets ? __ldg(offsets + row) : row * stride;
  const long long end = offsets ? __ldg(offsets + row + 1) : begin + stride;

  // Column chunks of 32 vectors (one per lane); at config #3 there is one.
  for (int w0 = 0; w0 < words; w0 += 32) {
    const int w = w0 + lane;
    const bool active = w < words;
    float acc[V::kElems];
#pragma unroll
    for (int i = 0; i < V::kElems; ++i) acc[i] = 0.f;

    for (long long base = begin; base < end; base += 32) {
      // The warp loads 32 positions at once and broadcasts them in order.
      const long long mine = base + lane < end ? __ldg(pos + base + lane) : -1;
      const unsigned valid = __ballot_sync(kFull, mine >= 0);
      const int last = 32 - __clz(valid);  // one past the last valid entry
      for (int t = 0; t < last; t += kUnroll) {
        uint4 buf[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long p = __shfl_sync(kFull, mine, (t + u) & 31);
          const bool use = t + u < last && p >= 0 && active;
          buf[u] = use ? __ldcs(ct + p * words + w) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          // Skipped entries are not added at all, not even as +0: the sum
          // keeps exactly the terms in position order.
          if (t + u < last && ((valid >> (t + u)) & 1u)) V::add(acc, buf[u]);
        }
      }
    }
    if (active) out[row * words + w] = V::pack(acc);
  }
}

}  // namespace

// ct: [m, row_bytes] bytes of bf16 (is_bf16 = 1) or f32; pos: int64
// positions; offsets: int64 [n_rows + 1] or null (padded layout of
// `stride` entries a row); out: [n_rows, row_bytes] bytes.
extern "C" int df2_table_scatter_add(int is_bf16, const void* ct,
                                     const void* pos, const void* offsets,
                                     long long stride, void* out,
                                     long long n_rows, long long row_bytes,
                                     void* stream) {
  if (n_rows > 0) {
    const long long rows_per_block = kThreads / 32;
    const unsigned blocks =
        static_cast<unsigned>((n_rows + rows_per_block - 1) / rows_per_block);
    const auto* c = static_cast<const uint4*>(ct);
    const auto* p = static_cast<const long long*>(pos);
    const auto* o = static_cast<const long long*>(offsets);
    auto* d = static_cast<uint4*>(out);
    const int words = static_cast<int>(row_bytes / 16);
    const auto s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
      table_scatter_add_kernel<true><<<blocks, kThreads, 0, s>>>(
          c, p, o, stride, d, n_rows, words);
    } else {
      table_scatter_add_kernel<false><<<blocks, kThreads, 0, s>>>(
          c, p, o, stride, d, n_rows, words);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
