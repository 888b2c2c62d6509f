// Neighbor-masked graph attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_graph_kernel` / `graph_flash_attention`
// (dragonfly2_tpu/ops/flash_attention.py). Same function: for query row i
// and head h, score every listed neighbor c = nbr[i, s] that lies in
// [0, Nk) as (q[i,h] . k[c,h]) * scale + val[i, s]; softmax over those
// scores with f32 max / sum / accumulator; p rounded to the input type
// before P.V, as the TPU kernel does; out = acc / max(l, 1e-20). Slots
// outside [0, Nk) (PAD_ID padding) are masked, and a row with no valid
// slot outputs 0.
//
// The TPU kernel scores every (q-block, k-block) tile densely and builds
// the bias with a one-hot compare per slot: O(Nq * Nk * K) work that suits
// the TPU's matrix unit and wastes a GPU. Because build_neighbor_lists
// keeps each (row, col) pair at most once (no duplicate slots in a row —
// the invariant this kernel relies on; the TPU kernel's scatter-add relies
// on the same one), the same function is a softmax over each row's <= K
// listed slots: O(Nq * K * h * d) work.
//
// What bounds it on this card: bytes — the work is ~4 flops per byte
// read. Each input is needed once (q, k, v, nbr, val, out: ~31 MB at
// config #3); k and v rows are re-read once per listed neighbor, but the
// two 5 MB tables stay resident in the 50 MB L2. A warp that spends one
// lane per head element and five shuffles per (slot, head) is bound by
// instruction issue instead, so the design keeps the instruction count per
// slot low. One warp per query row, all heads at once: the row's
// heads * d = 32 * E elements are split so lane j holds E consecutive ones
// (one 2- to 32-byte vector load per k or v row; 256 coalesced bytes for a
// bf16 config #3 row), and the G = d / E lanes of one head reduce their
// partial dot with log2(G) xor shuffles (3 at config #3) — every head's
// reduction runs in the same shuffles. The warp first compacts the row's
// valid slots (ids and biases) into shared memory with a ballot, so the
// slot loop carries no masks; then it walks them kUnroll at a time,
// issuing all the chunk's k and v loads before using any, and folds each
// chunk into an online softmax (one rescale per chunk) with f32 m, l, acc
// per lane. No block-wide synchronisation is needed.

#include <cuda_bf16.h>
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;       // query rows per block
constexpr int kMaxSlots = 256;  // neighbor-list width K (wrapper checks)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like astype
}

// E consecutive elements of a row, moved as one aligned vector.
template <typename T, int E>
struct alignas(sizeof(T) * E) Vec {
  T x[E];
};

template <typename T, int E>
__global__ void __launch_bounds__(kWarps * 32)
graph_flash_kernel(const Vec<T, E>* __restrict__ q,
                   const Vec<T, E>* __restrict__ k,
                   const Vec<T, E>* __restrict__ v,
                   const int32_t* __restrict__ nbr,
                   const float* __restrict__ val, Vec<T, E>* __restrict__ out,
                   int nq, int nk, int group, int kw, float scale) {
  constexpr int kUnroll = E <= 4 ? 8 : 4;  // slots in flight per warp
  __shared__ int32_t col[kWarps][kMaxSlots];
  __shared__ float bias[kWarps][kMaxSlots];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= nq) return;

  float qv[E];
  {
    const Vec<T, E> t = q[row * 32 + lane];
#pragma unroll
    for (int i = 0; i < E; ++i) qv[i] = to_f(t.x[i]);
  }

  // Compact the valid slots to the front, in slot order.
  int nv = 0;
  for (int base = 0; base < kw; base += 32) {
    const int s = base + lane;
    const int c = s < kw ? nbr[row * kw + s] : -1;
    const bool ok = c >= 0 && c < nk;
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (ok) {
      const int pos = nv + __popc(ballot & ((1u << lane) - 1u));
      col[warp][pos] = c;
      bias[warp][pos] = val[row * kw + s];
    }
    nv += __popc(ballot);
  }
  __syncwarp();

  float m = -CUDART_INF_F;
  float l = 0.f;
  float acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;
  for (int s0 = 0; s0 < nv; s0 += kUnroll) {
    // Slots past nv re-read the chunk's first row (valid and L2-hot) and
    // are dropped below, so the loads need no branch.
    Vec<T, E> kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long c = col[warp][s0 + u < nv ? s0 + u : s0];
      kr[u] = k[c * 32 + lane];
      vr[u] = v[c * 32 + lane];
    }
    float sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      sc[u] = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) sc[u] += qv[i] * to_f(kr[u].x[i]);
    }
    for (int off = group >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);
      }
    }
    float cmax = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      const float b = bias[warp][s < nv ? s : s0];
      sc[u] = s < nv ? sc[u] * scale + b : -CUDART_INF_F;
      cmax = fmaxf(cmax, sc[u]);
    }
    // The chunk's first slot is valid, so cmax is finite; the first fold
    // is exp(-inf) = 0 against the zero-initialised l and acc.
    const float fold = expf(m - cmax);
    l *= fold;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] *= fold;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = expf(sc[u] - cmax);  // dropped slots: exp(-inf) = 0
      l += p;
      const float pr = to_f(from_f<T>(p));
#pragma unroll
      for (int i = 0; i < E; ++i) acc[i] += pr * to_f(vr[u].x[i]);
    }
    m = cmax;
  }
  const float denom = fmaxf(l, 1e-20f);
  Vec<T, E> o;
#pragma unroll
  for (int i = 0; i < E; ++i) o.x[i] = from_f<T>(acc[i] / denom);
  out[row * 32 + lane] = o;
}

template <typename T, int E>
void launch(const void* q, const void* k, const void* v, const void* nbr,
            const void* val, void* out, int nq, int nk, int group, int kw,
            float scale, cudaStream_t stream) {
  using V = Vec<T, E>;
  const long long blocks = (static_cast<long long>(nq) + kWarps - 1) / kWarps;
  graph_flash_kernel<T, E>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
          static_cast<const V*>(q), static_cast<const V*>(k),
          static_cast<const V*>(v), static_cast<const int32_t*>(nbr),
          static_cast<const float*>(val), static_cast<V*>(out), nq, nk, group,
          kw, scale);
}

template <typename T>
bool launch_for_width(const void* q, const void* k, const void* v,
                      const void* nbr, const void* val, void* out, int nq,
                      int nk, int group, int kw, int elems, float scale,
                      cudaStream_t s) {
  switch (elems) {
    case 1:
      launch<T, 1>(q, k, v, nbr, val, out, nq, nk, group, kw, scale, s);
      return true;
    case 2:
      launch<T, 2>(q, k, v, nbr, val, out, nq, nk, group, kw, scale, s);
      return true;
    case 4:
      launch<T, 4>(q, k, v, nbr, val, out, nq, nk, group, kw, scale, s);
      return true;
    case 8:
      launch<T, 8>(q, k, v, nbr, val, out, nq, nk, group, kw, scale, s);
      return true;
    default:
      return false;
  }
}

}  // namespace

// q: [nq, heads, d], k/v: [nk, heads, d] (all of one type: bf16 when
// is_bf16, else f32), each row aligned to its per-lane vector; nbr:
// [nq, kw] int32; val: [nq, kw] f32; out like q. Takes heads dividing 32,
// heads * d in {32, 64, 128, 256} and kw <= 256; anything else returns
// cudaErrorInvalidValue without launching.
extern "C" int df2_graph_flash_attention(int is_bf16, const void* q,
                                         const void* k, const void* v,
                                         const void* nbr, const void* val,
                                         void* out, int nq, int nk, int heads,
                                         int d, int kw, float scale,
                                         void* stream) {
  if (heads <= 0 || 32 % heads != 0 || (heads * d) % 32 != 0 || kw < 0 ||
      kw > kMaxSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq > 0) {
    const int elems = heads * d / 32;  // per lane
    const int group = 32 / heads;      // lanes per head
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool ok =
        is_bf16 ? launch_for_width<__nv_bfloat16>(q, k, v, nbr, val, out, nq,
                                                  nk, group, kw, elems, scale,
                                                  s)
                : launch_for_width<float>(q, k, v, nbr, val, out, nq, nk,
                                          group, kw, elems, scale, s);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
