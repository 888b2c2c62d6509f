// Neighbor-masked graph attention for Hopper (sm_90a): the forward and its
// gradient.
//
// The forward replaces the Pallas TPU kernel `_graph_kernel` /
// `graph_flash_attention` (dragonfly2_tpu/ops/flash_attention.py). Same
// function: for query row i and head h, score every listed neighbor
// c = nbr[i, s] that lies in [0, Nk) as (q[i,h] . k[c,h]) * scale +
// val[i, s]; softmax over those scores with f32 max / sum / accumulator;
// p rounded to the input type before P.V, as the TPU kernel does;
// out = acc / max(l, 1e-20). Slots outside [0, Nk) (PAD_ID padding) are
// masked, and a row with no valid slot outputs 0. When asked, it also
// writes lse[i, h] = m + log(l) in f32 (-inf for a row with no valid
// slot), the natural-log row statistic its gradient recomputes p from.
//
// The TPU kernel scores every (q-block, k-block) tile densely and builds
// the bias with a one-hot compare per slot: O(Nq * Nk * K) work that suits
// the TPU's matrix unit and wastes a GPU. Because build_neighbor_lists
// keeps each (row, col) pair at most once (no duplicate slots in a row —
// the invariant this kernel relies on; the TPU kernel's scatter-add relies
// on the same one), the same function is a softmax over each row's <= K
// listed slots: O(Nq * K * h * d) work.
//
// What bounds the forward on this card: bytes — the work is ~4 flops per
// byte read. Each input is needed once (q, k, v, nbr, val, out: ~31 MB at
// config #3); k and v rows are re-read once per listed neighbor, but the
// two 5 MB tables stay resident in the 50 MB L2. A warp that spends one
// lane per head element and five shuffles per (slot, head) is bound by
// instruction issue instead, so the design keeps the instruction count per
// slot low. One warp per query row, all heads at once: the row's
// heads * d = 32 * E elements are split so lane j holds E consecutive ones
// (one 2- to 64-byte vector load per k or v row; 256 coalesced bytes for a
// bf16 config #3 row), and the G = d / E lanes of one head reduce their
// partial dot with log2(G) xor shuffles (3 at config #3) — every head's
// reduction runs in the same shuffles. The warp first compacts the row's
// valid slots (ids and biases) into shared memory with a ballot, so the
// slot loop carries no masks; then it walks them kUnroll at a time,
// issuing all the chunk's k and v loads before using any, and folds each
// chunk into an online softmax (one rescale per chunk) with f32 m, l, acc
// per lane. No block-wide synchronisation is needed.
//
// The gradient replaces `_graph_bwd` (dragonfly2_tpu/ops/flash_attention.py),
// which differentiates the XLA scan `sparse_graph_attention`; the TPU has
// no kernel for it. With p = exp(s - lse) per (row, slot, head),
// dp = dO . v_c, delta = sum_s p dp / sum_s p per (row, head) and
// ds = p * (dp - delta):
//   dq_i = scale * sum_s ds k_c,  dval[i, s] = sum_h ds,
//   dk_c = scale * sum_{(i, s): nbr[i, s] = c} ds q_i,
//   dv_c = sum_{(i, s): nbr[i, s] = c} p dO_i.
// delta is taken from p and dp, not as dO . out (FlashAttention-2's
// form): out is rounded to bf16, and where a row's softmax is peaked
// the rounding of out is as large as the terms dp - delta it must
// cancel (with dO . out the model's one-step bf16 gradients broke the
// 6e-2 limit tests/test_torch_model.py holds blocks mode to). It is
// divided by sum p, which is 1 up to the rounding of lse: without that,
// a peaked row's dp - delta for its top slot keeps (sum p - 1) dp, as
// large as the true difference (f32 row errors 2.6e-3 in
// tests/k1_planted_faults.py's check). delta needs the row's slots
// first, so dq is summed as sum p dp k - delta * sum p k in one walk,
// with dp taken relative to the row's first slot's (r): the walk sums
// p (dp - r), which leaves no rounding where the true gradient is 0 (a
// row with one slot) and keeps the large common part out of the
// difference (f32 row errors 6e-4 there without it).
// Two passes, each one warp per row in the forward's lane layout, and no
// per-slot scratch:
// - dQ pass, one warp per query row: one walk over the row's valid slots
//   computes p and dp, sums delta, a = sum p (dp - r) k and b = sum p k,
//   writes dq and zeroes dval at masked and PAD slots, and leaves
//   (lse, r, delta) of each (row, head) in a 16-byte word ([nq, heads, 4]
//   f32, 1.3 MB at config #3).
// - dK/dV pass, one warp per key row c, holding k_c and v_c in registers
//   and walking inv[c] (the inverse index of build_inverse_index:
//   ascending flat positions, -1 padding): for each position (i, s) it
//   gathers q_i, dO_i, row i's (lse, r, delta) and val[i, s], recomputes
//   s and dp through pair_terms — the same function, lane layout and
//   order of additions as the dQ pass, so the same bits: a row with one
//   valid slot gets dp - r = 0 and ds = 0 exactly — forms p and
//   ds = p ((dp - r) - delta), adds dv += p dO_i and dk += ds q_i in f32
//   registers in position order, and writes dval[i, s] = sum_h ds (each
//   valid position is listed once, so each dval entry has one writer).
// The scratch this replaces was 2 x [nq * kw, heads] f32 (42 MB at config
// #3), written by the dQ pass, rewritten in place, then read by the dK/dV
// pass at scattered positions. Recomputing costs each position two dots
// and an exponential; what keeps that cheap is the reduction of the dots
// over a head's lanes. pair_terms takes R pairs at once (R = the chunk in
// flight, at most the head's lanes) and splits them while it sums: each
// xor round halves the values a lane holds, so R sums take R - 1
// shuffles instead of R log2(group), the lane ends with one pair's s and
// dp, and computes one exponential; p and ds then go to the head's lanes
// by one shuffle each. The halves are picked with bit masks rather than
// selects, which the compiler may turn into lane branches around the
// shuffles.
// No atomics: a key row's sum is owned by one warp and taken in the same
// order on every launch, so the gradients are bit-identical from launch
// to launch (atomics over key rows would add in a different order each
// run). What bounds it: bytes counted once (q, k, v, dO, lse, nbr, val,
// inv, dq, dk, dv, dval: ~66 MB at config #3, 0.020 ms at
// 3.35 TB/s) are far from the pace; the gathers are — k and v rows once
// per valid slot in the dQ pass and q and dO rows once per position in
// the dK/dV pass (~0.5 GB each at config #3), served from L2.

#include <cuda_bf16.h>
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;       // rows per block
constexpr int kMaxSlots = 512;  // neighbor-list width K (wrapper checks)
constexpr unsigned kFull = 0xffffffffu;
enum Parts { kDq = 1, kDkDv = 2 };

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

// Rows in flight per warp: more for narrow vectors, fewer for wide ones
// (a 64-byte f32 vector is 16 registers).
template <typename T, int E>
__host__ __device__ constexpr int unroll() {
  return E <= 4 ? 8 : (E * sizeof(T) >= 64 ? 2 : 4);
}

template <typename T, int E>
__device__ __forceinline__ void load_row(float (&dst)[E], const Vec<T, E>& t) {
#pragma unroll
  for (int i = 0; i < E; ++i) dst[i] = to_f(t.x[i]);
}

template <typename T, int E>
__device__ __forceinline__ void store_row(Vec<T, E>* dst,
                                          const float (&acc)[E], float mul) {
  Vec<T, E> o;
#pragma unroll
  for (int i = 0; i < E; ++i) o.x[i] = from_f<T>(acc[i] * mul);
  *dst = o;
}

// Compacts row `row`'s slots whose id lies in [0, nk) to the front of
// col/bias, in slot order; returns how many there are. Calls `masked(s)`
// on one lane for each other slot s < kw.
template <typename Masked>
__device__ __forceinline__ int compact_slots(const int32_t* __restrict__ nbr,
                                             const float* __restrict__ val,
                                             long long row, int nk, int kw,
                                             int lane, int32_t* col,
                                             float* bias, Masked masked) {
  int nv = 0;
  for (int base = 0; base < kw; base += 32) {
    const int s = base + lane;
    const int c = s < kw ? nbr[row * kw + s] : -1;
    const bool ok = c >= 0 && c < nk;
    const unsigned ballot = __ballot_sync(kFull, ok);
    if (ok) {
      const int pos = nv + __popc(ballot & ((1u << lane) - 1u));
      col[pos] = c;
      bias[pos] = val[row * kw + s];
    } else if (s < kw) {
      masked(s);
    }
    nv += __popc(ballot);
  }
  __syncwarp();
  return nv;
}

// Dynamic shared memory (forward and dQ pass): per warp, kw ids and kw
// biases, 4 bytes each.
template <typename T, int E>
__global__ void __launch_bounds__(kWarps * 32)
graph_flash_kernel(const Vec<T, E>* __restrict__ q,
                   const Vec<T, E>* __restrict__ k,
                   const Vec<T, E>* __restrict__ v,
                   const int32_t* __restrict__ nbr,
                   const float* __restrict__ val, Vec<T, E>* __restrict__ out,
                   float* __restrict__ lse, int nq, int nk, int heads,
                   int group, int kw, float scale) {
  constexpr int kUnroll = unroll<T, E>();
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int32_t* col = smem + warp * kw;
  float* bias = reinterpret_cast<float*>(smem + kWarps * kw) + warp * kw;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= nq) return;

  float qv[E];
  load_row<T, E>(qv, q[row * 32 + lane]);
  const int nv =
      compact_slots(nbr, val, row, nk, kw, lane, col, bias, [](int) {});

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
      const long long c = col[s0 + u < nv ? s0 + u : s0];
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
        sc[u] += __shfl_xor_sync(kFull, sc[u], off);
      }
    }
    float cmax = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      const float b = bias[s < nv ? s : s0];
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
  store_row<T, E>(&out[row * 32 + lane], acc, 1.f / fmaxf(l, 1e-20f));
  if (lse != nullptr && lane % group == 0) {
    lse[row * heads + lane / group] = nv > 0 ? m + logf(l) : -CUDART_INF_F;
  }
}

// Which of R pairs a lane ends up holding after pair_terms' split sums,
// and (pair_lane) the first lane of a head's group that holds pair j. A
// sum over a head's `group` lanes takes log2(group) xor rounds at
// offsets group/2, group/4, ..., 1; the first log2(R) rounds also split
// the pairs, each lane keeping half of its partial sums and sending the
// other half, so the R sums take R - 1 shuffles, not R log2(group), and
// lane holds pair split_index. Every pair's total is the same tree of
// additions (the partners of each round) on whichever lane ends up with
// it, so the bits do not depend on the pair's place in the chunk.
template <int R>
__device__ __forceinline__ int split_index(int group, int lane) {
  int u = 0, off = group >> 1;
#pragma unroll
  for (int b = 1; b < R; b <<= 1, off >>= 1) {
    if (lane & off) u |= b;
  }
  return u;
}

template <int R>
__device__ __forceinline__ int pair_lane(int j, int group, int lane) {
  int g = 0, off = group >> 1;
#pragma unroll
  for (int b = 1; b < R; b <<= 1, off >>= 1) {
    if (j & b) g |= off;
  }
  return (lane & -group) | g;
}

// Sums each of R per-lane values over the head's group of lanes (R <=
// group) and returns, on each lane, the total of value
// split_index<R>(group, lane).
template <int R>
__device__ __forceinline__ float split_sum(float (&x)[R], int group) {
  int off = group >> 1;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = R; m > 1; m >>= 1, off >>= 1) {
    // The upper lane of each pair keeps the odd values (bit masks: see
    // the note at the top).
    const unsigned upper = 0u - static_cast<unsigned>((lane & off) != 0);
#pragma unroll
    for (int j = 0; j < m / 2; ++j) {
      const unsigned lo = __float_as_uint(x[2 * j]);
      const unsigned hi = __float_as_uint(x[2 * j + 1]);
      const float keep = __uint_as_float((hi & upper) | (lo & ~upper));
      const float give = __uint_as_float((lo & upper) | (hi & ~upper));
      x[j] = keep + __shfl_xor_sync(kFull, give, off);
    }
  }
  float sum = x[0];
  for (; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
  return sum;
}

// The score s = q . k and dp = dO . v of the R (query row, key row) pairs
// xs[b + j], ys[b + j] (j < R) for the lane's head: the lane's E-element
// partial dots as FMA chains over x and y (the rows the pass holds), then
// split sums, after which the lane holds pair split_index<R>(group,
// lane), for which it returns p = exp(s * scale + bias - lse) and dp.
// Both backward passes call it with the same lane layout and R, and
// fma(a, b, c) = fma(b, a, c), so the dK/dV pass recomputes the bits the
// dQ pass used.
template <typename T, int E, int R, int U>
__device__ __forceinline__ void pair_terms(
    const float (&x)[E], const float (&y)[E], const Vec<T, E> (&xs)[U],
    const Vec<T, E> (&ys)[U], int b, float bias, float lse, int group,
    float scale, float& p, float& dp) {
  float sc[R], dd[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    sc[j] = 0.f;
    dd[j] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      sc[j] = __fmaf_rn(x[i], to_f(xs[b + j].x[i]), sc[j]);
      dd[j] = __fmaf_rn(y[i], to_f(ys[b + j].x[i]), dd[j]);
    }
  }
  const float s = split_sum<R>(sc, group);
  dp = split_sum<R>(dd, group);
  p = expf(__fmaf_rn(s, scale, bias) - lse);
}

// dQ pass: one warp per query row. Writes dq, zeroes dval at the row's
// masked and PAD slots, and writes stats[row, h] = (lse, r, delta, 0).
template <typename T, int E, int R>
__global__ void __launch_bounds__(kWarps * 32)
graph_flash_dq_kernel(const Vec<T, E>* __restrict__ q,
                      const Vec<T, E>* __restrict__ k,
                      const Vec<T, E>* __restrict__ v,
                      const Vec<T, E>* __restrict__ dout,
                      const float* __restrict__ lse,
                      const int32_t* __restrict__ nbr,
                      const float* __restrict__ val,
                      Vec<T, E>* __restrict__ dq, float* __restrict__ dval,
                      float4* __restrict__ stats, int nq, int nk, int heads,
                      int group, int kw, float scale) {
  constexpr int kUnroll = unroll<T, E>();
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int32_t* col = smem + warp * kw;
  float* bias = reinterpret_cast<float*>(smem + kWarps * kw) + warp * kw;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= nq) return;
  const int head = lane / group;
  const int mine_pair = split_index<R>(group, lane);

  float qv[E], dov[E];
  load_row<T, E>(qv, q[row * 32 + lane]);
  load_row<T, E>(dov, dout[row * 32 + lane]);
  const float row_lse = lse[row * heads + head];
  const int nv = compact_slots(nbr, val, row, nk, kw, lane, col, bias,
                               [&](int s) { dval[row * kw + s] = 0.f; });

  // Relative to r, the first slot's dp: delta = sum p (dp - r) / sum p,
  // a = sum p (dp - r) k, b = sum p k, dq = a - delta * b; summed in slot
  // order.
  float r = 0.f, delta = 0.f, psum = 0.f, a[E], b[E];
#pragma unroll
  for (int i = 0; i < E; ++i) a[i] = b[i] = 0.f;
  for (int s0 = 0; s0 < nv; s0 += kUnroll) {
    // Slots past nv re-read the chunk's first (dropped below).
    Vec<T, E> kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long c = col[s0 + u < nv ? s0 + u : s0];
      kr[u] = k[c * 32 + lane];
      vr[u] = v[c * 32 + lane];
    }
#pragma unroll
    for (int sb = 0; sb < kUnroll; sb += R) {
      const int own = s0 + sb + mine_pair;
      float p, dp;
      pair_terms<T, E, R>(qv, dov, kr, vr, sb, bias[own < nv ? own : s0],
                          row_lse, group, scale, p, dp);
      if (s0 + sb == 0) r = __shfl_sync(kFull, dp, pair_lane<R>(0, group,
                                                                lane));
      const float pd = p * (dp - r);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int from = pair_lane<R>(j, group, lane);
        const float pj = __shfl_sync(kFull, p, from);
        const float pdj = __shfl_sync(kFull, pd, from);
        if (s0 + sb + j >= nv) break;  // the same on every lane
        delta += pdj;
        psum += pj;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const float kf = to_f(kr[sb + j].x[i]);
          a[i] += pdj * kf;
          b[i] += pj * kf;
        }
      }
    }
  }
  if (nv > 0) delta /= psum;
#pragma unroll
  for (int i = 0; i < E; ++i) a[i] -= delta * b[i];
  store_row<T, E>(&dq[row * 32 + lane], a, scale);
  if (lane % group == 0) {
    stats[row * heads + head] = make_float4(row_lse, r, delta, 0.f);
  }
}

// dK/dV pass: one warp per key row c, over inv[c] in position order.
// Writes dk, dv and dval at every valid position.
template <typename T, int E, int R>
__global__ void __launch_bounds__(kWarps * 32)
graph_flash_dkdv_kernel(const Vec<T, E>* __restrict__ q,
                        const Vec<T, E>* __restrict__ k,
                        const Vec<T, E>* __restrict__ v,
                        const Vec<T, E>* __restrict__ dout,
                        const float* __restrict__ val,
                        const float4* __restrict__ stats,
                        const int64_t* __restrict__ inv,
                        Vec<T, E>* __restrict__ dk, Vec<T, E>* __restrict__ dv,
                        float* __restrict__ dval, int nq, int nk, int heads,
                        int group, int kw, int dmax, float scale) {
  constexpr int kUnroll = unroll<T, E>();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (c >= nk) return;
  const int head = lane / group;
  const int mine_pair = split_index<R>(group, lane);
  // One lane of head 0 writes each pair's dval.
  const bool writer = lane < group && lane == pair_lane<R>(mine_pair, group,
                                                           lane);
  const long long n_pos = static_cast<long long>(nq) * kw;

  float kv[E], vv[E], dka[E], dva[E];
  load_row<T, E>(kv, k[c * 32 + lane]);
  load_row<T, E>(vv, v[c * 32 + lane]);
#pragma unroll
  for (int i = 0; i < E; ++i) dka[i] = dva[i] = 0.f;
  for (int base = 0; base < dmax; base += 32) {
    // Each lane owns one position of the 32: it splits it into its query
    // row (one division a lane for 32 positions) and reads its val.
    const long long mine = base + lane < dmax ? inv[c * dmax + base + lane]
                                              : -1;
    const bool live = mine >= 0 && mine < n_pos;
    const int my_row = live ? static_cast<int>(mine / kw) : 0;
    const float my_val = live ? val[mine] : 0.f;
    // Lanes holding a position, taken in lane (= position) order.
    unsigned todo = __ballot_sync(kFull, live);
    while (todo != 0u) {
      int src[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        src[u] = todo != 0u ? __ffs(todo) - 1 : -1;
        todo &= todo - 1u;
      }
      Vec<T, E> qr[kUnroll], dr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // Past the last position: re-read the first (dropped below).
        const long long i =
            __shfl_sync(kFull, my_row, src[u] >= 0 ? src[u] : src[0]);
        qr[u] = q[i * 32 + lane];
        dr[u] = dout[i * 32 + lane];
      }
#pragma unroll
      for (int sb = 0; sb < kUnroll; sb += R) {
        // The position this lane's split sums end on, and its row's
        // (lse, r, delta) for the lane's head.
        int from = src[0];
        bool own_live = false;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (mine_pair == j && src[sb + j] >= 0) {
            from = src[sb + j];
            own_live = true;
          }
        }
        const long long i = __shfl_sync(kFull, my_row, from);
        const long long pos = __shfl_sync(kFull, mine, from);
        const float4 st = stats[i * heads + head];
        float p, dp;
        pair_terms<T, E, R>(kv, vv, qr, dr, sb,
                            __shfl_sync(kFull, my_val, from), st.x, group,
                            scale, p, dp);
        const float ds = p * ((dp - st.y) - st.z);
        // dval = ds summed over the heads, in the same butterfly order
        // on every launch.
        float dsum = ds;
        for (int off = group; off < 32; off <<= 1) {
          dsum += __shfl_xor_sync(kFull, dsum, off);
        }
        if (writer && own_live) dval[pos] = dsum;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int at = pair_lane<R>(j, group, lane);
          const float pj = __shfl_sync(kFull, p, at);
          const float dsj = __shfl_sync(kFull, ds, at);
          if (src[sb + j] < 0) break;  // the same on every lane
#pragma unroll
          for (int e = 0; e < E; ++e) {
            dva[e] += pj * to_f(dr[sb + j].x[e]);
            dka[e] += dsj * to_f(qr[sb + j].x[e]);
          }
        }
      }
    }
  }
  store_row<T, E>(&dk[c * 32 + lane], dka, scale);
  store_row<T, E>(&dv[c * 32 + lane], dva, 1.f);
}

struct Fwd {
  const void *q, *k, *v, *nbr, *val;
  void *out, *lse;
};

struct Bwd {
  const void *q, *k, *v, *dout, *lse, *nbr, *val, *inv;
  void *dq, *dk, *dv, *dval, *stats;
};

struct Dims {
  int nq, nk, heads, group, kw, dmax;
  float scale;
};

unsigned blocks_for(int rows) {
  return static_cast<unsigned>((static_cast<long long>(rows) + kWarps - 1) /
                               kWarps);
}

template <typename T, int E>
void launch_fwd(const Fwd& a, const Dims& d, cudaStream_t s) {
  using V = Vec<T, E>;
  const size_t smem = 2 * sizeof(int32_t) * kWarps * d.kw;
  graph_flash_kernel<T, E><<<blocks_for(d.nq), kWarps * 32, smem, s>>>(
      static_cast<const V*>(a.q), static_cast<const V*>(a.k),
      static_cast<const V*>(a.v), static_cast<const int32_t*>(a.nbr),
      static_cast<const float*>(a.val), static_cast<V*>(a.out),
      static_cast<float*>(a.lse), d.nq, d.nk, d.heads, d.group, d.kw,
      d.scale);
}

template <typename T, int E, int R>
void launch_bwd(const Bwd& a, const Dims& d, int parts, cudaStream_t s) {
  using V = Vec<T, E>;
  if (parts & kDq) {
    const size_t smem = 2 * sizeof(int32_t) * kWarps * d.kw;
    graph_flash_dq_kernel<T, E, R>
        <<<blocks_for(d.nq), kWarps * 32, smem, s>>>(
        static_cast<const V*>(a.q), static_cast<const V*>(a.k),
        static_cast<const V*>(a.v), static_cast<const V*>(a.dout),
        static_cast<const float*>(a.lse),
        static_cast<const int32_t*>(a.nbr), static_cast<const float*>(a.val),
        static_cast<V*>(a.dq), static_cast<float*>(a.dval),
        static_cast<float4*>(a.stats), d.nq, d.nk, d.heads, d.group, d.kw,
        d.scale);
  }
  if ((parts & kDkDv) && d.nk > 0) {
    graph_flash_dkdv_kernel<T, E, R>
        <<<blocks_for(d.nk), kWarps * 32, 0, s>>>(
        static_cast<const V*>(a.q), static_cast<const V*>(a.k),
        static_cast<const V*>(a.v), static_cast<const V*>(a.dout),
        static_cast<const float*>(a.val),
        static_cast<const float4*>(a.stats),
        static_cast<const int64_t*>(a.inv), static_cast<V*>(a.dk),
        static_cast<V*>(a.dv), static_cast<float*>(a.dval), d.nq, d.nk,
        d.heads, d.group, d.kw, d.dmax, d.scale);
  }
}

struct FwdLaunch {
  const Fwd& a;
  const Dims& d;
  cudaStream_t s;
  template <typename T, int E>
  void run() const { launch_fwd<T, E>(a, d, s); }
};

struct BwdLaunch {
  const Bwd& a;
  const Dims& d;
  int parts;
  cudaStream_t s;
  // R, the pairs one split sum spreads over a head's lanes: the chunk's
  // positions in flight, at most the head's lanes.
  template <typename T, int E>
  void run() const {
    constexpr int kUnroll = unroll<T, E>();
    switch (d.group < kUnroll ? d.group : kUnroll) {
      case 1: launch_bwd<T, E, 1>(a, d, parts, s); break;
      case 2: launch_bwd<T, E, 2>(a, d, parts, s); break;
      case 4:
        if constexpr (kUnroll >= 4) launch_bwd<T, E, 4>(a, d, parts, s);
        break;
      default:
        if constexpr (kUnroll >= 8) launch_bwd<T, E, 8>(a, d, parts, s);
        break;
    }
  }
};

// Calls f.run<T, E>() for the element type and the elements a lane;
// false when E is not one the kernels take.
template <typename T, typename F>
bool dispatch_width(int elems, const F& f) {
  switch (elems) {
    case 1: f.template run<T, 1>(); return true;
    case 2: f.template run<T, 2>(); return true;
    case 4: f.template run<T, 4>(); return true;
    case 8: f.template run<T, 8>(); return true;
    case 16: f.template run<T, 16>(); return true;
    default: return false;
  }
}

template <typename F>
bool dispatch(int is_bf16, int elems, const F& f) {
  return is_bf16 ? dispatch_width<__nv_bfloat16>(elems, f)
                 : dispatch_width<float>(elems, f);
}

bool valid_dims(int heads, int d, int kw) {
  return heads > 0 && 32 % heads == 0 && d > 0 && (heads * d) % 32 == 0 &&
         kw >= 0 && kw <= kMaxSlots;
}

}  // namespace

// q: [nq, heads, d], k/v: [nk, heads, d] (all of one type: bf16 when
// is_bf16, else f32), each row aligned to its per-lane vector; nbr:
// [nq, kw] int32; val: [nq, kw] f32; out like q; lse: [nq, heads] f32, or
// null to skip it. Takes heads dividing 32, heads * d in {32, 64, 128,
// 256, 512} and kw <= 512; anything else returns cudaErrorInvalidValue
// without launching.
extern "C" int df2_graph_flash_attention(int is_bf16, const void* q,
                                         const void* k, const void* v,
                                         const void* nbr, const void* val,
                                         void* out, void* lse, int nq, int nk,
                                         int heads, int d, int kw, float scale,
                                         void* stream) {
  if (!valid_dims(heads, d, kw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq > 0) {
    const Fwd args{q, k, v, nbr, val, out, lse};
    const Dims dims{nq, nk, heads, 32 / heads, kw, 0, scale};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool ok =
        dispatch(is_bf16, heads * d / 32, FwdLaunch{args, dims, s});
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The gradient of df2_graph_flash_attention. lse is the forward's; dout
// like its out; inv: [nk, dmax] int64, the ascending flat
// positions i * kw + s with nbr[i, s] = row, -1 padding (entries outside
// [0, nq * kw) are skipped). Writes dq like q, dk/dv like k, dval [nq, kw]
// f32, and uses stats ([nq, heads, 4] f32, 16-byte aligned) to pass each
// (row, head)'s lse, r and delta from the first pass to the second.
// parts: 1 = the dQ pass (dq, stats, dval at masked slots), 2 = the dK/dV
// pass (dk, dv, dval at valid slots; reads stats), 3 = both. Same domain
// as the forward.
extern "C" int df2_graph_flash_attention_bwd(
    int is_bf16, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* nbr, const void* val,
    const void* inv, void* dq, void* dk, void* dv, void* dval, void* stats,
    int nq, int nk, int heads, int d, int kw, int dmax, float scale,
    int parts, void* stream) {
  if (!valid_dims(heads, d, kw) || dmax < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Bwd args{q, k, v, dout, lse, nbr, val, inv, dq, dk, dv, dval, stats};
  const Dims dims{nq, nk, heads, 32 / heads, kw, dmax, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int run = nq > 0 ? parts : parts & kDkDv;
  const bool ok =
      dispatch(is_bf16, heads * d / 32, BwdLaunch{args, dims, run, s});
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
