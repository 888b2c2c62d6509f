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
// Two passes, each one warp per row in the forward's lane layout:
// - dQ pass, one warp per query row: each exponential is computed once,
//   p and dp - r go to f32 scratch at the flat position i * K + s (zeros at
//   masked and PAD slots), and once delta is known the warp's lanes walk
//   the row's slots again, turn dp into ds in place and sum dval over
//   the heads.
// - dK/dV pass, one warp per key row c, walking inv[c] (the inverse index
//   of build_inverse_index: ascending flat positions, -1 padding): for
//   each position it reads q_i, dO_i and the position's p and ds, and adds
//   in f32 registers, in position order.
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
// col/bias (and slot, their index in the row, when given), in slot order;
// returns how many there are. Calls `masked(s)` on one lane for each other
// slot s < kw.
template <typename Masked>
__device__ __forceinline__ int compact_slots(const int32_t* __restrict__ nbr,
                                             const float* __restrict__ val,
                                             long long row, int nk, int kw,
                                             int lane, int32_t* col,
                                             float* bias, int32_t* slot,
                                             Masked masked) {
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
      if (slot != nullptr) slot[pos] = s;
    } else if (s < kw) {
      masked(s);
    }
    nv += __popc(ballot);
  }
  __syncwarp();
  return nv;
}

// Dynamic shared memory: per warp, kw ids, kw biases and (backward) kw
// slot numbers, 4 bytes each.
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
  const int nv = compact_slots(nbr, val, row, nk, kw, lane, col, bias,
                               nullptr, [](int) {});

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

// dQ pass: one warp per query row. Writes dq, dval[row, :] and the
// row's p and ds scratch ([nq * kw, heads] f32) at every slot.
template <typename T, int E>
__global__ void __launch_bounds__(kWarps * 32)
graph_flash_dq_kernel(const Vec<T, E>* __restrict__ q,
                      const Vec<T, E>* __restrict__ k,
                      const Vec<T, E>* __restrict__ v,
                      const Vec<T, E>* __restrict__ dout,
                      const float* __restrict__ lse,
                      const int32_t* __restrict__ nbr,
                      const float* __restrict__ val,
                      Vec<T, E>* __restrict__ dq, float* __restrict__ dval,
                      float* __restrict__ p_scr, float* __restrict__ ds_scr,
                      int nq, int nk, int heads, int group, int kw,
                      float scale) {
  constexpr int kUnroll = unroll<T, E>();
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int32_t* col = smem + warp * kw;
  float* bias = reinterpret_cast<float*>(smem + kWarps * kw) + warp * kw;
  int32_t* slot = smem + 2 * kWarps * kw + warp * kw;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= nq) return;
  const int head = lane / group;

  float qv[E], dov[E];
  load_row<T, E>(qv, q[row * 32 + lane]);
  load_row<T, E>(dov, dout[row * 32 + lane]);
  const float row_lse = lse[row * heads + head];
  const int nv = compact_slots(
      nbr, val, row, nk, kw, lane, col, bias, slot, [&](int s) {
        const long long pos = row * kw + s;
        dval[pos] = 0.f;
        for (int h = 0; h < heads; ++h) {
          p_scr[pos * heads + h] = 0.f;
          ds_scr[pos * heads + h] = 0.f;
        }
      });

  // Relative to r, the first slot's dp: delta = sum p (dp - r) / sum p,
  // a = sum p (dp - r) k, b = sum p k, dq = a - delta * b, and
  // ds = p ((dp - r) - delta).
  float r = 0.f, delta = 0.f, psum = 0.f, a[E], b[E];
#pragma unroll
  for (int i = 0; i < E; ++i) a[i] = b[i] = 0.f;
  for (int s0 = 0; s0 < nv; s0 += kUnroll) {
    Vec<T, E> kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long c = col[s0 + u < nv ? s0 + u : s0];
      kr[u] = k[c * 32 + lane];
      vr[u] = v[c * 32 + lane];
    }
    float sc[kUnroll], dp[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      sc[u] = 0.f;
      dp[u] = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        sc[u] += qv[i] * to_f(kr[u].x[i]);
        dp[u] += dov[i] * to_f(vr[u].x[i]);
      }
    }
    for (int off = group >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        sc[u] += __shfl_xor_sync(kFull, sc[u], off);
        dp[u] += __shfl_xor_sync(kFull, dp[u], off);
      }
    }
    if (s0 == 0) r = dp[0];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      if (s >= nv) break;  // the same on every lane
      const float p = expf(sc[u] * scale + bias[s] - row_lse);
      const float dpr = dp[u] - r;
      const float pd = p * dpr;
      delta += pd;
      psum += p;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float kf = to_f(kr[u].x[i]);
        a[i] += pd * kf;
        b[i] += p * kf;
      }
      if (lane % group == 0) {
        const long long pos = (row * kw + slot[s]) * heads + head;
        p_scr[pos] = p;
        ds_scr[pos] = dpr;
      }
    }
  }
  if (nv > 0) delta /= psum;
#pragma unroll
  for (int i = 0; i < E; ++i) a[i] -= delta * b[i];
  store_row<T, E>(&dq[row * 32 + lane], a, scale);

  // ds = p ((dp - r) - delta) in place and dval = its sum over the heads,
  // one slot a lane; the warp's own scratch writes are visible after the
  // sync.
  __syncwarp();
  for (int base = 0; base < nv; base += 32) {
    const int s = base + lane;
    const long long pos = row * kw + slot[s < nv ? s : base];
    float dsum = 0.f;
    for (int h = 0; h < heads; ++h) {
      const float dh = __shfl_sync(kFull, delta, h * group);
      if (s < nv) {
        const long long at = pos * heads + h;
        const float ds = p_scr[at] * (ds_scr[at] - dh);
        ds_scr[at] = ds;
        dsum += ds;
      }
    }
    if (s < nv) dval[pos] = dsum;
  }
}

// dK/dV pass: one warp per key row c, over inv[c] in position order.
template <typename T, int E>
__global__ void __launch_bounds__(kWarps * 32)
graph_flash_dkdv_kernel(const Vec<T, E>* __restrict__ q,
                        const Vec<T, E>* __restrict__ dout,
                        const float* __restrict__ p_scr,
                        const float* __restrict__ ds_scr,
                        const int64_t* __restrict__ inv,
                        Vec<T, E>* __restrict__ dk, Vec<T, E>* __restrict__ dv,
                        int nq, int nk, int heads, int group, int kw,
                        int dmax, float scale) {
  constexpr int kUnroll = unroll<T, E>();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (c >= nk) return;
  const int head = lane / group;
  const long long n_pos = static_cast<long long>(nq) * kw;

  float dka[E], dva[E];
#pragma unroll
  for (int i = 0; i < E; ++i) dka[i] = dva[i] = 0.f;
  for (int base = 0; base < dmax; base += 32) {
    const long long mine = base + lane < dmax ? inv[c * dmax + base + lane]
                                              : -1;
    // Lanes holding a position, taken in lane (= position) order.
    unsigned todo = __ballot_sync(kFull, mine >= 0 && mine < n_pos);
    while (todo != 0u) {
      int src[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        src[u] = todo != 0u ? __ffs(todo) - 1 : -1;
        todo &= todo - 1u;
      }
      Vec<T, E> qr[kUnroll], dr[kUnroll];
      float pp[kUnroll], dd[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // Past the last position: re-read the first (dropped below).
        const long long pos =
            __shfl_sync(kFull, mine, src[u] >= 0 ? src[u] : src[0]);
        const long long i = pos / kw;
        qr[u] = q[i * 32 + lane];
        dr[u] = dout[i * 32 + lane];
        pp[u] = p_scr[pos * heads + head];
        dd[u] = ds_scr[pos * heads + head];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (src[u] < 0) break;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          dva[i] += pp[u] * to_f(dr[u].x[i]);
          dka[i] += dd[u] * to_f(qr[u].x[i]);
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
  void *dq, *dk, *dv, *dval, *p_scr, *ds_scr;
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

template <typename T, int E>
void launch_bwd(const Bwd& a, const Dims& d, int parts, cudaStream_t s) {
  using V = Vec<T, E>;
  if (parts & kDq) {
    const size_t smem = 3 * sizeof(int32_t) * kWarps * d.kw;  // <= 48 KB
    graph_flash_dq_kernel<T, E><<<blocks_for(d.nq), kWarps * 32, smem, s>>>(
        static_cast<const V*>(a.q), static_cast<const V*>(a.k),
        static_cast<const V*>(a.v), static_cast<const V*>(a.dout),
        static_cast<const float*>(a.lse),
        static_cast<const int32_t*>(a.nbr), static_cast<const float*>(a.val),
        static_cast<V*>(a.dq), static_cast<float*>(a.dval),
        static_cast<float*>(a.p_scr), static_cast<float*>(a.ds_scr), d.nq,
        d.nk, d.heads, d.group, d.kw, d.scale);
  }
  if ((parts & kDkDv) && d.nk > 0) {
    graph_flash_dkdv_kernel<T, E><<<blocks_for(d.nk), kWarps * 32, 0, s>>>(
        static_cast<const V*>(a.q), static_cast<const V*>(a.dout),
        static_cast<const float*>(a.p_scr),
        static_cast<const float*>(a.ds_scr),
        static_cast<const int64_t*>(a.inv), static_cast<V*>(a.dk),
        static_cast<V*>(a.dv), d.nq, d.nk, d.heads, d.group, d.kw, d.dmax,
        d.scale);
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
  template <typename T, int E>
  void run() const { launch_bwd<T, E>(a, d, parts, s); }
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
// f32, and uses p_scr and ds_scr ([nq * kw, heads] f32 each) as scratch.
// parts: 1 = the dQ pass (dq, dval, scratch), 2 = the dK/dV pass (reads
// the scratch), 3 = both. Same domain as the forward.
extern "C" int df2_graph_flash_attention_bwd(
    int is_bf16, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* nbr, const void* val,
    const void* inv, void* dq, void* dk, void* dv, void* dval, void* p_scr,
    void* ds_scr, int nq, int nk, int heads, int d, int kw, int dmax,
    float scale, int parts, void* stream) {
  if (!valid_dims(heads, d, kw) || dmax < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Bwd args{q, k, v, dout, lse, nbr, val, inv,
                 dq, dk, dv, dval, p_scr, ds_scr};
  const Dims dims{nq, nk, heads, 32 / heads, kw, dmax, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int run = nq > 0 ? parts : parts & kDkDv;
  const bool ok =
      dispatch(is_bf16, heads * d / 32, BwdLaunch{args, dims, run, s});
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
