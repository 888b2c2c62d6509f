// Softmax attention over [T, heads, head_dim] and its gradient, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `_pallas_forward` /
// `flash_attention` (dragonfly2_tpu/ops/flash_attention.py) and the
// gradient the JAX package takes through `chunked_attention` under
// `jax.checkpoint`. Same function: s = (q . k) accumulated in f32, times
// 1/sqrt(d); a key at or past t_len is masked and, under causal, so is a
// key after the query; masked scores are NEG_INF = -1e9 (finite); online
// softmax with f32 running max, sum and accumulator; p rounded to the
// input type before P.V (accumulated in f32); out = acc / max(l, 1e-20)
// in the input type. The forward also stores lse = m + log(l) per
// (head, row) in f32 for the backward.
//
// Layout: the kernels index the public [T, heads, d] layout directly
// (row t of head h at (t * heads + h) * d), so the wrapper transposes and
// pads nothing; the ragged edge (rows at or past t_len) is masked here.
//
// What bounds it on this card: operations. At the long-context shape
// ([32768, 8, 8] causal) the products are 4.3e9 (q, k) pairs x 4d flops,
// ~0.14 ms at the bf16 tensor-core rate, but every pair also needs one
// exp, 4.3e9 of them, ~1 ms at the SFU's 16 a clock an SM, and a few
// issue slots of FP32 work: at head_dim 8 the per-pair work sets the
// bound. At [32768, 4, 128] the products do (~1.1e12 flops, ~1.1 ms).
// Bytes are small (17 MB and 134 MB in bf16).
//
// This source takes f32 at every head_dim and bf16 below 64;
// flash_attention_sm90.cu takes bf16 at 64 and 128 (TMA and wgmma). bf16
// inputs take the tensor cores through mma.sync m16n8k16 in
// FlashAttention-2's warp layout, each warp owning 16 rows whose scores
// stay in its registers: the forward is a producer warp feeding a
// cp.async ring of 128-key tiles to 8 consumer warps (128 query rows),
// with the exponentials split between the SFU and a polynomial on the
// FP32 pipes (see fwd_ring_kernel); the backward stages the other side's
// tiles of 64 rows in shared memory (see the bf16 section below). f32
// inputs take f32 FMAs out of shared memory: a block of 256 threads per
// (query tile, head), each thread owning one tile row and every fourth
// column, so a warp reads one tile row's values as broadcasts and the
// row-per-lane operand at an odd stride, free of bank conflicts. Under causal the key loop stops at the
// diagonal tile (K3's block skip as a loop bound), the blocks with the
// most key tiles are scheduled first; the bf16 kernels test positions
// only on tiles that hold a masked pair.
//
// The f32 backward is FlashAttention-2's recompute, three kernels and no
// atomics: delta = rowsum(dO * O); dK/dV with one block per (key tile,
// head) walking the query tiles, recomputing p = exp(s - lse) and
// ds = p * (dO . v - delta); dQ with one block per (query tile, head)
// walking the key tiles. The bf16 backward here is bound by the per-pair
// exponential and FP32 work, so it computes p once: delta, then one block
// per (key tile, head) that gives dK, dV and, in a fixed order, dQ (see
// bwd_fused_kernel). Every output is summed in a fixed order, so results
// are bit-identical across launches.

#include <cuda_bf16.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 64;      // query and key rows of a tile
constexpr int kThreads = 256;  // four threads a tile row
constexpr int kGroups = kThreads / kTile;
constexpr float kNegInf = -1e9f;  // NEG_INF of the TPU kernel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int t_len,
                                        bool causal) {
  return k_pos < t_len && (!causal || q_pos >= k_pos);
}

// ---------------------------------------------------------------------------
// f32: the products as FMAs out of shared memory (256 threads a block,
// four a tile row; see the note at the top).

// Shared-memory row stride of a [kTile, D] f32 tile: odd, so 32 lanes on
// 32 consecutive rows hit 32 banks.
template <int D>
constexpr int kStride = D + 1;
constexpr int kScoreStride = kTile + 1;

// Rows [row0, row0 + kTile) of one head of a [T, heads, D] tensor into a
// shared f32 tile; rows at or past t_len read as 0.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int t_len,
                                          long long row_stride) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int t = row0 + r;
    dst[r * kStride<D> + c] =
        t < t_len ? src[static_cast<long long>(t) * row_stride + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out,
           float* __restrict__ lse, int t_len, int heads, bool causal,
           float scale) {
  constexpr int S = kStride<D>;
  constexpr int kCols = D / kGroups;  // output columns a thread owns
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * S;
  float* vs = ks + kTile * S;
  float* ps = vs + kTile * S;              // [kTile][kScoreStride]
  float* row_fold = ps + kTile * kScoreStride;
  float* row_l = row_fold + kTile;

  const int head = blockIdx.y;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int q0 = q_tile * kTile;
  const long long row_stride = static_cast<long long>(heads) * D;
  const int tid = threadIdx.x;
  // Products: row r of the tile, columns g, g + 4, g + 8, ...
  const int r = tid % kTile, g = tid / kTile;
  // Softmax: row sr, columns sp, sp + 4, ... (four lanes of one warp).
  const int sr = tid / kGroups, sp = tid % kGroups;

  load_tile<D>(qs, q + head * D, q0, t_len, row_stride);
  float m = kNegInf, l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  const int n_k = (t_len + kTile - 1) / kTile;
  const int last = causal ? min(n_k - 1, q_tile) : n_k - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(ks, k + head * D, k0, t_len, row_stride);
    load_tile<D>(vs, v + head * D, k0, t_len, row_stride);
    __syncthreads();

    float s[kTile / kGroups];
#pragma unroll
    for (int j = 0; j < kTile / kGroups; ++j) s[j] = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float qv = qs[r * S + c];
#pragma unroll
      for (int j = 0; j < kTile / kGroups; ++j) {
        s[j] += qv * ks[(g + kGroups * j) * S + c];
      }
    }
#pragma unroll
    for (int j = 0; j < kTile / kGroups; ++j) {
      const int col = g + kGroups * j;
      ps[r * kScoreStride + col] =
          visible(q0 + r, k0 + col, t_len, causal) ? s[j] * scale : kNegInf;
    }
    __syncthreads();

    // Online softmax over the tile, one row per four lanes.
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile / kGroups; ++j) {
      tmax = fmaxf(tmax, ps[sr * kScoreStride + sp + kGroups * j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile / kGroups; ++j) {
      const int col = sp + kGroups * j;
      float* slot = &ps[sr * kScoreStride + col];
      const float p = visible(q0 + sr, k0 + col, t_len, causal)
                          ? expf(*slot - m_new)
                          : 0.f;
      psum += p;
      *slot = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float fold = expf(m - m_new);
    l = l * fold + psum;
    m = m_new;
    if (sp == 0) row_fold[sr] = fold;
    __syncthreads();

    const float f = row_fold[r];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] *= f;
    for (int kk = 0; kk < kTile; ++kk) {
      const float p = ps[r * kScoreStride + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        acc[j] += p * vs[kk * S + g + kGroups * j];
      }
    }
  }

  if (sp == 0) {
    row_l[sr] = l;
    if (q0 + sr < t_len) {
      lse[static_cast<long long>(head) * t_len + q0 + sr] = m + logf(l);
    }
  }
  __syncthreads();
  if (q0 + r < t_len) {
    const float denom = fmaxf(row_l[r], 1e-20f);
    float* o = out + (static_cast<long long>(q0 + r) * heads + head) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[g + kGroups * j] = acc[j] / denom;
  }
}

// p and ds for rows r of the query tile against columns g + 4j of the key
// tile, written to ps / dss ([kTile][kScoreStride], row = query).
template <int D>
__device__ __forceinline__ void recompute(const float* qs, const float* dos,
                                          const float* ks, const float* vs,
                                          const float* lse_s,
                                          const float* delta_s, float* ps,
                                          float* dss, int q0, int k0, int t_len,
                                          bool causal, float scale) {
  constexpr int S = kStride<D>;
  constexpr int kN = kTile / kGroups;
  const int r = threadIdx.x % kTile, g = threadIdx.x / kTile;
  float s[kN], dp[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) s[j] = dp[j] = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const float qv = qs[r * S + c], dov = dos[r * S + c];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int row = (g + kGroups * j) * S + c;
      s[j] += qv * ks[row];
      dp[j] += dov * vs[row];
    }
  }
  const bool q_ok = q0 + r < t_len;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int col = g + kGroups * j;
    const float p = q_ok && visible(q0 + r, k0 + col, t_len, causal)
                        ? expf(s[j] * scale - lse_s[r])
                        : 0.f;
    ps[r * kScoreStride + col] = p;
    dss[r * kScoreStride + col] = p * (dp[j] - delta_s[r]);
  }
}

__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse, const float* delta,
                                          int head, int q0, int t_len) {
  if (threadIdx.x < kTile) {
    const int t = q0 + threadIdx.x;
    const long long i = static_cast<long long>(head) * t_len + t;
    lse_s[threadIdx.x] = t < t_len ? lse[i] : 0.f;
    delta_s[threadIdx.x] = t < t_len ? delta[i] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int t_len,
            int heads, bool causal, float scale) {
  constexpr int S = kStride<D>;
  constexpr int kCols = D / kGroups;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * S;
  float* ks = dos + kTile * S;
  float* vs = ks + kTile * S;
  float* ps = vs + kTile * S;
  float* dss = ps + kTile * kScoreStride;
  float* lse_s = dss + kTile * kScoreStride;
  float* delta_s = lse_s + kTile;

  const int head = blockIdx.y;
  const int n_t = (t_len + kTile - 1) / kTile;
  const int k_tile = blockIdx.x;  // causal: key tile 0, the heaviest, first
  const int k0 = k_tile * kTile;
  const long long row_stride = static_cast<long long>(heads) * D;
  const int r = threadIdx.x % kTile, g = threadIdx.x / kTile;

  load_tile<D>(ks, k + head * D, k0, t_len, row_stride);
  load_tile<D>(vs, v + head * D, k0, t_len, row_stride);
  float dk_acc[kCols], dv_acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int qt = causal ? k_tile : 0; qt < n_t; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<D>(qs, q + head * D, q0, t_len, row_stride);
    load_tile<D>(dos, dout + head * D, q0, t_len, row_stride);
    load_rows(lse_s, delta_s, lse, delta, head, q0, t_len);
    __syncthreads();
    recompute<D>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0, t_len,
                 causal, scale);
    __syncthreads();
    // Key row r: dV += p^T . dO, dK += ds^T . q over the tile's queries.
    for (int qq = 0; qq < kTile; ++qq) {
      const float p = ps[qq * kScoreStride + r];
      const float ds = dss[qq * kScoreStride + r];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = qq * S + g + kGroups * j;
        dv_acc[j] += p * dos[c];
        dk_acc[j] += ds * qs[c];
      }
    }
  }
  if (k0 + r < t_len) {
    const long long o = (static_cast<long long>(k0 + r) * heads + head) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dk[o + g + kGroups * j] = dk_acc[j] * scale;
      dv[o + g + kGroups * j] = dv_acc[j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int t_len, int heads, bool causal,
          float scale) {
  constexpr int S = kStride<D>;
  constexpr int kCols = D / kGroups;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * S;
  float* ks = dos + kTile * S;
  float* vs = ks + kTile * S;
  float* ps = vs + kTile * S;
  float* dss = ps + kTile * kScoreStride;
  float* lse_s = dss + kTile * kScoreStride;
  float* delta_s = lse_s + kTile;

  const int head = blockIdx.y;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int q0 = q_tile * kTile;
  const long long row_stride = static_cast<long long>(heads) * D;
  const int r = threadIdx.x % kTile, g = threadIdx.x / kTile;

  load_tile<D>(qs, q + head * D, q0, t_len, row_stride);
  load_tile<D>(dos, dout + head * D, q0, t_len, row_stride);
  load_rows(lse_s, delta_s, lse, delta, head, q0, t_len);
  float dq_acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) dq_acc[j] = 0.f;

  const int n_k = (t_len + kTile - 1) / kTile;
  const int last = causal ? min(n_k - 1, q_tile) : n_k - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<D>(ks, k + head * D, k0, t_len, row_stride);
    load_tile<D>(vs, v + head * D, k0, t_len, row_stride);
    __syncthreads();
    recompute<D>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0, t_len,
                 causal, scale);
    __syncthreads();
    // Query row r: dQ += ds . k over the tile's keys.
    for (int kk = 0; kk < kTile; ++kk) {
      const float ds = dss[r * kScoreStride + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        dq_acc[j] += ds * ks[kk * S + g + kGroups * j];
      }
    }
  }
  if (q0 + r < t_len) {
    const long long o = (static_cast<long long>(q0 + r) * heads + head) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dq[o + g + kGroups * j] = dq_acc[j] * scale;
    }
  }
}

// delta[head, t] = sum_c dO[t, head, c] * O[t, head, c], in f32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, int t_len, int heads) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(t_len) * heads) return;
  const T* o = out + i * D;
  const T* d = dout + i * D;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) sum += to_f(o[c]) * to_f(d[c]);
  const long long t = i / heads, head = i % heads;
  delta[head * t_len + t] = sum;
}

// ---------------------------------------------------------------------------
// bf16: the products on the tensor cores with mma.sync m16n8k16 (bf16 in,
// f32 accumulate), FlashAttention-2's warp layout. A backward block of 4
// warps owns 64 rows (a forward block 8 warps and 128, see
// fwd_ring_kernel), each warp 16 of them; a warp's scores sit in its
// registers as mma accumulators, and the accumulator of P (or dS) is
// repacked in registers as the A operand of the next product, so no score
// leaves the warp. Tiles are staged row-major as they lie in memory, 16
// bytes a load, and every operand comes out of shared memory with
// ldmatrix (transposed where the product wants the other orientation), so
// nothing is staged twice. Rows are padded by 16 bytes, so the 8 rows an
// ldmatrix reads fall on distinct banks; head_dim below 16 is padded with
// zeros to the mma's depth (k 16) and width (n 8).

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps x 16 rows = kTile

template <int D>
constexpr int kDepth = D < 16 ? 16 : D;  // head_dim as an mma k extent
template <int D>
constexpr int kWidth = D < 8 ? 8 : D;    // head_dim as an mma n extent
template <int D>
constexpr int kRowPitch = kDepth<D> + 8;  // bf16 elements a staged row

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 (a shared-space address, or a pointer). With
// trans each matrix arrives transposed.
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4_at(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (kTrans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  }
}
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  ldsm_x4_at<kTrans>(r, smem_u32(p));
}

// The A operand: rows row0 .. row0 + 15, columns col .. col + 15 of a
// row-major tile.
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* tile,
                                     int pitch, int row0, int col, int lane) {
  ldsm_x4<false>(a,
                 tile + (row0 + (lane & 15)) * pitch + col + 8 * (lane >> 4));
}

// B operands of two n blocks (n0 .. n0 + 15) at depth k0 .. k0 + 15, for
// b[2 j], b[2 j + 1] of block n0 + 8 j. Without trans the tile holds the
// product's n along rows (K for Q K^T); with trans it holds k along rows
// (V for P V).
template <bool kTrans>
__device__ __forceinline__ void ld_b(uint32_t (&b)[4], const bf16* tile,
                                     int pitch, int n0, int k0, int lane) {
  if constexpr (kTrans) {
    ldsm_x4<true>(b, tile + (k0 + (lane & 15)) * pitch + n0 + 8 * (lane >> 4));
  } else {
    ldsm_x4<false>(b, tile + (n0 + (lane & 7) + 8 * (lane >> 4)) * pitch + k0 +
                          8 * ((lane >> 3) & 1));
  }
}

// mma.sync m16n8k8: A 16 x 8 (a0 rows g, a1 rows g + 8), B 8 x 8.
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (denormal results flush to 0). The
// kernels fold 1/sqrt(d) and log2(e) into one factor, so a score's
// exponential is one FMA and one ex2.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 2^x on the FP32 pipes, FlashAttention-4's way: 2^x = 2^j * 2^f with j =
// floor(x) and f = x - j in [0, 1); 2^f is a cubic (the minimax fit of
// relative error with p(0) = 1, at most 8.6e-5: ops/flash_attention.py's
// EXP2_POLY), which stays in [1, 2), so j is added to its exponent bits
// exactly. Adding 1.5 * 2^23 rounding down leaves j in the low mantissa
// bits of t, so t's bits shifted by 23 are j << 23 (mod 2^32). Like
// ex2.approx.ftz, below -126 (a masked -inf too) it gives exactly 0.
// Three FADDs, three FFMAs, a shift and an add, a compare and a select:
// no SFU.
constexpr float kPoly1 = 0.6951168f, kPoly2 = 0.22764485f,
                kPoly3 = 0.077067174f;
__device__ __forceinline__ float exp2_poly(float x) {
  constexpr float kMagic = 12582912.f;  // 1.5 * 2^23
  const float t = __fadd_rd(x, kMagic);
  const float f = x - (t - kMagic);
  const float p = fmaf(fmaf(fmaf(kPoly3, f, kPoly2), f, kPoly1), f, 1.f);
  const float r =
      __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
  return x < -126.f ? 0.f : r;
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
}

// Two bf16, the lower column in the low half (round to nearest even).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand of P (or dS) over 16 columns from two 16 x 8 accumulators.
__device__ __forceinline__ void repack_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Zeroes columns D .. kDepth - 1 of N staged rows: the depth padding,
// written once, since staging writes only the first D columns.
template <int D, int N, int kN = kMmaThreads>
__device__ __forceinline__ void zero_pad(bf16* dst) {
  constexpr int W = kDepth<D> - D;
  if constexpr (W > 0) {
    for (int i = threadIdx.x; i < N * W; i += kN) {
      dst[(i / W) * kRowPitch<D> + D + i % W] = __float2bfloat16(0.f);
    }
  }
}

// Rows [row0, row0 + N) of one head of a [T, heads, D] bf16 tensor into
// dst[N][kRowPitch], 16 bytes a load (8 at head_dim 4); rows at or past
// t_len are 0. kN threads share the work.
template <int D, int N, int kN = kMmaThreads>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int row0, int t_len,
                                           long long row_stride) {
  constexpr int V = D < 8 ? D : 8;  // bf16 a vector
  constexpr int kPerRow = D / V;
  using Vec = std::conditional_t<V == 8, uint4, uint2>;
  for (int i = threadIdx.x; i < N * kPerRow; i += kN) {
    const int r = i / kPerRow, c = (i % kPerRow) * V;
    const int t = row0 + r;
    Vec val{};
    if (t < t_len) {
      val = *reinterpret_cast<const Vec*>(
          src + static_cast<long long>(t) * row_stride + c);
    }
    *reinterpret_cast<Vec*>(dst + r * kRowPitch<D> + c) = val;
  }
}

// Stores a 16 x kWidth accumulator (rows row0 and row0 + 8 of lane (g, t))
// times mul0 / mul1 into [T, heads, D] at (row, head).
template <int D>
__device__ __forceinline__ void store_rows(
    bf16* dst, const float (&acc)[kWidth<D> / 8][4], int row0, int head,
    int heads, int t_len, float mul0, float mul1, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= t_len) continue;
    const float mul = half ? mul1 : mul0;
    bf16* o = dst + (static_cast<long long>(row) * heads + head) * D;
#pragma unroll
    for (int nb = 0; nb < kWidth<D> / 8; ++nb) {
      const int col = nb * 8 + 2 * t;
      if (col < D) {
        *reinterpret_cast<uint32_t*>(o + col) = pack_bf16(
            acc[nb][2 * half] * mul, acc[nb][2 * half + 1] * mul);
      }
    }
  }
}

// acc[nb] += A . B over kWidth / 8 output blocks, B from a tile that holds
// k along rows (k0 .. k0 + 15) and the output columns along columns.
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[kWidth<D> / 8][4],
                                         const uint32_t (&a)[4],
                                         const bf16* tile, int pitch, int k0,
                                         int lane) {
#pragma unroll
  for (int nb = 0; nb < kWidth<D> / 8; nb += 2) {
    uint32_t b[4];  // at head_dim <= 8 the second block reads zero padding
    ld_b<true>(b, tile, pitch, nb * 8, k0, lane);
    mma_bf16(acc[nb], a, b[0], b[1]);
    if (nb + 1 < kWidth<D> / 8) mma_bf16(acc[nb + 1], a, b[2], b[3]);
  }
}

// ---------------------------------------------------------------------------
// bf16 backward below head_dim 64: one block per (key tile, head) computes
// P and dS once per visible pair and gives all three gradients. dK and dV
// sum in registers over the query tiles; each step's dQ terms (dS K over
// the tile's 64 keys) are added to an f32 dQ in device memory in
// descending key-tile order, through a per-(head, query tile) turn
// counter that the block waits on before adding (the semaphore of
// FlashAttention-3's deterministic mode): bit-identical across launches,
// no atomics on the sums. Descending, because a block walks its query
// tiles upward from the first it sees (under causal, its own diagonal),
// so the block of the key tile above reaches every query tile a step
// earlier and, in steady state, no block waits. Blocks launch highest key
// tile first, so the block waited on has the lower index and was
// scheduled first. A block adds a query tile's terms a step late, so the
// loads of the sums overlap the next tile's products. Key tile 0, the
// last to add, writes dq in bf16 and resets the counter to 0. Query tiles
// (q, dO, lse, delta) are double-buffered with cp.async.

// 8 or 16 bytes (or 4) from global to shared memory without the
// registers; a source that is not valid fills zeros and is not read.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(valid ? kBytes : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// stage_rows through cp.async: rows at or past t_len fill with zeros.
// kN threads share the work, `first` this thread's place among them (the
// block's threads, or one warp's lanes).
template <int D, int N, int kN = kMmaThreads>
__device__ __forceinline__ void stage_rows_async(bf16* dst, const bf16* src,
                                                 int row0, int t_len,
                                                 long long row_stride,
                                                 int first) {
  constexpr int V = D < 8 ? D : 8;  // bf16 a copy
  constexpr int kPerRow = D / V;
  for (int i = first; i < N * kPerRow; i += kN) {
    const int r = i / kPerRow, c = (i % kPerRow) * V;
    const int t = row0 + r;
    const bool ok = t < t_len;
    cp_async<V * 2>(dst + r * kRowPitch<D> + c,
                    src + static_cast<long long>(ok ? t : 0) * row_stride + c,
                    ok);
  }
}

// src[row0 .. row0 + kTile) into dst; rows at or past t_len read 0.
__device__ __forceinline__ void stage_floats_async(float* dst,
                                                   const float* src, int row0,
                                                   int t_len) {
  if (threadIdx.x < kTile) {
    const int t = row0 + threadIdx.x;
    cp_async<4>(dst + threadIdx.x, src + (t < t_len ? t : 0), t < t_len);
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

constexpr int kDsPitch = kTile + 8;  // bf16 a row of the dS^T tile

template <int D>
constexpr size_t fused_smem() {
  return sizeof(bf16) * (6 * kTile * kRowPitch<D> + kTile * kDsPitch) +
         sizeof(float) * 4 * kTile;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
bwd_fused_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq_acc,
                 int* __restrict__ dq_turn, bf16* __restrict__ dq,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len,
                 int heads, bool causal, float scale) {
  constexpr int KP = kRowPitch<D>;
  constexpr int NO = kWidth<D> / 8;
  constexpr int kElems = kTile * KP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kElems;
  bf16* qs = vs + kElems;        // [2][kTile][KP]
  bf16* dos = qs + 2 * kElems;   // [2][kTile][KP]
  bf16* dss = dos + 2 * kElems;  // [kTile keys][kDsPitch]: dS^T
  float* lse_s = reinterpret_cast<float*>(dss + kTile * kDsPitch);  // [2][kTile]
  float* delta_s = lse_s + 2 * kTile;                               // [2][kTile]

  // Heads along x and key tiles from the top along y: blocks launch in
  // linear order, so every head's tiles run together, and the block a
  // block waits on (same head, key tile + 1) has the lower index.
  const int head = blockIdx.x;
  const int k_tile = gridDim.y - 1 - blockIdx.y;
  const int k0 = k_tile * kTile;
  const int n_t = (t_len + kTile - 1) / kTile;
  const int first = causal ? k_tile : 0;
  const long long rs = static_cast<long long>(heads) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // and key0 + 8
  const float scale2 = scale * kLog2e;

  auto stage_query_tile = [&](int qi, int buf) {
    const int q0 = qi * kTile;
    stage_rows_async<D, kTile>(qs + buf * kElems, q + head * D, q0, t_len, rs,
                               threadIdx.x);
    stage_rows_async<D, kTile>(dos + buf * kElems, dout + head * D, q0, t_len,
                               rs, threadIdx.x);
    const long long row = static_cast<long long>(head) * t_len;
    stage_floats_async(lse_s + buf * kTile, lse + row, q0, t_len);
    stage_floats_async(delta_s + buf * kTile, delta + row, q0, t_len);
    cp_async_commit();
  };

  // dQ's ordered add (see the note above), in pieces so that the loads of
  // the higher key tiles' sums fly during a step's products: wait for
  // query tile qi's turn, load, then add dq_part (this key tile's terms of
  // qi) and store, and, after a barrier, pass the turn on.
  float dq_part[NO][4], dq_before[NO][4];
  auto turn = [&](int qi) {
    return dq_turn + static_cast<long long>(head) * n_t + qi;
  };
  // The first key tile to add to query tile qi; this one's place after it.
  auto top_of = [&](int qi) { return causal ? qi : n_t - 1; };
  auto wait_turn = [&](int qi) {
    if (threadIdx.x == 0) {
      while (ld_acquire(turn(qi)) != top_of(qi) - k_tile) {
      }
    }
  };
  auto dq_offset = [&](int qi, int h, int nb) -> long long {
    const int row = qi * kTile + warp * 16 + g + 8 * h;
    const int col = nb * 8 + 2 * t;
    if (row >= t_len || col >= D) return -1;
    return (static_cast<long long>(row) * heads + head) * D + col;
  };
  auto load_before = [&](int qi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int nb = 0; nb < NO; ++nb) {
        const long long i = dq_offset(qi, h, nb);
        float2 b = make_float2(0.f, 0.f);
        if (i >= 0 && k_tile < top_of(qi)) {  // the first to add stores
          b = __ldcg(reinterpret_cast<const float2*>(dq_acc + i));
        }
        dq_before[nb][2 * h] = b.x;
        dq_before[nb][2 * h + 1] = b.y;
      }
    }
  };
  auto store_sum = [&](int qi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int nb = 0; nb < NO; ++nb) {
        const long long i = dq_offset(qi, h, nb);
        if (i < 0) continue;
        const float2 sum =
            make_float2(dq_part[nb][2 * h] + dq_before[nb][2 * h],
                        dq_part[nb][2 * h + 1] + dq_before[nb][2 * h + 1]);
        if (k_tile == 0) {
          *reinterpret_cast<uint32_t*>(dq + i) =
              pack_bf16(sum.x * scale, sum.y * scale);
        } else {
          __stcg(reinterpret_cast<float2*>(dq_acc + i), sum);
        }
      }
    }
  };
  // After a barrier behind store_sum: the release store publishes every
  // thread's adds (the barrier orders them before it).
  auto pass_turn = [&](int qi) {
    if (threadIdx.x == 0) {
      st_release(turn(qi), k_tile == 0 ? 0 : top_of(qi) - k_tile + 1);
    }
  };

  zero_pad<D, 6 * kTile>(ks);  // the six tiles lie back to back
  stage_rows<D, kTile>(ks, k + head * D, k0, t_len, rs);
  stage_rows<D, kTile>(vs, v + head * D, k0, t_len, rs);
  stage_query_tile(first, 0);
  float dk_acc[NO][4], dv_acc[NO][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);

  for (int qi = first; qi < n_t; ++qi) {
    const int buf = (qi - first) & 1, q0 = qi * kTile;
    cp_async_wait_all();
    if (qi > first) wait_turn(qi - 1);
    __syncthreads();  // tile qi is in; the other buffer and dss are free
    if (qi + 1 < n_t) stage_query_tile(qi + 1, buf ^ 1);
    if (qi > first) load_before(qi - 1);
    const bf16* qt = qs + buf * kElems;
    const bf16* dt = dos + buf * kElems;
    const float* ls = lse_s + buf * kTile;
    const float* dl = delta_s + buf * kTile;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys by 64 queries.
    float s[kTile / 8][4], dp[kTile / 8][4];
    zero_acc(s);
    zero_acc(dp);
#pragma unroll
    for (int kd = 0; kd < kDepth<D> / 16; ++kd) {
      uint32_t ka[4], va[4];
      ld_a(ka, ks, KP, warp * 16, kd * 16, lane);
      ld_a(va, vs, KP, warp * 16, kd * 16, lane);
#pragma unroll
      for (int nb = 0; nb < kTile / 8; nb += 2) {
        uint32_t bq[4], bd[4];
        ld_b<false>(bq, qt, KP, nb * 8, kd * 16, lane);
        ld_b<false>(bd, dt, KP, nb * 8, kd * 16, lane);
        mma_bf16(s[nb], ka, bq[0], bq[1]);
        mma_bf16(s[nb + 1], ka, bq[2], bq[3]);
        mma_bf16(dp[nb], va, bd[0], bd[1]);
        mma_bf16(dp[nb + 1], va, bd[2], bd[3]);
      }
    }
    // P once a pair, and dS = P (dP - delta).
    const bool edge = (causal && q0 < k0 + kTile - 1) || q0 + kTile > t_len ||
                      k0 + kTile > t_len;
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ql = nb * 8 + 2 * t + j;
        const float neg_lse = -ls[ql] * kLog2e, row_delta = dl[ql];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + j;
          const int qpos = q0 + ql, kpos = key0 + 8 * h;
          const bool hide =
              edge && !(qpos < t_len && visible(qpos, kpos, t_len, causal));
          const float p =
              hide ? 0.f : exp2_approx(fmaf(s[nb][e], scale2, neg_lse));
          s[nb][e] = p;
          dp[nb][e] = p * (dp[nb][e] - row_delta);  // ds
        }
      }
    }
    // dV += P^T dO and dK += dS^T Q over the 64 queries; dS^T, rounded to
    // bf16 as the dK product takes it, to shared memory for dQ.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4], da[4];
      repack_a(pa, s[2 * kk], s[2 * kk + 1]);
      repack_a(da, dp[2 * kk], dp[2 * kk + 1]);
      mma_rows<D>(dv_acc, pa, dt, KP, kk * 16, lane);
      mma_rows<D>(dk_acc, da, qt, KP, kk * 16, lane);
      bf16* row = dss + (warp * 16 + g) * kDsPitch + kk * 16 + 2 * t;
      *reinterpret_cast<uint32_t*>(row) = da[0];
      *reinterpret_cast<uint32_t*>(row + 8 * kDsPitch) = da[1];
      *reinterpret_cast<uint32_t*>(row + 8) = da[2];
      *reinterpret_cast<uint32_t*>(row + 8 * kDsPitch + 8) = da[3];
    }
    // The previous query tile's dQ terms are added a step late, so the
    // wait for the key tile above and the loads overlap this step.
    if (qi > first) store_sum(qi - 1);
    __syncthreads();  // dS^T is in shared memory; the adds are done
    if (qi > first) pass_turn(qi - 1);

    // dQ terms of queries q0 + 16 warp .. + 15: dS K over the 64 keys, dS
    // read back transposed (row = query) by ldmatrix.trans.
    zero_acc(dq_part);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4<true>(a, dss + (kk * 16 + (lane & 7) + 8 * (lane >> 4)) *
                                 kDsPitch +
                           warp * 16 + 8 * ((lane >> 3) & 1));
      mma_rows<D>(dq_part, a, ks, KP, kk * 16, lane);
    }
  }
  wait_turn(n_t - 1);
  __syncthreads();
  load_before(n_t - 1);
  store_sum(n_t - 1);
  __syncthreads();
  pass_turn(n_t - 1);
  store_rows<D>(dk, dk_acc, key0, head, heads, t_len, scale, scale, t);
  store_rows<D>(dv, dv_acc, key0, head, heads, t_len, 1.f, 1.f, t);
}

// ---------------------------------------------------------------------------
// bf16 forward below head_dim 64, the Ulysses path's forward. It replaces
// `_kernel` / `_pallas_forward` (dragonfly2_tpu/ops/flash_attention.py:113)
// at these widths.
//
// What bounds it: the work of each (query, key) pair, not bytes and not
// the products. At [32768, 8, 8] causal each of the 4.3e9 visible pairs
// needs one exponential (the SFU does 16 a clock an SM: 1.03 ms for all
// of them) and about 4.5 issue slots beside it (the score's FMA, the max,
// the row sum's add, half a bf16 pack) against 4 warp instructions a
// clock an SM: ~0.6 ms, or ~0.9 ms with the per-tile work. The products
// run beside both on mma.sync: 0.14 ms at the tensor cores' peak, so
// mma.sync is enough; wgmma would pad head_dim 4 and 8 the same way and
// add descriptors and fences to a pipe that is not the limit.
//
// The design:
// - Loads off the critical path. A producer warp keeps kFwdStages tiles
//   of K and V in flight in a ring in shared memory with cp.async (16-byte
//   copies, 8 at head_dim 4: TMA cannot take those, a box's inner extent
//   must be 16 bytes, nor the 24-byte rows of [T, 3, 4]). Each producer
//   lane's copies arrive on the stage's full mbarrier as they land
//   (cp.async.mbarrier.arrive.noinc); each consumer warp arrives on the
//   stage's empty mbarrier when it has read the stage. No block-wide
//   barrier after the start. Producer and consumers walk the same key
//   tiles, 0 .. last, so nobody waits on a stage nobody fills. Keys at or
//   past T land as zeros; the depth padding at head_dim 4 and 8 is zeroed
//   in every stage before the ring starts and never written.
// - Fewer instructions a pair. 128 query rows a block (8 consumer warps
//   of 16 rows) against 128-key tiles (64 at head_dim 32), so a warp pays
//   the max's shuffles, a row's fold exponential and the rescale of o
//   once in 2048 pairs; the row sum stays a per-lane part until the end
//   (the fold is common to a row's four lanes); the position test runs
//   in a branch of its own, only on a tile that holds a masked pair
//   (under causal the diagonal ones, and the tile that holds T); S = Q K^T
//   takes mma m16n8k8 at head_dim <= 8 (half the products and operand
//   loads of a depth padded to 16); ldmatrix addresses are computed once.
// - Latency hidden inside a warp: the exponentials of 16 keys at a time
//   are followed by their P . V products, so the SFU and the tensor cores
//   overlap; the max and the sum run as independent chains.
// - Exponentials split between the SFU and the FP32 pipes: the last
//   kPolyBlocks of a tile's blocks of 8 keys take exp2_poly, the rest
//   ex2.approx, so 1/16 of the pairs (1/8 at head_dim 32) skip the SFU.
//   Fixed by position, so results are bit-identical across launches;
//   both forms give exactly 0 below -126 and for a masked score. On the
//   H100 the split does not pay: a polynomial exp2 costs about 9 issue
//   slots where ex2.approx costs one, and issue slots are as scarce as
//   the SFU here, so a share of 0 measured fastest (PERF.md,
//   tests/k3_forward_timing.py --poly-blocks); one block a tile, the
//   smallest share, keeps the split in use.
// Heads lie along the grid's fast axis and query tiles run from the last,
// so blocks launch heaviest first.

// The tiling per head_dim, picked on the card (PERF.md): 128-key tiles
// and two blocks an SM below head_dim 32; at 32, where the products and
// the wider rows take more registers, 64-key tiles and three blocks an SM.
template <int D>
constexpr int kKeyTile = D < 32 ? 128 : 64;  // keys of a ring stage
template <int D>
constexpr int kFwdMinBlocks = D < 32 ? 2 : 3;  // blocks an SM holds at once
// How many of a key tile's blocks of 8 keys (the last ones) take exp2_poly.
constexpr int kPolyBlocks = 1;
constexpr int kFwdWarps = 8;                       // consumer warps
constexpr int kFwdRows = 16 * kFwdWarps;           // query rows a block
constexpr int kFwdThreads = 32 * (kFwdWarps + 1);  // and the producer warp
constexpr int kFwdStages = 3;
constexpr int kBarBytes = 64;  // the ring's mbarriers, ahead of the tiles

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// One arrival on bar once this thread's earlier cp.async copies have
// landed; the arrival counts against bar's initial count.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

template <int D>
constexpr size_t ring_fwd_smem() {
  return kBarBytes + sizeof(bf16) *
                         (kFwdRows + 2 * kFwdStages * kKeyTile<D>) *
                         kRowPitch<D>;
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks<D>)
fwd_ring_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out,
                float* __restrict__ lse, int t_len, int heads, bool causal,
                float scale) {
  constexpr int KT = kKeyTile<D>;
  constexpr int KP = kRowPitch<D>;
  constexpr int NO = kWidth<D> / 8;  // output accumulators, 8 columns each
  constexpr int NB = KT / 8;         // score accumulators, 8 keys each
  constexpr int kStage = KT * KP;    // bf16 of one operand's stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kFwdStages;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + kBarBytes);
  bf16* ks = qs + kFwdRows * KP;        // [kFwdStages][KT][KP]
  bf16* vs = ks + kFwdStages * kStage;  // [kFwdStages][KT][KP]

  const int head = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // heaviest first
  const int q0 = q_tile * kFwdRows;
  const long long rs = static_cast<long long>(heads) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_k = (t_len + KT - 1) / KT;
  const int last = causal ? min(n_k - 1, (q0 + kFwdRows - 1) / KT) : n_k - 1;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kFwdStages; ++st) {
      bar_init(&full[st], 32);          // each producer lane once
      bar_init(&empty[st], kFwdWarps);  // each consumer warp once
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q and every stage lie back to back: one pass zeroes all the padding.
  zero_pad<D, kFwdRows + 2 * kFwdStages * KT, kFwdThreads>(qs);
  stage_rows<D, kFwdRows, kFwdThreads>(qs, q + head * D, q0, t_len, rs);
  __syncthreads();

  if (warp == kFwdWarps) {  // the producer
    for (int kt = 0; kt <= last; ++kt) {
      const int st = kt % kFwdStages, k0 = kt * KT;
      if (kt >= kFwdStages) {
        bar_wait(&empty[st], ((kt / kFwdStages) & 1) ^ 1);
      }
      stage_rows_async<D, KT, 32>(ks + st * kStage, k + head * D, k0, t_len,
                                  rs, lane);
      stage_rows_async<D, KT, 32>(vs + st * kStage, v + head * D, k0, t_len,
                                  rs, lane);
      cp_async_arrive(&full[st]);
    }
    cp_async_wait_all();
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // and row0 + 8
  const float scale2 = scale * kLog2e;
  // This lane's ldmatrix addresses in a stage, in bytes from its start:
  // K as the B of S = Q K^T, over 16 keys x 16 of depth (k_lane) or, at
  // head_dim <= 8, 32 keys x 8 (k8_lane); V, transposed, as the B of
  // O += P V over 16 keys x 16 columns (v_lane).
  constexpr bool kDepth8 = D <= 8;  // S = Q K^T with mma m16n8k8
  const uint32_t k_lane =
      (kDepth8 ? (lane & 7) + 8 * (lane >> 3)
               : (lane & 7) + 8 * (lane >> 4)) * KP * 2 +
      (kDepth8 ? 0 : 16 * ((lane >> 3) & 1));
  const uint32_t v_lane = (lane & 15) * KP * 2 + 16 * (lane >> 4);
  const uint32_t ks_u32 = smem_u32(ks), vs_u32 = smem_u32(vs);
  uint32_t qa[kDepth<D> / 16][4];
#pragma unroll
  for (int kd = 0; kd < kDepth<D> / 16; ++kd) {
    ld_a(qa[kd], qs, KP, warp * 16, kd * 16, lane);
  }
  // l is this lane's part of the row sums until the end.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NO][4];
  zero_acc(o);
  // The warp has read stage st: its lanes' reads come before lane 0's
  // arrival (which releases them).
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);
  };

  for (int kt = 0; kt <= last; ++kt) {
    const int st = kt % kFwdStages, k0 = kt * KT;
    bar_wait(&full[st], (kt / kFwdStages) & 1);
    const uint32_t kst = ks_u32 + st * kStage * 2 + k_lane;
    const uint32_t vst = vs_u32 + st * kStage * 2 + v_lane;

    float s[NB][4];
    zero_acc(s);
    if constexpr (kDepth8) {
#pragma unroll
      for (int nb = 0; nb < NB; nb += 4) {
        uint32_t b[4];
        ldsm_x4_at<false>(b, kst + nb * 8 * KP * 2);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16_k8(s[nb + j], qa[0][0], qa[0][1], b[j]);
        }
      }
    } else {
#pragma unroll
      for (int kd = 0; kd < kDepth<D> / 16; ++kd) {
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
          uint32_t b[4];
          ldsm_x4_at<false>(b, kst + nb * 8 * KP * 2 + kd * 32);
          mma_bf16(s[nb], qa[kd], b[0], b[1]);
          mma_bf16(s[nb + 1], qa[kd], b[2], b[3]);
        }
      }
    }
    // Positions only on a tile that holds a masked pair, in a branch of
    // its own, so the other tiles run none of it.
    if ((causal && q0 < k0 + KT - 1) || k0 + KT > t_len) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!visible(row0 + 8 * (e >> 1), k0 + nb * 8 + 2 * t + (e & 1),
                       t_len, causal)) {
            s[nb][e] = -CUDART_INF_F;  // either exp2 of it is 0: masked
          }
        }
      }
    }
    // The running max m is kept in unscaled score units (scale > 0, so the
    // max commutes with it); a masked score counts as NEG_INF there. Four
    // chains a row: column parity, block parity.
    float mx4[2][4], shift[2], fold[2];
#pragma unroll
    for (int i = 0; i < 8; ++i) mx4[i >> 2][i & 3] = kNegInf;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& c = mx4[e >> 1][(e & 1) + 2 * (nb & 1)];
        c = fmaxf(c, s[nb][e]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx =
          fmaxf(fmaxf(mx4[h][0], mx4[h][1]), fmaxf(mx4[h][2], mx4[h][3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(m[h], mx);  // the new running max
      shift[h] = -mx * scale2;
      fold[h] = exp2_approx((m[h] - mx) * scale2);
      m[h] = mx;
    }
#pragma unroll
    for (int nb = 0; nb < NO; ++nb) {
      o[nb][0] *= fold[0];
      o[nb][1] *= fold[0];
      o[nb][2] *= fold[1];
      o[nb][3] *= fold[1];
    }
    // p for 16 keys at a time, then O += P . V over them, so the
    // exponentials overlap the products; p rounded to bf16 in the repack
    // (K3's rule).
    float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
#pragma unroll
      for (int nb = 2 * kk; nb < 2 * kk + 2; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = fmaf(s[nb][e], scale2, shift[e >> 1]);
          const float p =
              nb >= NB - kPolyBlocks ? exp2_poly(x) : exp2_approx(x);
          s[nb][e] = p;
          sum[e >> 1][nb & 1] += p;
        }
      }
      uint32_t pa[4];
      repack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nb = 0; nb < NO; nb += 2) {
        uint32_t b[4];  // at head_dim <= 8 the second block is padding
        ldsm_x4_at<true>(b, vst + kk * 16 * KP * 2 + nb * 16);
        mma_bf16(o[nb], pa, b[0], b[1]);
        if (nb + 1 < NO) mma_bf16(o[nb + 1], pa, b[2], b[3]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * fold[h] + (sum[h][0] + sum[h][1]);
    }
    release(st);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  store_rows<D>(out, o, row0, head, heads, t_len, 1.f / fmaxf(l[0], 1e-20f),
                1.f / fmaxf(l[1], 1e-20f), t);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row0 + 8 * h < t_len) {
        lse[static_cast<long long>(head) * t_len + row0 + 8 * h] =
            m[h] * scale + logf(l[h]);
      }
    }
  }
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) *
         (3 * kTile * kStride<D> + kTile * kScoreStride + 2 * kTile);
}
template <int D>
constexpr size_t bwd_smem() {
  return sizeof(float) *
         (4 * kTile * kStride<D> + 2 * kTile * kScoreStride + 2 * kTile);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// bf16 at head_dim 64 and 128 is flash_attention_sm90.cu's: no instance
// of the mma.sync kernels exists at those widths.
template <typename T, int D>
constexpr bool kSm90Route = std::is_same_v<T, bf16> && D >= 64;

template <typename T, int D>
cudaError_t forward(const void* q, const void* k, const void* v, void* out,
                    float* lse, int t_len, int heads, bool causal, float scale,
                    cudaStream_t stream) {
  const dim3 grid((t_len + kTile - 1) / kTile, heads);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if constexpr (kSm90Route<T, D>) {
    return cudaErrorInvalidValue;
  } else if constexpr (std::is_same_v<T, bf16>) {
    cudaError_t err = allow_smem(fwd_ring_kernel<D>, ring_fwd_smem<D>());
    if (err != cudaSuccess) return err;
    const dim3 by_head(heads, (t_len + kFwdRows - 1) / kFwdRows);
    fwd_ring_kernel<D><<<by_head, kFwdThreads, ring_fwd_smem<D>(), stream>>>(
        qt, kt, vt, static_cast<T*>(out), lse, t_len, heads, causal, scale);
  } else {
    cudaError_t err = allow_smem(fwd_kernel<D>, fwd_smem<D>());
    if (err != cudaSuccess) return err;
    fwd_kernel<D><<<grid, kThreads, fwd_smem<D>(), stream>>>(
        qt, kt, vt, static_cast<T*>(out), lse, t_len, heads, causal, scale);
  }
  return cudaGetLastError();
}

// parts: 1 delta, 2 dK/dV (bf16: the fused dK/dV/dQ block), 4 dQ (f32
// only); the later ones read delta.
template <typename T, int D>
cudaError_t backward(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const float* lse,
                     float* delta, float* dq_acc, int* dq_turn, void* dq,
                     void* dk, void* dv, int t_len, int heads, bool causal,
                     float scale, int parts, cudaStream_t stream) {
  if constexpr (kSm90Route<T, D>) {
    return cudaErrorInvalidValue;
  } else {
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const T* dot = static_cast<const T*>(dout);
    const long long rows = static_cast<long long>(t_len) * heads;
    cudaError_t err;
    if (parts & 1) {
      delta_kernel<T, D>
          <<<static_cast<unsigned>((rows + kThreads - 1) / kThreads), kThreads,
             0, stream>>>(static_cast<const T*>(out), dot, delta, t_len,
                          heads);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    const dim3 grid((t_len + kTile - 1) / kTile, heads);
    if constexpr (std::is_same_v<T, bf16>) {
      if (parts & 2) {
        err = allow_smem(bwd_fused_kernel<D>, fused_smem<D>());
        if (err != cudaSuccess) return err;
        const dim3 by_head(heads, (t_len + kTile - 1) / kTile);
        bwd_fused_kernel<D><<<by_head, kMmaThreads, fused_smem<D>(), stream>>>(
            qt, kt, vt, dot, lse, delta, dq_acc, dq_turn,
            static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
            t_len, heads, causal, scale);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
      }
    } else {
      if (parts & 2) {
        err = allow_smem(dkdv_kernel<D>, bwd_smem<D>());
        if (err != cudaSuccess) return err;
        dkdv_kernel<D><<<grid, kThreads, bwd_smem<D>(), stream>>>(
            qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
            static_cast<T*>(dv), t_len, heads, causal, scale);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
      }
      if (parts & 4) {
        err = allow_smem(dq_kernel<D>, bwd_smem<D>());
        if (err != cudaSuccess) return err;
        dq_kernel<D><<<grid, kThreads, bwd_smem<D>(), stream>>>(
            qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), t_len, heads,
            causal, scale);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
      }
    }
    return cudaSuccess;
  }
}

// Calls F<T, D>::run(args...) for the runtime (is_bf16, d), or returns
// cudaErrorInvalidValue for a head_dim the kernels do not take.
#define DF2_DISPATCH(fn, is_bf16, d, ...)                                  \
  [&]() -> cudaError_t {                                                   \
    switch (d) {                                                           \
      case 4:                                                              \
        return is_bf16 ? fn<__nv_bfloat16, 4>(__VA_ARGS__)                 \
                       : fn<float, 4>(__VA_ARGS__);                        \
      case 8:                                                              \
        return is_bf16 ? fn<__nv_bfloat16, 8>(__VA_ARGS__)                 \
                       : fn<float, 8>(__VA_ARGS__);                        \
      case 16:                                                             \
        return is_bf16 ? fn<__nv_bfloat16, 16>(__VA_ARGS__)                \
                       : fn<float, 16>(__VA_ARGS__);                       \
      case 32:                                                             \
        return is_bf16 ? fn<__nv_bfloat16, 32>(__VA_ARGS__)                \
                       : fn<float, 32>(__VA_ARGS__);                       \
      case 64:                                                             \
        return is_bf16 ? fn<__nv_bfloat16, 64>(__VA_ARGS__)                \
                       : fn<float, 64>(__VA_ARGS__);                       \
      case 128:                                                            \
        return is_bf16 ? fn<__nv_bfloat16, 128>(__VA_ARGS__)               \
                       : fn<float, 128>(__VA_ARGS__);                      \
      default:                                                             \
        return cudaErrorInvalidValue;                                      \
    }                                                                      \
  }()

}  // namespace

// q, k, v, out: [t_len, heads, d] contiguous, all bf16 (is_bf16) or all
// f32; lse: [heads, t_len] f32. d in {4, 8, 16, 32, 64, 128} for f32 and
// {4, 8, 16, 32} for bf16 (flash_attention_sm90.cu takes bf16 at 64 and
// 128), else cudaErrorInvalidValue without launching.
extern "C" int df2_flash_attention_fwd(int is_bf16, const void* q,
                                       const void* k, const void* v, void* out,
                                       float* lse, int t_len, int heads, int d,
                                       int causal, float scale, void* stream) {
  if (t_len <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(DF2_DISPATCH(
      forward, is_bf16, d, q, k, v, out, lse, t_len, heads, causal != 0, scale,
      static_cast<cudaStream_t>(stream)));
}

// The bf16 forward's tiling at head_dim d: keys a tile, and how many of
// its blocks of 8 keys (the last ones) take the FP32 polynomial exp2;
// cudaErrorInvalidValue for a head_dim the forward does not take.
template <int D>
int exp_split(int* key_tile, int* poly_blocks) {
  *key_tile = kKeyTile<D>;
  *poly_blocks = kPolyBlocks;
  return 0;
}

extern "C" int df2_flash_attention_exp_split(int d, int* key_tile,
                                             int* poly_blocks) {
  switch (d) {
    case 4:
      return exp_split<4>(key_tile, poly_blocks);
    case 8:
      return exp_split<8>(key_tile, poly_blocks);
    case 16:
      return exp_split<16>(key_tile, poly_blocks);
    case 32:
      return exp_split<32>(key_tile, poly_blocks);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The gradient of df2_flash_attention_fwd: out and lse as it wrote them,
// dout like out; delta: [heads, t_len] f32 scratch; dq, dk, dv like q.
// bf16 also takes dq_acc, [t_len, heads, d] f32 scratch, and dq_turn,
// [heads, ceil(t_len / 64)] int32 zeros (left zero on return). `parts`
// picks the launches: 1 delta, 2 dK/dV (bf16: the fused block that also
// gives dQ), 4 dQ (f32); 7 for all. Returns the first error.
extern "C" int df2_flash_attention_bwd(
    int is_bf16, const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, float* dq_acc,
    int* dq_turn, void* dq, void* dk, void* dv, int t_len, int heads, int d,
    int causal, float scale, int parts, void* stream) {
  if (t_len <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(DF2_DISPATCH(
      backward, is_bf16, d, q, k, v, out, dout, lse, delta, dq_acc, dq_turn,
      dq, dk, dv, t_len, heads, causal != 0, scale, parts,
      static_cast<cudaStream_t>(stream)));
}
