// Softmax attention over [T, heads, head_dim] and its gradient in bf16 at
// head_dim 64 and 128, for Hopper (sm_90a): TMA and wgmma.
//
// Replaces the Pallas TPU kernel `_kernel` / `_pallas_forward` /
// `flash_attention` (dragonfly2_tpu/ops/flash_attention.py) at these
// widths, and the gradient the JAX package takes through
// `chunked_attention`. The function is K3's, as flash_attention.cu
// computes it at the other widths: s = (q . k) accumulated in f32, times
// 1/sqrt(d); a key at or past t_len is masked and, under causal, so is a
// key after the query; a masked score counts as NEG_INF = -1e9 (finite)
// in the running max; f32 running max, sum and accumulator; p rounded to
// bf16 before P.V; out = acc / max(l, 1e-20); lse = m * scale + log(l) in
// f32; the backward takes delta = rowsum(dO * O) from the bf16 out.
//
// What bounds it on this card: the products. At [32768, 4, 128] causal
// they are 1.1e12 flops forward and 2.75e12 backward (1.1 and 2.8 ms at
// 989 TFLOP/s); the exponentials (one a visible pair, 2.15e9) take 0.5 ms
// of the special-function units beside them; bytes are small (134 MB).
//
// The design is FlashAttention-3's shape, without its ping-pong
// scheduling or intra-warpgroup overlap. A block has three warpgroups: a
// producer, whose one thread keeps TMA loads of the streamed tiles in
// flight into a ring of kStages stages (a full and an empty mbarrier
// each), and two consumer warpgroups of 64 rows each, which run every
// product as wgmma.mma_async with the scores in registers. Tiles lie in
// shared memory as the TMA's 128-byte swizzle leaves them, 64 columns (128
// bytes) a box, so a head_dim-128 tile is two boxes side by side; that is
// wgmma's canonical swizzled layout, K-major for Q.K^T-shaped products and
// MN-major (transposed) for the B operand of P.V-shaped ones, so nothing
// is staged twice. The accumulator of P (or dS) is repacked in registers
// into the A operand of the next product; p rounds to bf16 there. Rows at
// or past t_len arrive as zeros through the TMA's out-of-bounds fill;
// scores are masked in registers.
//
// Forward: a block per (128-row query tile, head), heaviest first under
// causal; K and V tiles of 128 rows stream. Backward, three launches and
// no atomics, each output owned by one block and summed in a fixed order
// (bit-identical across launches): delta = rowsum(dO * O); dK/dV with a
// block per (128-key tile, head) over query tiles of 64 rows (Q, dO, and
// lse and delta staged by a second producer warp); dQ with a block per
// (128-row query tile, head) over key tiles of 64 rows, which computes P a
// second time (FlashAttention-2's split: at these widths the products,
// not the exponentials, bound the kernel, and a separate dQ needs no
// cross-block order).
//
// Tensor maps are encoded on the host per call, through libcuda's
// cuTensorMapEncodeTiled found with cudaGetDriverEntryPoint (the library
// does not link libcuda), and passed as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e9f;  // NEG_INF of the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarpgroup = 128;
constexpr int kThreads = 3 * kWarpgroup;  // producer + two consumers
constexpr int kBlockRows = 128;           // rows a block owns
constexpr int kStreamRows = 64;           // rows of a streamed bwd tile
constexpr int kBox = 64;                  // bf16 columns of a TMA box
constexpr int kStages = 2;

// ---------------------------------------------------------------------------
// PTX wrappers: mbarriers, TMA, wgmma.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrives once and adds `bytes` to the transaction count the phase waits
// for (the TMA loads complete them).
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
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

// One TMA box of a [T, heads, d] map: columns c0 .. c0 + 63 of rows
// row0 .. row0 + box rows - 1 of `head`, into dst, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int head, int row0,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(head), "r"(row0)
      : "memory");
}

// Rows row0 .. row0 + R - 1 of one head, all D columns, as D / 64 boxes:
// box b at dst + b * R * 64.
template <int D, int R>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map,
                                          int row0, int head, uint64_t* bar) {
#pragma unroll
  for (int b = 0; b < D / kBox; ++b) {
    tma_load(dst + b * R * kBox, map, b * kBox, head, row0, bar);
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (layout type
// 1): start address, leading and stride byte offsets, all in 16 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const bf16* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// K-major operand (rows of the tile are the product's M or N, head_dim its
// depth): rows 8 apart lie 1024 bytes apart; depth kd * 16 of a
// head_dim-D tile of R rows is box kd / 4, 32 bytes into the row.
template <int R>
__device__ __forceinline__ uint64_t kmajor_desc(const bf16* tile, int kd) {
  return sw128_desc(tile + (kd / 4) * R * kBox + (kd % 4) * 16, 16, 1024);
}

// MN-major operand (rows of the tile are the product's depth, head_dim its
// N): depth kk * 16 starts 16 rows in; 8 rows of depth lie 1024 bytes
// apart, and the second 64-column box R * 128 bytes after the first.
template <int R>
__device__ __forceinline__ uint64_t mnmajor_desc(const bf16* tile, int kk) {
  return sw128_desc(tile + kk * 16 * kBox, R * kBox * 2, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

// d (+)= A . B, m64nNk16, bf16 in, f32 accumulate. _ss: A and B from
// shared memory, both K-major; scale_d 0 overwrites d. _rs: A from
// registers (the mma.sync m16n8k16 A fragment of each warp's 16 rows), B
// MN-major, accumulating.
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The dynamic shared memory rounded up to 1024 bytes, the alignment of
// the 128-byte swizzle's 8-row pattern (the launch asks 1 KB extra).
__device__ __forceinline__ bf16* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<bf16*>(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

__device__ __forceinline__ void init_ring(uint64_t* first, int n_first,
                                          uint64_t* full, int full_count,
                                          uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_first; ++i) bar_init(&first[i], 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], full_count);
      bar_init(&empty[s], 2 * kWarpgroup);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int t_len,
                                        int causal) {
  return k_pos < t_len && (!causal || q_pos >= k_pos);
}

// 2^x on the special-function unit (denormal results flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two bf16, the lower column in the low half (round to nearest even).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand over 16 columns (accumulator columns 16 kk .. 16 kk + 15,
// i.e. entries 8 kk .. 8 kk + 7) of a wgmma accumulator.
template <int N>
__device__ __forceinline__ void repack_a(uint32_t (&a)[4], const float (&d)[N],
                                         int kk) {
  a[0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Stores rows row0 and row0 + 8 of a m64nD accumulator (this thread's
// columns 8 j + 2 t, + 1) times mul into [T, heads, D] at head.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 2],
                                           int row0, int head, int heads,
                                           int t_len, float mul0, float mul1,
                                           int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= t_len) continue;
    const float mul = h ? mul1 : mul0;
    bf16* o = dst + (static_cast<long long>(row) * heads + head) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(o + 8 * j + 2 * t) =
          pack_bf16(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward.

template <int D>
constexpr size_t fwd_smem() {
  return 1024 + sizeof(bf16) * (1 + 2 * kStages) * kBlockRows * D +
         sizeof(uint64_t) * (1 + 2 * kStages);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap q_map,
           const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out,
           float* __restrict__ lse, int t_len, int heads, int causal,
           float scale) {
  constexpr int kTile = kBlockRows * D;  // elements of a 128-row tile
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = aligned_smem(smem_raw);
  bf16* ks = qs + kTile;              // [kStages][kTile]
  bf16* vs = ks + kStages * kTile;    // [kStages][kTile]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * kTile);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int head = blockIdx.y;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int q0 = q_tile * kBlockRows;
  const int n_k = (t_len + kBlockRows - 1) / kBlockRows;
  const int last = causal ? min(n_k - 1, q_tile) : n_k - 1;
  init_ring(q_full, 1, full, 1, empty);

  if (threadIdx.x < kWarpgroup) {  // producer
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      bar_expect(q_full, sizeof(bf16) * kTile);
      load_tile<D, kBlockRows>(qs, &q_map, q0, head, q_full);
      for (int kt = 0; kt <= last; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) bar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        bar_expect(&full[s], 2 * sizeof(bf16) * kTile);
        load_tile<D, kBlockRows>(ks + s * kTile, &k_map, kt * kBlockRows, head,
                                 &full[s]);
        load_tile<D, kBlockRows>(vs + s * kTile, &v_map, kt * kBlockRows, head,
                                 &full[s]);
      }
    }
    return;
  }
  reg_alloc<240>();
  const int c = threadIdx.x / kWarpgroup - 1;  // consumer 0 or 1
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * c;              // this warpgroup's 64 rows
  const int row0 = r0 + warp * 16 + g;     // this thread's rows, and + 8
  const float scale2 = scale * kLog2e;
  const bf16* qc = qs + 64 * c * kBox;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 2], sc[kBlockRows / 2];
  zero(o);
  zero(sc);
  bar_wait(q_full, 0);
  for (int kt = 0; kt <= last; ++kt) {
    const int s = kt % kStages, k0 = kt * kBlockRows;
    const bf16* kt_s = ks + s * kTile;
    const bf16* vt_s = vs + s * kTile;
    bar_wait(&full[s], (kt / kStages) & 1);

    // S = Q K^T over head_dim, 64 rows by 128 keys.
    wgmma_fence();
    fence_acc(sc);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      wgmma_ss<kBlockRows>(sc, kmajor_desc<kBlockRows>(qc, kd),
                           kmajor_desc<kBlockRows>(kt_s, kd), kd > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_acc(sc);

    // The running max m is kept in unscaled score units (scale > 0, so
    // the max commutes with it); a masked score counts as NEG_INF there.
    const bool edge = (causal && r0 < k0 + kBlockRows - 1) ||
                      k0 + kBlockRows > t_len;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < kBlockRows / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = sc[4 * nb + e];
        if (edge && !visible(row0 + 8 * (e >> 1), k0 + nb * 8 + 2 * t + (e & 1),
                             t_len, causal)) {
          x = -CUDART_INF_F;  // exp2 of it is 0: p is masked
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float fold[2], sum[2] = {0.f, 0.f}, shift[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mx[h] = fmaxf(m[h], mx[h]);  // the new running max
      shift[h] = -mx[h] * scale2;
    }
#pragma unroll
    for (int i = 0; i < kBlockRows / 2; ++i) {
      const float p = exp2_approx(fmaf(sc[i], scale2, shift[(i >> 1) & 1]));
      sc[i] = p;
      sum[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      fold[h] = exp2_approx((m[h] - mx[h]) * scale2);
      l[h] = l[h] * fold[h] + sum[h];
      m[h] = mx[h];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= fold[(i >> 1) & 1];

    // O += P V over the 128 keys, p rounded to bf16 in the repack (K3's
    // rule). The A operands are all repacked before the fence, so no
    // register an in-flight product reads is written.
    uint32_t pa[kBlockRows / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockRows / 16; ++kk) repack_a(pa[kk], sc, kk);
    wgmma_fence();
    fence_acc(o);
#pragma unroll
    for (int kk = 0; kk < kBlockRows / 16; ++kk) {
      wgmma_rs<D>(o, pa[kk], mnmajor_desc<kBlockRows>(vt_s, kk));
    }
    wgmma_commit();
    wgmma_wait();
    fence_acc(o);
    bar_arrive(&empty[s]);
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

// ---------------------------------------------------------------------------
// Backward.

// delta[head, t] = sum_c dO[t, head, c] * O[t, head, c] in f32: D / 8
// lanes a row, 16 bytes each, summed across them with shuffles.
template <int D>
__global__ void __launch_bounds__(256)
delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
             float* __restrict__ delta, int t_len, int heads) {
  constexpr int kLanes = D / 8;
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long row = i / kLanes;
  const bool ok = row < static_cast<long long>(t_len) * heads;
  float sum = 0.f;
  if (ok) {
    const uint4 a = *reinterpret_cast<const uint4*>(out + i * 8);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + i * 8);
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 u = __bfloat1622float2(x[j]), w = __bfloat1622float2(y[j]);
      sum += u.x * w.x + u.y * w.y;
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (ok && i % kLanes == 0) {
    delta[(row % heads) * t_len + row / heads] = sum;
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  return 1024 +
         sizeof(bf16) * (2 * kBlockRows + 2 * kStages * kStreamRows) * D +
         sizeof(float) * 2 * kStages * kStreamRows +
         sizeof(uint64_t) * (1 + 2 * kStages);
}

// dK and dV of one 128-key tile: consumer warpgroup c owns keys
// k0 + 64 c .. + 63 and walks the query tiles, 64 rows each; S^T = K Q^T
// and dP^T = V dO^T come out of wgmma, so P^T and dS^T are already the A
// operands of dV += P^T dO and dK += dS^T Q. Producer warp 0 loads K and V
// once and Q and dO a stage; producer warp 1 stages lse (in log2 units)
// and delta for the same rows.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap k_map,
            const __grid_constant__ CUtensorMap v_map,
            const __grid_constant__ CUtensorMap q_map,
            const __grid_constant__ CUtensorMap do_map,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len,
            int heads, int causal, float scale) {
  constexpr int kKV = kBlockRows * D, kQ = kStreamRows * D;
  extern __shared__ unsigned char smem_raw[];
  bf16* ks = aligned_smem(smem_raw);
  bf16* vs = ks + kKV;
  bf16* qs = vs + kKV;                // [kStages][kQ]
  bf16* dos = qs + kStages * kQ;      // [kStages][kQ]
  float* lse_s = reinterpret_cast<float*>(dos + kStages * kQ);
  float* delta_s = lse_s + kStages * kStreamRows;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(delta_s + kStages * kStreamRows);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int head = blockIdx.y;
  const int k0 = blockIdx.x * kBlockRows;  // causal: key tile 0, the heaviest, first
  const int n_q = (t_len + kStreamRows - 1) / kStreamRows;
  const int first = causal ? k0 / kStreamRows : 0;
  init_ring(kv_full, 1, full, 1 + 32, empty);

  if (threadIdx.x < kWarpgroup) {  // producer
    reg_dealloc<24>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    if (warp == 0 && lane == 0) {
      bar_expect(kv_full, 2 * sizeof(bf16) * kKV);
      load_tile<D, kBlockRows>(ks, &k_map, k0, head, kv_full);
      load_tile<D, kBlockRows>(vs, &v_map, k0, head, kv_full);
      for (int qi = first; qi < n_q; ++qi) {
        const int n = qi - first, s = n % kStages;
        if (n >= kStages) bar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
        bar_expect(&full[s], 2 * sizeof(bf16) * kQ);
        load_tile<D, kStreamRows>(qs + s * kQ, &q_map, qi * kStreamRows, head,
                                  &full[s]);
        load_tile<D, kStreamRows>(dos + s * kQ, &do_map, qi * kStreamRows,
                                  head, &full[s]);
      }
    } else if (warp == 1) {
      for (int qi = first; qi < n_q; ++qi) {
        const int n = qi - first, s = n % kStages;
        if (n >= kStages) bar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
        for (int r = lane; r < kStreamRows; r += 32) {
          const int row = qi * kStreamRows + r;
          const long long i = static_cast<long long>(head) * t_len + row;
          const bool ok = row < t_len;
          lse_s[s * kStreamRows + r] = ok ? lse[i] * kLog2e : 0.f;
          delta_s[s * kStreamRows + r] = ok ? delta[i] : 0.f;
        }
        bar_arrive(&full[s]);
      }
    }
    return;
  }
  reg_alloc<240>();
  const int c = threadIdx.x / kWarpgroup - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key_lo = k0 + 64 * c;           // this warpgroup's 64 keys
  const int key0 = key_lo + warp * 16 + g;  // this thread's keys, and + 8
  const float scale2 = scale * kLog2e;
  const bf16* kc = ks + 64 * c * kBox;
  const bf16* vc = vs + 64 * c * kBox;

  float dk_acc[D / 2], dv_acc[D / 2], s[kStreamRows / 2], dp[kStreamRows / 2];
  zero(dk_acc);
  zero(dv_acc);
  zero(s);
  zero(dp);
  bar_wait(kv_full, 0);
  for (int qi = first; qi < n_q; ++qi) {
    const int n = qi - first, st = n % kStages, q0 = qi * kStreamRows;
    const bf16* qt = qs + st * kQ;
    const bf16* dt = dos + st * kQ;
    const float* ls = lse_s + st * kStreamRows;
    const float* dl = delta_s + st * kStreamRows;
    bar_wait(&full[st], (n / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys by 64 queries.
    wgmma_fence();
    fence_acc(s);
    fence_acc(dp);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      wgmma_ss<kStreamRows>(s, kmajor_desc<kBlockRows>(kc, kd),
                            kmajor_desc<kStreamRows>(qt, kd), kd > 0);
    }
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      wgmma_ss<kStreamRows>(dp, kmajor_desc<kBlockRows>(vc, kd),
                            kmajor_desc<kStreamRows>(dt, kd), kd > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_acc(s);
    fence_acc(dp);

    const bool edge = (causal && q0 < key_lo + 63) ||
                      q0 + kStreamRows > t_len || key_lo + 64 > t_len;
#pragma unroll
    for (int i = 0; i < kStreamRows / 2; ++i) {
      const int ql = (i / 4) * 8 + 2 * t + (i & 1);
      const int qpos = q0 + ql, kpos = key0 + 8 * ((i >> 1) & 1);
      const bool hide =
          edge && !(qpos < t_len && visible(qpos, kpos, t_len, causal));
      s[i] = hide ? 0.f : exp2_approx(fmaf(s[i], scale2, -ls[ql]));  // p
    }

    // dV += P^T dO over the 64 queries; its products run while dS is
    // computed, then dK += dS^T Q.
    uint32_t pa[kStreamRows / 16][4], da[kStreamRows / 16][4];
#pragma unroll
    for (int kk = 0; kk < kStreamRows / 16; ++kk) repack_a(pa[kk], s, kk);
    wgmma_fence();
    fence_acc(dv_acc);
#pragma unroll
    for (int kk = 0; kk < kStreamRows / 16; ++kk) {
      wgmma_rs<D>(dv_acc, pa[kk], mnmajor_desc<kStreamRows>(dt, kk));
    }
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < kStreamRows / 2; ++i) {
      const int ql = (i / 4) * 8 + 2 * t + (i & 1);
      dp[i] = s[i] * (dp[i] - dl[ql]);  // ds
    }
#pragma unroll
    for (int kk = 0; kk < kStreamRows / 16; ++kk) repack_a(da[kk], dp, kk);
    wgmma_fence();
    fence_acc(dk_acc);
#pragma unroll
    for (int kk = 0; kk < kStreamRows / 16; ++kk) {
      wgmma_rs<D>(dk_acc, da[kk], mnmajor_desc<kStreamRows>(qt, kk));
    }
    wgmma_commit();
    wgmma_wait();
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    bar_arrive(&empty[st]);
  }
  store_rows<D>(dk, dk_acc, key0, head, heads, t_len, scale, scale, t);
  store_rows<D>(dv, dv_acc, key0, head, heads, t_len, 1.f, 1.f, t);
}

template <int D>
constexpr size_t dq_smem() {
  return 1024 +
         sizeof(bf16) * (2 * kBlockRows + 2 * kStages * kStreamRows) * D +
         sizeof(uint64_t) * (1 + 2 * kStages);
}

// dQ of one 128-row query tile: consumer warpgroup c owns rows q0 + 64 c
// .. + 63 and walks the key tiles, 64 rows each, recomputing S = Q K^T and
// dP = dO V^T, so dS is already the A operand of dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap q_map,
          const __grid_constant__ CUtensorMap do_map,
          const __grid_constant__ CUtensorMap k_map,
          const __grid_constant__ CUtensorMap v_map,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int t_len, int heads, int causal,
          float scale) {
  constexpr int kQ = kBlockRows * D, kKV = kStreamRows * D;
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = aligned_smem(smem_raw);
  bf16* dos = qs + kQ;
  bf16* ks = dos + kQ;                // [kStages][kKV]
  bf16* vs = ks + kStages * kKV;      // [kStages][kKV]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * kKV);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int head = blockIdx.y;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int q0 = q_tile * kBlockRows;
  const int n_k = (t_len + kStreamRows - 1) / kStreamRows;
  const int last = causal ? min(n_k - 1, (q0 + kBlockRows - 1) / kStreamRows)
                          : n_k - 1;
  init_ring(q_full, 1, full, 1, empty);

  if (threadIdx.x < kWarpgroup) {  // producer
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      bar_expect(q_full, 2 * sizeof(bf16) * kQ);
      load_tile<D, kBlockRows>(qs, &q_map, q0, head, q_full);
      load_tile<D, kBlockRows>(dos, &do_map, q0, head, q_full);
      for (int kt = 0; kt <= last; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) bar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        bar_expect(&full[s], 2 * sizeof(bf16) * kKV);
        load_tile<D, kStreamRows>(ks + s * kKV, &k_map, kt * kStreamRows,
                                  head, &full[s]);
        load_tile<D, kStreamRows>(vs + s * kKV, &v_map, kt * kStreamRows,
                                  head, &full[s]);
      }
    }
    return;
  }
  reg_alloc<240>();
  const int c = threadIdx.x / kWarpgroup - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * c;
  const int row0 = r0 + warp * 16 + g;  // and row0 + 8
  const float scale2 = scale * kLog2e;
  const bf16* qc = qs + 64 * c * kBox;
  const bf16* dc = dos + 64 * c * kBox;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const long long i = static_cast<long long>(head) * t_len + row;
    row_lse[h] = row < t_len ? lse[i] * kLog2e : 0.f;  // log2 units
    row_delta[h] = row < t_len ? delta[i] : 0.f;
  }

  float dq_acc[D / 2], s[kStreamRows / 2], dp[kStreamRows / 2];
  zero(dq_acc);
  zero(s);
  zero(dp);
  bar_wait(q_full, 0);
  for (int kt = 0; kt <= last; ++kt) {
    const int st = kt % kStages, k0 = kt * kStreamRows;
    const bf16* kt_s = ks + st * kKV;
    const bf16* vt_s = vs + st * kKV;
    bar_wait(&full[st], (kt / kStages) & 1);

    // S = Q K^T and dP = dO V^T: 64 rows by 64 keys.
    wgmma_fence();
    fence_acc(s);
    fence_acc(dp);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      wgmma_ss<kStreamRows>(s, kmajor_desc<kBlockRows>(qc, kd),
                            kmajor_desc<kStreamRows>(kt_s, kd), kd > 0);
    }
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      wgmma_ss<kStreamRows>(dp, kmajor_desc<kBlockRows>(dc, kd),
                            kmajor_desc<kStreamRows>(vt_s, kd), kd > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_acc(s);
    fence_acc(dp);

    const bool edge = (causal && r0 < k0 + kStreamRows - 1) ||
                      k0 + kStreamRows > t_len || r0 + 64 > t_len;
#pragma unroll
    for (int i = 0; i < kStreamRows / 2; ++i) {
      const int h = (i >> 1) & 1;
      const int qpos = row0 + 8 * h;
      const int kpos = k0 + (i / 4) * 8 + 2 * t + (i & 1);
      const bool hide =
          edge && !(qpos < t_len && visible(qpos, kpos, t_len, causal));
      const float p =
          hide ? 0.f : exp2_approx(fmaf(s[i], scale2, -row_lse[h]));
      dp[i] = p * (dp[i] - row_delta[h]);  // ds
    }

    // dQ += dS K over the 64 keys.
    uint32_t da[kStreamRows / 16][4];
#pragma unroll
    for (int kk = 0; kk < kStreamRows / 16; ++kk) repack_a(da[kk], dp, kk);
    wgmma_fence();
    fence_acc(dq_acc);
#pragma unroll
    for (int kk = 0; kk < kStreamRows / 16; ++kk) {
      wgmma_rs<D>(dq_acc, da[kk], mnmajor_desc<kStreamRows>(kt_s, kk));
    }
    wgmma_commit();
    wgmma_wait();
    fence_acc(dq_acc);
    bar_arrive(&empty[st]);
  }
  store_rows<D>(dq, dq_acc, row0, head, heads, t_len, scale, scale, t);
}

// ---------------------------------------------------------------------------
// Host side.

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or null where libcuda lacks it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map over a [t_len, heads, d] bf16 tensor (dims innermost first: d,
// heads, t_len), boxes of 64 columns by one head by `rows` rows, 128-byte
// swizzle, rows past t_len read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* base, int t_len, int heads,
                     int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(t_len)};
  const cuuint64_t strides[2] = {sizeof(bf16) * d,
                                 sizeof(bf16) * d * heads};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBox), 1,
                             static_cast<cuuint32_t>(rows)};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

#define DF2_TRY(expr)                        \
  do {                                       \
    const cudaError_t err_ = (expr);         \
    if (err_ != cudaSuccess) return err_;    \
  } while (0)

template <int D>
cudaError_t forward(const void* q, const void* k, const void* v, void* out,
                    float* lse, int t_len, int heads, int causal, float scale,
                    cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  DF2_TRY(make_map(&qm, q, t_len, heads, D, kBlockRows));
  DF2_TRY(make_map(&km, k, t_len, heads, D, kBlockRows));
  DF2_TRY(make_map(&vm, v, t_len, heads, D, kBlockRows));
  DF2_TRY(allow_smem(fwd_kernel<D>, fwd_smem<D>()));
  const dim3 grid((t_len + kBlockRows - 1) / kBlockRows, heads);
  fwd_kernel<D><<<grid, kThreads, fwd_smem<D>(), stream>>>(
      qm, km, vm, static_cast<bf16*>(out), lse, t_len, heads, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t backward(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, int t_len,
                     int heads, int causal, float scale, int parts,
                     cudaStream_t stream) {
  const long long chunks = static_cast<long long>(t_len) * heads * (D / 8);
  if (parts & 1) {
    delta_kernel<D><<<static_cast<unsigned>((chunks + 255) / 256), 256, 0,
                      stream>>>(static_cast<const bf16*>(out),
                                static_cast<const bf16*>(dout), delta, t_len,
                                heads);
    DF2_TRY(cudaGetLastError());
  }
  const dim3 grid((t_len + kBlockRows - 1) / kBlockRows, heads);
  if (parts & 2) {
    CUtensorMap km, vm, qm, dom;
    DF2_TRY(make_map(&km, k, t_len, heads, D, kBlockRows));
    DF2_TRY(make_map(&vm, v, t_len, heads, D, kBlockRows));
    DF2_TRY(make_map(&qm, q, t_len, heads, D, kStreamRows));
    DF2_TRY(make_map(&dom, dout, t_len, heads, D, kStreamRows));
    DF2_TRY(allow_smem(dkdv_kernel<D>, dkdv_smem<D>()));
    dkdv_kernel<D><<<grid, kThreads, dkdv_smem<D>(), stream>>>(
        km, vm, qm, dom, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), t_len, heads, causal, scale);
    DF2_TRY(cudaGetLastError());
  }
  if (parts & 4) {
    CUtensorMap qm, dom, km, vm;
    DF2_TRY(make_map(&qm, q, t_len, heads, D, kBlockRows));
    DF2_TRY(make_map(&dom, dout, t_len, heads, D, kBlockRows));
    DF2_TRY(make_map(&km, k, t_len, heads, D, kStreamRows));
    DF2_TRY(make_map(&vm, v, t_len, heads, D, kStreamRows));
    DF2_TRY(allow_smem(dq_kernel<D>, dq_smem<D>()));
    dq_kernel<D><<<grid, kThreads, dq_smem<D>(), stream>>>(
        qm, dom, km, vm, lse, delta, static_cast<bf16*>(dq), t_len, heads,
        causal, scale);
    DF2_TRY(cudaGetLastError());
  }
  return cudaSuccess;
}

}  // namespace

// q, k, v, out: [t_len, heads, d] bf16, contiguous, 16-byte aligned; lse:
// [heads, t_len] f32. d in {64, 128}, else cudaErrorInvalidValue without
// launching.
extern "C" int df2_flash_attention_sm90_fwd(const void* q, const void* k,
                                            const void* v, void* out,
                                            float* lse, int t_len, int heads,
                                            int d, int causal, float scale,
                                            void* stream) {
  if (t_len <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return static_cast<int>(forward<64>(q, k, v, out, lse, t_len, heads,
                                          causal, scale, s));
    case 128:
      return static_cast<int>(forward<128>(q, k, v, out, lse, t_len, heads,
                                           causal, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The gradient of df2_flash_attention_sm90_fwd: out and lse as it wrote
// them, dout like out; delta: [heads, t_len] f32 scratch; dq, dk, dv like
// q. `parts` picks the launches: 1 delta, 2 dK/dV, 4 dQ (7 for all; the
// later ones read delta). Returns the first error.
extern "C" int df2_flash_attention_sm90_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int t_len, int heads, int d, int causal, float scale, int parts,
    void* stream) {
  if (t_len <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return static_cast<int>(backward<64>(q, k, v, out, dout, lse, delta, dq,
                                           dk, dv, t_len, heads, causal,
                                           scale, parts, s));
    case 128:
      return static_cast<int>(backward<128>(q, k, v, out, dout, lse, delta,
                                            dq, dk, dv, t_len, heads, causal,
                                            scale, parts, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
