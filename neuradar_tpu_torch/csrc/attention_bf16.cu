// K2 at bfloat16: softmax(q k^T * D^-1/2) v with optional dropout on the probabilities, forward and
// backward, on bf16 q, k, v, without writing the [S, S] scores out, for sm_90a.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` reached through `fused_self_attention`
// -> `_fwd_call` / `_bwd_call` (ops/attention.py of the JAX package) as the JAX package runs them
// under compute_dtype bfloat16: q, k, v and the output bf16, every sum in float32 on the bf16
// values (the scores, the softmax, P and dS are float32), dQ returned in bf16, dK and dV summed in
// float32 and rounded to bf16 once. csrc/attention.cu is the float32 kernel; the two share the
// dropout hash (attention_common.cuh), the layout of rows and the two-pass backward.
//
// Dropout: keep_hash(seed, b, query, key), the same bits as csrc/attention.cu and
// ops/attention.keep_mask. Kept probabilities are scaled by 1 / (1 - rate); the softmax
// normaliser sums every key. The scale is applied once to each row's sum (the output, dV), not to
// each probability.
//
// What bounds it on the H100: operations. At a radar decode group (B = 4 scans of S = 3,531 rays,
// D = 48) the forward does 4*B*S*S*D flops and the backward 10*B*S*S*D over a few B*S*D bf16
// inputs. At D = 48 a score costs 2*D = 96 flops on the tensor cores in the forward (3 bf16 passes
// of D) and some 10-20 instructions of SIMT work (exponent, row max and sum, the dropout hash,
// the hi/lo split), so the issue slots of the elementwise work, not the tensor cores, are the
// tighter limit; the design keeps that work small and runs it beside the products.
//
// Products. Every S*S*D product is a warpgroup MMA (wgmma.mma_async, sm_90a) with bf16 operands
// and float32 accumulation, on 64-row tiles that the Tensor Memory Accelerator (TMA) copies into
// shared memory.
//  - Both operands bf16 (S = Q K^T, dP = dO V^T and their transposes): m64n64k16, A and B read
//    from shared memory (K-major), one pass.
//  - One operand float32 (P or dS; O = P V, dV = P_drop^T dO, dQ = dS K, dK = dS^T Q): m64nDk16
//    with A from registers and B the streamed tile transposed (MN-major). The float32 value x is
//    split into hi = bf16(x) and lo = bf16(x - hi), and the product is lo b + hi b, two passes.
//    x = hi + lo to about 2^-17 relative, so the error stays under the bf16 rounding of the output
//    (tests/test_torch_attention_bf16.py measures it against float64, and a single pass, which
//    does not). The wgmma accumulator of a score tile holds, in each warp, the layout of
//    mma.sync.m16n8k16's accumulator, which is its A operand's, so P and dS feed the next product
//    from the registers that hold them (acc_to_a).
// The tensor cores' float32 accumulation does not round to nearest, so a product that sums over
// all S rows sums each 64-row tile in a fresh accumulator and adds it to the running sum in float32
// SIMT.
//
// Tiles. A [B, S, D] tensor is a 3-D TMA map over (D, S, B) with a box of 16 columns x 64 rows: a
// 64-row tile is D / 16 boxes, each a "slab" of 64 rows x 32 bytes, stored with the 32-byte swizzle
// (the 16-byte half of a row is flipped in rows 4-7 of every 8; the only swizzle whose span, 32
// bytes, divides a row of every head width: 32, 64, 96 or 128 bytes). Rows past S are outside the
// map and arrive as zeros; never the next scan's rows. The wgmma descriptors read the same slabs:
// K-major, a slab is one 16-deep step of the contraction (8-row groups kSbo apart); MN-major (the
// transposed operand), a 16-row step of a tile spans the slabs kMnLbo apart. A block has kGroups
// consumer warpgroups of 64 rows each and a producer warpgroup, which gives its registers to the
// consumers (setmaxnreg); one thread of the producer issues every copy into a ring of kStages
// stages, each with a "full" mbarrier (the copy's bytes) and an "empty" one (every consumer thread
// arrives when it is done with the stage).
//
// Forward (flash-attention style): each warpgroup owns 64 queries; K and V tiles of 64 keys stream.
// The product of the next tile's scores is issued before this tile's softmax and runs beside it.
// The online softmax works in log2 units on the raw scores: exp2(s * c - m * c), c = D^-1/2 *
// log2(e), one FFMA a score; the dropout hash adds the key's part as a constant of the unrolled
// loop. The row log-sum-exp (float32) for the backward; asked for it, the output unrounded in
// float32 too: the backward's delta_i = sum_d dO_id O_id is taken from it, since from the bf16
// output it would carry the output's rounding into every dS of the row.
//
// Backward (two passes, no atomics, deterministic): attention_bf16_bwd_delta writes delta and
// lse * log2(e) per row, padded with zeros to a multiple of kPad rows; attention_bf16_bwd_dkdv,
// each warpgroup 64 keys, walking query tiles (with their lse and delta, copied by the same
// mbarrier): S^T = K Q^T, dP^T = V dO^T, dV += (m o P)^T dO, dK += dS^T Q; attention_bf16_bwd_dq,
// each warpgroup 64 queries, walking key tiles: S, dP, dQ += dS K. dS = P o (m o dP - delta).
// A tile's split products and the next tile's S and dP go to the tensor cores as one batch, and the
// block's two warpgroups issue their batches in turns (Turns), so that one runs its elementwise
// work while the other's products run. Query rows past S have Q = dO = 0 and delta = lse = 0, so
// their P is 1 and their dS 0: they add nothing. Key rows past S have K = V = 0, so they add
// nothing to dQ but their P, which the last tile of the dQ pass masks (an exponent of -lse could
// overflow).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int kTile = 64;                       // rows of a tile and of a consumer warpgroup
constexpr int kGroups = 2;                      // consumer warpgroups of a block
constexpr int kStages = 3;                      // streamed tiles in flight
constexpr int kConsumers = 128 * kGroups;       // consumer threads
constexpr int kThreads = kConsumers + 128;      // and a producer warpgroup, one thread of which copies
constexpr int kBlocksPerSm = kGroups == 1 ? 2 : 1;
// registers a thread: the producer gives its own to the consumers (setmaxnreg), within the block's
// 65,536 / kBlocksPerSm
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = kGroups == 1 ? 232 : 240;
constexpr int kBoxCols = 16;                    // bf16 columns of a TMA box
constexpr uint32_t kRowBytes = 32;              // a row of a slab: one box row, the swizzle's span
constexpr uint32_t kSlabBytes = kTile * kRowBytes;
constexpr uint32_t kSbo = 8 * kRowBytes;        // descriptor: between 8-row groups
constexpr uint32_t kKmajorLbo = 16;             // descriptor, K-major: unused by the swizzled layouts
constexpr uint32_t kMnLbo = kSlabBytes;         // descriptor, MN-major: between 16-column slabs
constexpr uint64_t kSwizzle32 = 3;              // descriptor layout type of the 32-byte swizzle
constexpr uint32_t kAlign = 1024;               // the tiles' alignment in shared memory
constexpr int kPad = 128;                       // the backward's row vectors: rows padded to a multiple
constexpr bool kTakeTurns = true;               // the backward's warpgroups issue their products in turns

// bf16 values are handled as their 16-bit patterns
using raw16 = uint16_t;

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() { return D / kBoxCols * kSlabBytes; }

__host__ __device__ constexpr int padded_rows(int S) { return (S + kPad - 1) / kPad * kPad; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return static_cast<uint32_t>(__cvta_generic_to_shared(p)); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to nearest even, x0 in the low half (the lower column or row)
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// hi = bf16(x), lo = bf16(x - hi) for a pair
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// Score accumulator groups 2kk and 2kk + 1 (columns 16kk .. 16kk + 15) as the A operand of step kk:
// registers (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..), each split in hi and lo.
__device__ __forceinline__ void acc_to_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  split_pair(c0[0], c0[1], hi[0], lo[0]);
  split_pair(c0[2], c0[3], hi[1], lo[1]);
  split_pair(c1[0], c1[1], hi[2], lo[2]);
  split_pair(c1[2], c1[3], hi[3], lo[3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.0f;
}

template <int N>
__device__ __forceinline__ void add_to(float (&acc)[N][4], const float (&part)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
  }
}

// ---- mbarriers and the Tensor Memory Accelerator ----

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive and add bytes to the transaction count of the barrier's phase
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box (16 columns from col, 64 rows from row, of scan b) into a slab; completes on bar
__device__ __forceinline__ void tma_load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar, int col, int row,
                                             int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

// rows row .. row + 63 of scan b as a tile of D / 16 slabs
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int row, int b) {
#pragma unroll
  for (int j = 0; j < D / kBoxCols; ++j) tma_load_box(dst + j * kSlabBytes, map, bar, j * kBoxCols, row, b);
}

// bytes (a multiple of 16) from a 16-byte aligned address; completes on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// ---- warpgroup MMA ----

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | kSwizzle32 << 62;
}

// K-major operand of contraction step kk: slab kk of a tile (64 rows x 16 columns)
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return smem_desc(tile + kk * kSlabBytes, kKmajorLbo, kSbo);
}

// MN-major operand of contraction step kk: rows 16kk .. 16kk + 15 of a tile, all its columns
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * kRowBytes, kMnLbo, kSbo);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The backward's two consumer warpgroups take turns to issue their products (named barriers 1 and
// 2, as FlashAttention-3's ping-pong): while one waits for its products, the other runs its
// elementwise work, where in lockstep both would wait at once. Warpgroup 0 goes first; each turn
// hands over to the other, but for warpgroup 1's last, which nobody takes.
struct Turns {
  int wg;
  bool on;
  __device__ __forceinline__ void start() const {
    if (on && wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
  }
  __device__ __forceinline__ void take() const {
    if (!on) return;
    if (wg == 0) asm volatile("bar.sync 1, 256;\n" ::: "memory");
    else asm volatile("bar.sync 2, 256;\n" ::: "memory");
  }
  __device__ __forceinline__ void pass(bool last) const {
    if (!on) return;
    if (wg == 0) asm volatile("bar.arrive 2, 256;\n" ::: "memory");
    else if (!last) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
  }
};

// Keeps the compiler from moving reads or writes of an accumulator across an asynchronous product.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
  }
}

// The accumulator of m64nNk16 in each thread: d[n][0..3] = rows (g, g, g + 8, g + 8) of the warp's 16
// x columns (8n + 2t, 8n + 2t + 1, 8n + 2t, 8n + 2t + 1). scale-d 0 (accumulate = 0) starts a fresh sum.
// d (+)= A B, m64n64k16: A [64 x 16] and B [16 x 64] both K-major in shared memory (descriptors)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}


// d (+)= A B, m64nNk16: A [64 x 16] from registers (acc_to_a's layout), B [16 x N] MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t desc_b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[2][4], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[4][4], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[6][4], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// S = A B^T and dP = A' B'^T for a warpgroup's 64 rows and a tile of 64: D / 16 steps each, issued
template <int D>
__device__ __forceinline__ void issue_score_pair(float (&sc)[8][4], float (&dp)[8][4], uint32_t a, uint32_t b,
                                                 uint32_t a2, uint32_t b2) {
#pragma unroll
  for (int kk = 0; kk < D / kBoxCols; ++kk) wgmma_ss_n64(sc, desc_k(a, kk), desc_k(b, kk), kk);
#pragma unroll
  for (int kk = 0; kk < D / kBoxCols; ++kk) wgmma_ss_n64(dp, desc_k(a2, kk), desc_k(b2, kk), kk);
}

// S (+)= Q K^T for a warpgroup's 64 rows and a tile of 64 keys: D / 16 steps, issued and committed
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[8][4], uint32_t a_tile, uint32_t b_tile) {
  fence_acc(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / kBoxCols; ++kk) wgmma_ss_n64(s, desc_k(a_tile, kk), desc_k(b_tile, kk), kk);
  wgmma_commit();
}

// part = A B over a 64-deep contraction, A split (hi, lo) in registers, B a tile read MN-major; the
// low parts first, into a fresh accumulator. Issued, not committed.
template <int D>
__device__ __forceinline__ void issue_split(float (&part)[D / 8][4], const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4], uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<D>(part, lo[kk], desc_mn(b_tile, kk), kk);
    wgmma_rs<D>(part, hi[kk], desc_mn(b_tile, kk), 1);
  }
}

// The consumer warpgroups of the block that starts at row block_row (< S) with a row before S; the
// others take no part, so that no copy asks for a box wholly outside the tensor.
__device__ __forceinline__ int active_groups(int S, int block_row) {
  return min(kGroups, (S - block_row + kTile - 1) / kTile);
}

// The block's shared memory: the tiles from the first kAlign-aligned address.
__device__ __forceinline__ uint32_t tiles_base(const uint8_t* raw) { return (smem_u32(raw) + kAlign - 1) & ~(kAlign - 1); }

template <int D>
constexpr int fwd_smem_bytes() { return (kGroups + 2 * kStages) * tile_bytes<D>() + kAlign; }

// One consumer thread of the forward: rows row0 and row0 + 8 of its warp's 16.
template <int D>
struct FwdRows {
  float o[D / 8][4], part[D / 8][4];
  float m0, m1, l0, l1;  // running maxima of the raw scores and this thread's part of the row sums
  uint32_t h0, h1;       // the rows' keep hash at key 2t of tile 0
};

// Tile j of the forward: issue the next tile's scores into next, softmax and dropout on cur (tile j's
// scores, complete), O's part from P and V, then O = O * correction + part.
template <int D, bool kDrop>
__device__ __forceinline__ void fwd_step(FwdRows<D>& r, float (&cur)[8][4], float (&next)[8][4], int j, int n_tiles,
                                         int S, float c, uint32_t thresh, uint32_t my_q, uint32_t kv, uint32_t full,
                                         uint32_t empty, int t) {
  constexpr uint32_t T = tile_bytes<D>();
  const int st = j % kStages;
  const int k0 = j * kTile;
  if (k0 + kTile > S) {  // the ragged key tail (the last tile: no product is in flight)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (k0 + 8 * n + 2 * t + (i & 1) >= S) cur[n][i] = -CUDART_INF_F;
      }
    }
  }
  if (j + 1 < n_tiles) {
    const int sn = (j + 1) % kStages;
    bar_wait(full + 8 * sn, ((j + 1) / kStages) & 1);
    issue_scores<D>(next, my_q, kv + sn * 2 * T);
  }
  // online softmax; the first tile holds key 0, so the maxima are finite from here on
  float mx0 = r.m0, mx1 = r.m1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(cur[n][0], cur[n][1]));
    mx1 = fmaxf(mx1, fmaxf(cur[n][2], cur[n][3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float corr0 = ex2((r.m0 - mx0) * c), corr1 = ex2((r.m1 - mx1) * c);
  r.m0 = mx0;
  r.m1 = mx1;
  r.l0 *= corr0;
  r.l1 *= corr1;
  const float nm0 = -mx0 * c, nm1 = -mx1 * c;
  const uint32_t ht0 = r.h0 + static_cast<uint32_t>(k0) * kColMul, ht1 = r.h1 + static_cast<uint32_t>(k0) * kColMul;
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float p[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 2 * kk + h;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = ex2(fmaf(cur[n][i], c, i < 2 ? nm0 : nm1));
        if (i < 2) r.l0 += e; else r.l1 += e;  // every key counts, dropped or not
        p[h][i] = e;
        if (kDrop) {
          const uint32_t x = (i < 2 ? ht0 : ht1) + static_cast<uint32_t>(8 * n + (i & 1)) * kColMul;
          p[h][i] = fmix32(x) >= thresh ? e : 0.0f;
        }
      }
    }
    acc_to_a(hi[kk], lo[kk], p[0], p[1]);
  }
  wgmma_fence();
  issue_split<D>(r.part, hi, lo, kv + st * 2 * T + T);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(r.part);
  fence_acc(next);
  bar_arrive(empty + 8 * st);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    r.o[n][0] = fmaf(r.o[n][0], corr0, r.part[n][0]);
    r.o[n][1] = fmaf(r.o[n][1], corr0, r.part[n][1]);
    r.o[n][2] = fmaf(r.o[n][2], corr1, r.part[n][2]);
    r.o[n][3] = fmaf(r.o[n][3], corr1, r.part[n][3]);
  }
}

// a pair of row values to a bf16 row at column d (and to a float32 row when out32 is set)
__device__ __forceinline__ void store_pair(raw16* out, float* out32, long long off, float x0, float x1) {
  *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(x0, x1);
  if (out32 != nullptr) *reinterpret_cast<float2*>(out32 + off) = make_float2(x0, x1);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) attention_bf16_fwd_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, raw16* __restrict__ out, float* __restrict__ out32,
    float* __restrict__ lse, int S, float c, uint32_t seed, uint32_t thresh, float inv_keep) {
  constexpr uint32_t T = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  const uint32_t sq = tiles_base(smem_raw);  // [kGroups] Q tiles
  const uint32_t kv = sq + kGroups * T;      // [kStages] x (K tile, V tile)
  const uint32_t full = smem_u32(bars), empty = full + 8 * kStages, qbar = full + 16 * kStages;
  const int b = blockIdx.y;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int block_row = blockIdx.x * kTile * kGroups;
  const int groups = active_groups(S, block_row);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, 128 * groups);
    }
    bar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      bar_expect(qbar, groups * T);
      for (int g = 0; g < groups; ++g) load_tile<D>(sq + g * T, &tq, qbar, block_row + g * kTile, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) bar_wait(empty + 8 * s, (j / kStages - 1) & 1);
        bar_expect(full + 8 * s, 2 * T);
        load_tile<D>(kv + s * 2 * T, &tk, full + 8 * s, j * kTile, b);
        load_tile<D>(kv + s * 2 * T + T, &tv, full + 8 * s, j * kTile, b);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  if (wg >= groups) return;
  const int row0 = block_row + wg * kTile + warp * 16 + g, row1 = row0 + 8;
  const uint32_t my_q = sq + wg * T;
  const uint32_t key_t = hash_stream(seed, b) + static_cast<uint32_t>(2 * t) * kColMul;
  FwdRows<D> r;
  zero(r.o);
  zero(r.part);
  r.m0 = r.m1 = -CUDART_INF_F;
  r.l0 = r.l1 = 0.0f;
  r.h0 = static_cast<uint32_t>(row0) * kRowMul + key_t;
  r.h1 = static_cast<uint32_t>(row1) * kRowMul + key_t;

  float sa[8][4], sb[8][4];
  bar_wait(qbar, 0);
  bar_wait(full, 0);
  issue_scores<D>(sa, my_q, kv);
  wgmma_wait<0>();
  fence_acc(sa);
  for (int j = 0; j < n_tiles; j += 2) {  // two tiles a turn, the score buffers swapping roles
    fwd_step<D, kDrop>(r, sa, sb, j, n_tiles, S, c, thresh, my_q, kv, full, empty, t);
    if (j + 1 < n_tiles) fwd_step<D, kDrop>(r, sb, sa, j + 1, n_tiles, S, c, thresh, my_q, kv, full, empty, t);
  }

  const float l0 = quad_sum(r.l0), l1 = quad_sum(r.l1);
  const float s0 = inv_keep / l0, s1 = inv_keep / l1;
  const long long base = static_cast<long long>(b) * S * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = 8 * n + 2 * t;
    if (row0 < S) store_pair(out, out32, base + static_cast<long long>(row0) * D + d, r.o[n][0] * s0, r.o[n][1] * s0);
    if (row1 < S) store_pair(out, out32, base + static_cast<long long>(row1) * D + d, r.o[n][2] * s1, r.o[n][3] * s1);
  }
  if (lse != nullptr && t == 0) {
    if (row0 < S) lse[static_cast<long long>(b) * S + row0] = (r.m0 * c + log2f(l0)) * kLn2;
    if (row1 < S) lse[static_cast<long long>(b) * S + row1] = (r.m1 * c + log2f(l1)) * kLn2;
  }
}

// Per row of scan b, padded to Sp = padded_rows(S) rows with zeros: lse2 = lse * log2(e) and delta =
// sum_d dO * O (dO in bf16, the forward's float32 O), into scratch [2][B][Sp]. One thread a row.
template <int D>
__global__ void attention_bf16_bwd_delta(const float* __restrict__ o, const raw16* __restrict__ dout,
                                         const float* __restrict__ lse, float* __restrict__ scratch, int B, int S) {
  const int Sp = padded_rows(S);
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Sp) return;
  const int b = static_cast<int>(idx / Sp), i = static_cast<int>(idx % Sp);
  float l2 = 0.0f, s = 0.0f;
  if (i < S) {
    const long long r = static_cast<long long>(b) * S + i;
    const uint4* dv = reinterpret_cast<const uint4*>(dout + r * D);
    const float4* ov = reinterpret_cast<const float4*>(o + r * D);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const uint4 w = __ldg(dv + c);
      const float4 a = __ldg(ov + 2 * c), bq = __ldg(ov + 2 * c + 1);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
      const float os[8] = {a.x, a.y, a.z, a.w, bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s = fmaf(__uint_as_float(ws[e] << 16), os[2 * e], s);
        s = fmaf(__uint_as_float(ws[e] & 0xFFFF0000u), os[2 * e + 1], s);
      }
    }
    l2 = __ldg(lse + r) * kLog2e;
  }
  scratch[idx] = l2;
  scratch[static_cast<long long>(B) * Sp + idx] = s;
}

constexpr uint32_t kVecBytes = kTile * 4;  // a tile's lse2 or delta

// a stage of the dK/dV pass: Q and dO tiles, then lse2[64] and delta[64] in a kAlign-sized slot
template <int D>
__host__ __device__ constexpr int dkdv_stage_bytes() { return 2 * tile_bytes<D>() + kAlign; }

template <int D>
constexpr int dkdv_smem_bytes() { return 2 * kGroups * tile_bytes<D>() + kStages * dkdv_stage_bytes<D>() + kAlign; }

template <int D>
constexpr int dq_smem_bytes() { return (2 * kGroups + 2 * kStages) * tile_bytes<D>() + kAlign; }

// dK and dV: each warpgroup 64 keys (rows of the transposed score tiles), walking all queries.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) attention_bf16_bwd_dkdv(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse2,
    const float* __restrict__ delta, raw16* __restrict__ dk, raw16* __restrict__ dv, int S, float c, float scale,
    uint32_t seed, uint32_t thresh, float inv_keep) {
  constexpr uint32_t T = tile_bytes<D>();
  constexpr uint32_t kStage = dkdv_stage_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  const uint32_t skv = tiles_base(smem_raw);  // [kGroups] K tiles, [kGroups] V tiles
  const uint32_t sst = skv + 2 * kGroups * T;  // [kStages] x (Q tile, dO tile, lse2[64], delta[64])
  const uint8_t* sst_ptr = smem_raw + (sst - smem_u32(smem_raw));
  const uint32_t full = smem_u32(bars), empty = full + 8 * kStages, kvbar = full + 16 * kStages;
  const int b = blockIdx.y;
  const int Sp = padded_rows(S);
  const int n_tiles = (S + kTile - 1) / kTile;
  const int block_row = blockIdx.x * kTile * kGroups;
  const int groups = active_groups(S, block_row);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, 128 * groups);
    }
    bar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      bar_expect(kvbar, 2 * groups * T);
      for (int g = 0; g < groups; ++g) {
        load_tile<D>(skv + g * T, &tk, kvbar, block_row + g * kTile, b);
        load_tile<D>(skv + (kGroups + g) * T, &tv, kvbar, block_row + g * kTile, b);
      }
      const float* lse2_b = lse2 + static_cast<long long>(b) * Sp;
      const float* delta_b = delta + static_cast<long long>(b) * Sp;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t st = sst + s * kStage;
        if (j >= kStages) bar_wait(empty + 8 * s, (j / kStages - 1) & 1);
        bar_expect(full + 8 * s, 2 * T + 2 * kVecBytes);
        load_tile<D>(st, &tq, full + 8 * s, j * kTile, b);
        load_tile<D>(st + T, &tdo, full + 8 * s, j * kTile, b);
        bulk_load(st + 2 * T, lse2_b + j * kTile, kVecBytes, full + 8 * s);
        bulk_load(st + 2 * T + kVecBytes, delta_b + j * kTile, kVecBytes, full + 8 * s);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  if (wg >= groups) return;
  const int key0 = block_row + wg * kTile + warp * 16 + g, key1 = key0 + 8;
  const uint32_t my_k = skv + wg * T, my_v = skv + (kGroups + wg) * T;
  // the keep hash of (query 2t of tile 0, key): the queries are the columns here
  const uint32_t query_t = hash_stream(seed, b) + static_cast<uint32_t>(2 * t) * kRowMul;
  const uint32_t hk0 = static_cast<uint32_t>(key0) * kColMul + query_t;
  const uint32_t hk1 = static_cast<uint32_t>(key1) * kColMul + query_t;

  float dk_acc[D / 8][4], dv_acc[D / 8][4], dk_part[D / 8][4], dv_part[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  zero(dk_part);
  zero(dv_part);
  // S^T = K Q^T and dP^T = V dO^T for 64 keys x 64 queries, one bf16 pass each: tile 0's here, each
  // next tile's in the turn of this tile's split products
  const Turns turns{wg, kTakeTurns && groups == 2};
  float sc[8][4], dp[8][4];
  bar_wait(kvbar, 0);
  bar_wait(full, 0);
  turns.start();
  turns.take();
  fence_acc(sc);
  fence_acc(dp);
  wgmma_fence();
  issue_score_pair<D>(sc, dp, my_k, sst, my_v, sst + T);
  wgmma_commit();
  turns.pass(false);
  wgmma_wait<0>();
  fence_acc(sc);
  fence_acc(dp);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t st = sst + s * kStage;

    // P^T, (m o P)^T (with the keep scale left for dV's sum) and dS^T, split for the next products
    const float* lv = reinterpret_cast<const float*>(sst_ptr + s * kStage + 2 * T);
    const float* dl = lv + kTile;
    const uint32_t hq0 = hk0 + static_cast<uint32_t>(j * kTile) * kRowMul;
    const uint32_t hq1 = hk1 + static_cast<uint32_t>(j * kTile) * kRowMul;
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float pm[2][4], ds[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 2 * kk + h;
        const float2 l2 = *reinterpret_cast<const float2*>(lv + 8 * n + 2 * t);
        const float2 dt = *reinterpret_cast<const float2*>(dl + 8 * n + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float lq = (i & 1) ? l2.y : l2.x, dq = (i & 1) ? dt.y : dt.x;
          const float p = ex2(fmaf(sc[n][i], c, -lq));
          if (kDrop) {
            const uint32_t x = (i < 2 ? hq0 : hq1) + static_cast<uint32_t>(8 * n + (i & 1)) * kRowMul;
            const bool keep = fmix32(x) >= thresh;
            pm[h][i] = keep ? p : 0.0f;
            ds[h][i] = p * (keep ? fmaf(dp[n][i], inv_keep, -dq) : -dq);
          } else {
            pm[h][i] = p;
            ds[h][i] = p * (dp[n][i] - dq);
          }
        }
      }
      acc_to_a(p_hi[kk], p_lo[kk], pm[0], pm[1]);
      acc_to_a(ds_hi[kk], ds_lo[kk], ds[0], ds[1]);
    }

    // dV's part = (m o P)^T dO and dK's part = dS^T Q, the tile's 64 queries in 4 steps of 16, and the
    // next tile's scores
    const int sn = (j + 1) % kStages;
    const uint32_t stn = sst + sn * kStage;
    if (j + 1 < n_tiles) bar_wait(full + 8 * sn, ((j + 1) / kStages) & 1);
    turns.take();
    fence_acc(dv_part);
    fence_acc(dk_part);
    wgmma_fence();
    issue_split<D>(dv_part, p_hi, p_lo, st + T);
    issue_split<D>(dk_part, ds_hi, ds_lo, st);
    if (j + 1 < n_tiles) issue_score_pair<D>(sc, dp, my_k, stn, my_v, stn + T);
    wgmma_commit();
    turns.pass(j + 1 == n_tiles);
    wgmma_wait<0>();
    fence_acc(dv_part);
    fence_acc(dk_part);
    fence_acc(sc);
    fence_acc(dp);
    bar_arrive(empty + 8 * s);
    add_to(dv_acc, dv_part);
    add_to(dk_acc, dk_part);
  }

  const long long base = static_cast<long long>(b) * S * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = 8 * n + 2 * t;
    if (key0 < S) {
      const long long off = base + static_cast<long long>(key0) * D + d;
      store_pair(dk, nullptr, off, dk_acc[n][0] * scale, dk_acc[n][1] * scale);
      store_pair(dv, nullptr, off, dv_acc[n][0] * inv_keep, dv_acc[n][1] * inv_keep);
    }
    if (key1 < S) {
      const long long off = base + static_cast<long long>(key1) * D + d;
      store_pair(dk, nullptr, off, dk_acc[n][2] * scale, dk_acc[n][3] * scale);
      store_pair(dv, nullptr, off, dv_acc[n][2] * inv_keep, dv_acc[n][3] * inv_keep);
    }
  }
}

// dQ: each warpgroup 64 queries, walking all keys.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) attention_bf16_bwd_dq(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse2,
    const float* __restrict__ delta, raw16* __restrict__ dq, int S, float c, float scale, uint32_t seed,
    uint32_t thresh, float inv_keep) {
  constexpr uint32_t T = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  const uint32_t sqd = tiles_base(smem_raw);  // [kGroups] Q tiles, [kGroups] dO tiles
  const uint32_t kv = sqd + 2 * kGroups * T;  // [kStages] x (K tile, V tile)
  const uint32_t full = smem_u32(bars), empty = full + 8 * kStages, qbar = full + 16 * kStages;
  const int b = blockIdx.y;
  const int Sp = padded_rows(S);
  const int n_tiles = (S + kTile - 1) / kTile;
  const int block_row = blockIdx.x * kTile * kGroups;
  const int groups = active_groups(S, block_row);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, 128 * groups);
    }
    bar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      bar_expect(qbar, 2 * groups * T);
      for (int g = 0; g < groups; ++g) {
        load_tile<D>(sqd + g * T, &tq, qbar, block_row + g * kTile, b);
        load_tile<D>(sqd + (kGroups + g) * T, &tdo, qbar, block_row + g * kTile, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) bar_wait(empty + 8 * s, (j / kStages - 1) & 1);
        bar_expect(full + 8 * s, 2 * T);
        load_tile<D>(kv + s * 2 * T, &tk, full + 8 * s, j * kTile, b);
        load_tile<D>(kv + s * 2 * T + T, &tv, full + 8 * s, j * kTile, b);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  if (wg >= groups) return;
  const int row0 = block_row + wg * kTile + warp * 16 + g, row1 = row0 + 8;
  const uint32_t my_q = sqd + wg * T, my_do = sqd + (kGroups + wg) * T;
  const long long rb = static_cast<long long>(b) * Sp;  // rows past S read the padding
  const float nl0 = -__ldg(lse2 + rb + row0), nl1 = -__ldg(lse2 + rb + row1);
  const float dl0 = __ldg(delta + rb + row0), dl1 = __ldg(delta + rb + row1);
  const uint32_t key_t = hash_stream(seed, b) + static_cast<uint32_t>(2 * t) * kColMul;
  const uint32_t h0 = static_cast<uint32_t>(row0) * kRowMul + key_t;
  const uint32_t h1 = static_cast<uint32_t>(row1) * kRowMul + key_t;

  float dq_acc[D / 8][4], part[D / 8][4];
  zero(dq_acc);
  zero(part);
  // S = Q K^T and dP = dO V^T for 64 queries x 64 keys, one bf16 pass each: tile 0's here, each next
  // tile's in the turn of this tile's split product
  const Turns turns{wg, kTakeTurns && groups == 2};
  float sc[8][4], dp[8][4];
  bar_wait(qbar, 0);
  bar_wait(full, 0);
  turns.start();
  turns.take();
  fence_acc(sc);
  fence_acc(dp);
  wgmma_fence();
  issue_score_pair<D>(sc, dp, my_q, kv, my_do, kv + T);
  wgmma_commit();
  turns.pass(false);
  wgmma_wait<0>();
  fence_acc(sc);
  fence_acc(dp);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t st = kv + s * 2 * T;

    const int k0 = j * kTile;
    if (k0 + kTile > S) {  // keys past S have K = 0, but their P = exp2(-lse2) need not be finite
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (k0 + 8 * n + 2 * t + (i & 1) >= S) sc[n][i] = -CUDART_INF_F;
        }
      }
    }
    const uint32_t ht0 = h0 + static_cast<uint32_t>(k0) * kColMul, ht1 = h1 + static_cast<uint32_t>(k0) * kColMul;
    uint32_t ds_hi[4][4], ds_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float ds[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 2 * kk + h;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = ex2(fmaf(sc[n][i], c, i < 2 ? nl0 : nl1));
          const float dr = i < 2 ? dl0 : dl1;
          if (kDrop) {
            const uint32_t x = (i < 2 ? ht0 : ht1) + static_cast<uint32_t>(8 * n + (i & 1)) * kColMul;
            ds[h][i] = p * (fmix32(x) >= thresh ? fmaf(dp[n][i], inv_keep, -dr) : -dr);
          } else {
            ds[h][i] = p * (dp[n][i] - dr);
          }
        }
      }
      acc_to_a(ds_hi[kk], ds_lo[kk], ds[0], ds[1]);
    }

    // dQ's part = dS K, the tile's 64 keys in 4 steps of 16, and the next tile's scores
    const uint32_t stn = kv + (j + 1) % kStages * 2 * T;
    if (j + 1 < n_tiles) bar_wait(full + 8 * ((j + 1) % kStages), ((j + 1) / kStages) & 1);
    turns.take();
    fence_acc(part);
    wgmma_fence();
    issue_split<D>(part, ds_hi, ds_lo, st);
    if (j + 1 < n_tiles) issue_score_pair<D>(sc, dp, my_q, stn, my_do, stn + T);
    wgmma_commit();
    turns.pass(j + 1 == n_tiles);
    wgmma_wait<0>();
    fence_acc(part);
    fence_acc(sc);
    fence_acc(dp);
    bar_arrive(empty + 8 * s);
    add_to(dq_acc, part);
  }

  const long long base = static_cast<long long>(b) * S * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = 8 * n + 2 * t;
    if (row0 < S) store_pair(dq, nullptr, base + static_cast<long long>(row0) * D + d, dq_acc[n][0] * scale,
                             dq_acc[n][1] * scale);
    if (row1 < S) store_pair(dq, nullptr, base + static_cast<long long>(row1) * D + d, dq_acc[n][2] * scale,
                             dq_acc[n][3] * scale);
  }
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point query: the library links no libcuda.
EncodeTiled find_encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(fn) : nullptr;
}

// A [B, S, D] bf16 tensor as a 3-D map over (D, S, B): boxes of 16 columns x 64 rows of one scan,
// 32-byte swizzle, zeros outside; returns a cudaError_t code.
int tile_map(CUtensorMap* map, const void* base, int B, int S, int D) {
  static const EncodeTiled encode = find_encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {kBoxCols, kTile, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
                              steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

dim3 grid_of(int B, int S) { return dim3((S + kTile * kGroups - 1) / (kTile * kGroups), B); }

template <int D>
int launch_fwd(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, raw16* o, float* o32, float* lse,
               int B, int S, float scale, uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const float c = scale * kLog2e;
  auto kernel = thresh != 0u ? attention_bf16_fwd_kernel<D, true> : attention_bf16_fwd_kernel<D, false>;
  return launch(kernel, grid_of(B, S), kThreads, fwd_smem_bytes<D>(), stream, tq, tk, tv, o, o32, lse, S, c, seed,
                thresh, inv_keep);
}

template <int D>
int launch_bwd(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const CUtensorMap& tdo,
               const float* o32, const raw16* dout, const float* lse, float* scratch, raw16* dq, raw16* dk, raw16* dv,
               int B, int S, float scale, uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * padded_rows(S);
  attention_bf16_bwd_delta<D><<<static_cast<unsigned>((rows + 255) / 256), 256, 0, stream>>>(o32, dout, lse, scratch,
                                                                                             B, S);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const float* lse2 = scratch;
  const float* delta = scratch + rows;
  const float c = scale * kLog2e;
  const bool drop = thresh != 0u;
  auto dkdv = drop ? attention_bf16_bwd_dkdv<D, true> : attention_bf16_bwd_dkdv<D, false>;
  err = launch(dkdv, grid_of(B, S), kThreads, dkdv_smem_bytes<D>(), stream, tq, tk, tv, tdo, lse2, delta, dk, dv, S,
               c, scale, seed, thresh, inv_keep);
  if (err != 0) return err;
  auto dqk = drop ? attention_bf16_bwd_dq<D, true> : attention_bf16_bwd_dq<D, false>;
  return launch(dqk, grid_of(B, S), kThreads, dq_smem_bytes<D>(), stream, tq, tk, tv, tdo, lse2, delta, dq, S, c,
                scale, seed, thresh, inv_keep);
}

bool built_for(int D) { return D == 16 || D == 32 || D == 48 || D == 64; }

}  // namespace

// Returns a cudaError_t code; cudaErrorInvalidValue for a head width it was not built for.
// q, k, v, out: [B, S, D] bf16, 16-byte aligned. out32 ([B, S, D] float32, the output before its
// rounding) and lse ([B, S] float32) may be null (inference). thresh = 0 turns dropout off.
extern "C" int self_attention_bf16_fwd(const void* q, const void* k, const void* v, void* out, void* out32, void* lse,
                                       int B, int S, int D, float scale, unsigned int seed, unsigned int thresh,
                                       float inv_keep, void* stream) {
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (!built_for(D)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = tile_map(&tq, q, B, S, D);
  if (err == 0) err = tile_map(&tk, k, B, S, D);
  if (err == 0) err = tile_map(&tv, v, B, S, D);
  if (err != 0) return err;
  auto* oh = static_cast<raw16*>(out);
  auto* of = static_cast<float*>(out32);
  auto* lf = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_fwd<16>(tq, tk, tv, oh, of, lf, B, S, scale, seed, thresh, inv_keep, st);
    case 32: return launch_fwd<32>(tq, tk, tv, oh, of, lf, B, S, scale, seed, thresh, inv_keep, st);
    case 48: return launch_fwd<48>(tq, tk, tv, oh, of, lf, B, S, scale, seed, thresh, inv_keep, st);
    default: return launch_fwd<64>(tq, tk, tv, oh, of, lf, B, S, scale, seed, thresh, inv_keep, st);
  }
}

// The float32 scratch the backward takes: [2, B, padded S] (lse * log2(e) and delta per row).
extern "C" long long self_attention_bf16_bwd_scratch(int B, int S) { return 2LL * B * padded_rows(S); }

// out32 and lse are the forward's float32 outputs; scratch is self_attention_bf16_bwd_scratch(B, S)
// floats, 16-byte aligned; dq, dk, dv are [B, S, D] bf16 outputs.
extern "C" int self_attention_bf16_bwd(const void* q, const void* k, const void* v, const void* out32,
                                       const void* dout, const void* lse, void* scratch, void* dq, void* dk, void* dv,
                                       int B, int S, int D, float scale, unsigned int seed, unsigned int thresh,
                                       float inv_keep, void* stream) {
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (!built_for(D)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  int err = tile_map(&tq, q, B, S, D);
  if (err == 0) err = tile_map(&tk, k, B, S, D);
  if (err == 0) err = tile_map(&tv, v, B, S, D);
  if (err == 0) err = tile_map(&tdo, dout, B, S, D);
  if (err != 0) return err;
  const auto* of = static_cast<const float*>(out32);
  const auto* doh = static_cast<const raw16*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  auto* sf = static_cast<float*>(scratch);
  auto* dqh = static_cast<raw16*>(dq);
  auto* dkh = static_cast<raw16*>(dk);
  auto* dvh = static_cast<raw16*>(dv);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_bwd<16>(tq, tk, tv, tdo, of, doh, lf, sf, dqh, dkh, dvh, B, S, scale, seed, thresh, inv_keep, st);
    case 32: return launch_bwd<32>(tq, tk, tv, tdo, of, doh, lf, sf, dqh, dkh, dvh, B, S, scale, seed, thresh, inv_keep, st);
    case 48: return launch_bwd<48>(tq, tk, tv, tdo, of, doh, lf, sf, dqh, dkh, dvh, B, S, scale, seed, thresh, inv_keep, st);
    default: return launch_bwd<64>(tq, tk, tv, tdo, of, doh, lf, sf, dqh, dkh, dvh, B, S, scale, seed, thresh, inv_keep, st);
  }
}
