// K2 at bfloat16: softmax(q k^T * D^-1/2) v with optional dropout on the probabilities, forward and
// backward, on bf16 q, k, v, without writing the [S, S] scores out, for sm_90a.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` reached through `fused_self_attention`
// -> `_fwd_call` / `_bwd_call` (ops/attention.py of the JAX package) as the JAX package runs them
// under compute_dtype bfloat16: q, k, v and the output bf16, every sum in float32 on the bf16
// values (the scores, the softmax, P and dS are float32), dQ returned in bf16, dK and dV summed in
// float32 and rounded to bf16 once. csrc/attention.cu is the float32 kernel; the two share the
// layout, the dropout hash and the two-pass backward, and differ in the products.
//
// Dropout: keep_hash(seed, b, query, key), the same bits as csrc/attention.cu and
// ops/attention.keep_mask. Kept probabilities are scaled by 1 / (1 - rate); the softmax
// normaliser sums every key.
//
// What bounds it on the H100: operations. At a radar decode group (B = 4 scans of S = 3,531 rays,
// D = 48) the forward does 4*B*S*S*D flops and the backward 10*B*S*S*D over a few B*S*D bf16
// inputs; bf16 tensor cores run 989 TFLOP/s dense, twice TF32's rate.
//
// What the design does about it: every S*S*D product runs on the tensor cores as
// mma.sync.m16n8k16 with bf16 operands and float32 accumulation.
//  - Both operands bf16 (S = Q K^T, dP = dO V^T): one mma per product; the float32 scores are
//    scaled by D^-1/2 * log2(e) after it, so the scale adds no rounding.
//  - One operand float32 (P or dS; O = P V, dV = P_drop^T dO, dQ = dS K, dK = dS^T Q): the float32
//    value x is split into hi = bf16(x) and lo = bf16(x - hi), and the product is lo b + hi b,
//    two mmas. x = hi + lo to about 2^-17 relative, so the error stays under the bf16 rounding of
//    the output (tests/test_torch_attention_bf16.py measures it against float64, and a single
//    pass, which does not).
// The tensor cores' float32 accumulation does not round to nearest, so a product that sums over
// all S rows sums each 64-row tile in a fresh accumulator and adds it to the running sum in float32
// SIMT, as the float32 kernel does.
//
// Layout. A block has 4 warps; a warp owns 16 rows of a 64-row tile. Tiles are staged in dynamic
// shared memory by 16-byte cp.async copies, double-buffered, half the bytes of the float32
// kernel's; rows past S are zero-filled by the copy and masked. The row pitch is D + 8 bf16: rows
// 16-byte aligned for cp.async, and the fragment reads of rows g = lane / 4 at word t = lane % 4
// touch 32 distinct banks. m16n8k16 fragments (PTX ISA): A holds rows (g, g + 8) x columns
// (2t, 2t + 1, 2t + 8, 2t + 9), B rows (2t, 2t + 1, 2t + 8, 2t + 9) of column g, the accumulator
// rows (g, g + 8) x columns (2t, 2t + 1). So two neighbouring 8-column accumulator groups are
// exactly an A fragment of 16 columns: P and dS feed the next product without moving between
// lanes. A B operand whose contraction runs down the rows of a tile (V, dO, Q, K in the second
// products) is packed from two 16-bit reads.
//
// Forward (flash-attention style): one block per (scan, 64 queries), Q in registers, K and V tiles
// of 64 keys streaming; the online softmax in log2 units; the row log-sum-exp (float32) for the
// backward. Asked for it, the forward also writes the output unrounded in float32: the backward's
// delta_i = sum_d dO_id O_id is taken from it, since from the bf16 output it would carry the
// output's rounding into every dS of the row.
//
// Backward (two passes, no atomics, deterministic): delta first; attention_bwd_dkdv, one block
// per (scan, 64 keys), walking query tiles: S^T = K Q^T, dP^T = V dO^T, dV += (m o P)^T dO,
// dK += dS^T Q; attention_bwd_dq, one block per (scan, 64 queries), walking key tiles: S, dP,
// dQ += dS K. dS = P o (m o dP - delta).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;         // rows of a block and of a staged tile; 16 per warp
constexpr int kCols = kTile / 8;  // 8-column groups of a 16 x 64 score tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// bf16 values are handled as their 16-bit patterns
using raw16 = uint16_t;

template <int D>
__host__ __device__ constexpr int pitch() { return D + 8; }

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// keep_hash(seed, b, qi, kj) = fmix32(qi * kRowMul + kj * kColMul + hash_stream(seed, b)), as in
// csrc/attention.cu; an entry is kept when it is >= thresh.
constexpr uint32_t kRowMul = 0x9E3779B9u;
constexpr uint32_t kColMul = 0x85EBCA6Bu;

__device__ __forceinline__ uint32_t hash_stream(uint32_t seed, uint32_t b) { return fmix32(seed + b * 0x27D4EB2Fu); }

__device__ __forceinline__ float bf16_to_float(raw16 x) { return __uint_as_float(static_cast<uint32_t>(x) << 16); }

// two floats rounded to nearest even, x0 in the low half (the lower column or row)
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(raw16 lo, raw16 hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// hi = bf16(x), lo = bf16(x - hi) for a pair
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

struct FragA2 {  // a float32 A operand of 16 x 16 as hi and lo bf16 parts
  uint32_t hi[4], lo[4];
};

// Accumulator groups c0 (columns 0-7) and c1 (columns 8-15) as the A operand of the next product:
// registers (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..).
__device__ __forceinline__ void acc_to_a(FragA2& a, const float (&c0)[4], const float (&c1)[4]) {
  split_pair(c0[0], c0[1], a.hi[0], a.lo[0]);
  split_pair(c0[2], c0[3], a.hi[1], a.lo[1]);
  split_pair(c1[0], c1[1], a.hi[2], a.lo[2]);
  split_pair(c1[2], c1[3], a.hi[3], a.lo[3]);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for a split float32 A: the low part first
__device__ __forceinline__ void mma_split(float (&c)[4], const FragA2& a, uint32_t b0, uint32_t b1) {
  mma_bf16(c, a.lo, b0, b1);
  mma_bf16(c, a.hi, b0, b1);
}

__device__ __forceinline__ uint32_t word(const raw16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// A fragment of rows r0 + (g, g + 8), columns c0 + (2t, 2t + 1, 2t + 8, 2t + 9) of a tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const raw16* tile, int r0, int c0, int g, int t) {
  const raw16* p = tile + (r0 + g) * pitch<D>() + c0 + 2 * t;
  a[0] = word(p);
  a[1] = word(p + 8 * pitch<D>());
  a[2] = word(p + 8);
  a[3] = word(p + 8 * pitch<D>() + 8);
}

// B fragment of B[k][n] = tile[n0 + n][k0 + k] (the rows of the tile are B's columns)
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1, const raw16* tile, int n0, int k0, int g,
                                            int t) {
  const raw16* p = tile + (n0 + g) * pitch<D>() + k0 + 2 * t;
  b0 = word(p);
  b1 = word(p + 8);
}

// B fragment of B[k][n] = tile[k0 + k][n0 + n] (the contraction runs down the tile's rows)
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1, const raw16* tile, int k0, int n0, int g,
                                            int t) {
  constexpr int P = pitch<D>();
  const raw16* p = tile + (k0 + 2 * t) * P + n0 + g;
  b0 = pack_raw(p[0], p[P]);
  b1 = pack_raw(p[8 * P], p[9 * P]);
}

// ---- asynchronous copies into shared memory ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Rows r0 .. r0 + 63 of one scan's [S, D] bf16 matrix into a [64, pitch] tile; rows past S become 0.
template <int D>
__device__ __forceinline__ void stage_rows(raw16* tile, const raw16* src, int r0, int S) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = 8 * (i % kChunks);
    const bool valid = r0 + r < S;
    cp_async16(tile + r * pitch<D>() + c, src + static_cast<long long>(valid ? r0 + r : 0) * D + c, valid);
  }
}

__device__ __forceinline__ void stage_vector(float* dst, const float* src, int r0, int S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool valid = r0 + r < S;
    cp_async4(dst + r, src + (valid ? r0 + r : 0), valid);
  }
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

template <int N>
__device__ __forceinline__ void scale_all(float (&a)[N][4], float s) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] *= s;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// a pair of row values to a bf16 row at column d (and to a float32 row when out32 is set)
__device__ __forceinline__ void store_pair(raw16* out, float* out32, long long off, float x0, float x1) {
  *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(x0, x1);
  if (out32 != nullptr) *reinterpret_cast<float2*>(out32 + off) = make_float2(x0, x1);
}

template <int D>
constexpr int fwd_smem_bytes() { return 2 * 2 * kTile * pitch<D>() * 2; }  // K and V, two stages

template <int D>
__global__ void __launch_bounds__(kThreads) attention_bf16_fwd_kernel(
    const raw16* __restrict__ q, const raw16* __restrict__ k, const raw16* __restrict__ v, raw16* __restrict__ out,
    float* __restrict__ out32, float* __restrict__ lse, int S, float scale, uint32_t seed, uint32_t thresh,
    float inv_keep) {
  constexpr int P = pitch<D>();
  constexpr int KD = D / 16;  // 16-deep steps along D
  constexpr int ND = D / 8;   // 8-column groups along D
  extern __shared__ float4 smem4[];
  raw16* ks = reinterpret_cast<raw16*>(smem4);  // [2][kTile][P]
  raw16* vs = ks + 2 * kTile * P;               // [2][kTile][P]

  const int b = blockIdx.y;
  const long long base = static_cast<long long>(b) * S * D;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int n_tiles = (S + kTile - 1) / kTile;

  stage_rows<D>(ks, k + base, 0, S);
  stage_rows<D>(vs, v + base, 0, S);
  cp_async_commit();

  // this thread's query rows; Q as A fragments, straight from device memory
  const int row0 = blockIdx.x * kTile + warp * 16 + g;
  const int row1 = row0 + 8;
  uint32_t qa[KD][4];
#pragma unroll
  for (int c = 0; c < KD; ++c) {
    const int d = 16 * c + 2 * t;
    const raw16* q0 = q + base + static_cast<long long>(row0) * D + d;
    const raw16* q1 = q0 + 8 * D;
    qa[c][0] = row0 < S ? __ldg(reinterpret_cast<const unsigned int*>(q0)) : 0u;
    qa[c][1] = row1 < S ? __ldg(reinterpret_cast<const unsigned int*>(q1)) : 0u;
    qa[c][2] = row0 < S ? __ldg(reinterpret_cast<const unsigned int*>(q0 + 8)) : 0u;
    qa[c][3] = row1 < S ? __ldg(reinterpret_cast<const unsigned int*>(q1 + 8)) : 0u;
  }
  const float qscale = scale * kLog2e;
  const bool dropout = thresh != 0u;
  const uint32_t stream = hash_stream(seed, b);
  const uint32_t h0 = static_cast<uint32_t>(row0) * kRowMul + stream;
  const uint32_t h1 = static_cast<uint32_t>(row1) * kRowMul + stream;

  float o[ND][4];
  zero(o);
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running maxima of rows g and g + 8 (log2 units)
  float l0 = 0.0f, l1 = 0.0f;                    // this thread's part of the running sums

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      stage_rows<D>(ks + (stage ^ 1) * kTile * P, k + base, (it + 1) * kTile, S);
      stage_rows<D>(vs + (stage ^ 1) * kTile * P, v + base, (it + 1) * kTile, S);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const raw16* kt = ks + stage * kTile * P;
    const raw16* vt = vs + stage * kTile * P;
    const int k0 = it * kTile;

    // S = Q K^T for 16 rows x 64 keys, one bf16 pass, then scaled in float32
    float s[kCols][4];
    zero(s);
#pragma unroll
    for (int c = 0; c < KD; ++c) {
#pragma unroll
      for (int n = 0; n < kCols; ++n) {
        uint32_t b0, b1;
        load_b_rows<D>(b0, b1, kt, 8 * n, 16 * c, g, t);
        mma_bf16(s[n], qa[c], b0, b1);
      }
    }
    scale_all(s, qscale);
    if (k0 + kTile > S) {  // the ragged key tail
#pragma unroll
      for (int n = 0; n < kCols; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (k0 + 8 * n + 2 * t + (j & 1) >= S) s[n][j] = -CUDART_INF_F;
        }
      }
    }

    // online softmax; the first tile holds key 0, so the maxima are finite from here on
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[n][j] - (j < 2 ? m0 : m1));
        if (j < 2) l0 += p; else l1 += p;  // every key counts, dropped or not
        float pd = p;
        if (dropout) {
          const uint32_t kj = static_cast<uint32_t>(k0 + 8 * n + 2 * t + (j & 1));
          pd = fmix32((j < 2 ? h0 : h1) + kj * kColMul) >= thresh ? p * inv_keep : 0.0f;
        }
        s[n][j] = pd;
      }
    }

    // O = O * correction + P V, P split in two bf16 parts, its 64 keys in 4 steps of 16
    float pv[ND][4];
    zero(pv);
#pragma unroll
    for (int j = 0; j < kCols / 2; ++j) {
      FragA2 pa;
      acc_to_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        uint32_t b0, b1;
        load_b_cols<D>(b0, b1, vt, 16 * j, 8 * c, g, t);
        mma_split(pv[c], pa, b0, b1);
      }
    }
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      o[c][0] = fmaf(o[c][0], c0, pv[c][0]);
      o[c][1] = fmaf(o[c][1], c0, pv[c][1]);
      o[c][2] = fmaf(o[c][2], c1, pv[c][2]);
      o[c][3] = fmaf(o[c][3], c1, pv[c][3]);
    }
    __syncthreads();
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float r0 = 1.0f / l0, r1 = 1.0f / l1;
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    const int d = 8 * c + 2 * t;
    if (row0 < S) store_pair(out, out32, base + static_cast<long long>(row0) * D + d, o[c][0] * r0, o[c][1] * r0);
    if (row1 < S) store_pair(out, out32, base + static_cast<long long>(row1) * D + d, o[c][2] * r1, o[c][3] * r1);
  }
  if (lse != nullptr && t == 0) {
    if (row0 < S) lse[static_cast<long long>(b) * S + row0] = (m0 + log2f(l0)) * kLn2;
    if (row1 < S) lse[static_cast<long long>(b) * S + row1] = (m1 + log2f(l1)) * kLn2;
  }
}

// delta[b, i] = sum_d dO[b, i, d] * O[b, i, d], dO in bf16 and the forward's float32 O; one thread per row.
__global__ void attention_bf16_bwd_delta(const float* __restrict__ o, const raw16* __restrict__ dout,
                                         float* __restrict__ delta, long long rows, int D) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float s = 0.0f;
  for (int d = 0; d < D; ++d) s = fmaf(bf16_to_float(__ldg(dout + r * D + d)), __ldg(o + r * D + d), s);
  delta[r] = s;
}

template <int D>
constexpr int bwd_smem_bytes() {  // two fixed tiles and two streamed tiles in two stages (bf16), two streamed vectors
  return (2 * kTile * pitch<D>() + 2 * 2 * kTile * pitch<D>()) * 2 + 2 * 2 * kTile * 4;
}

// dK and dV for 64 keys per block (16 per warp), walking all queries in tiles of 64.
template <int D>
__global__ void __launch_bounds__(kThreads) attention_bf16_bwd_dkdv(
    const raw16* __restrict__ q, const raw16* __restrict__ k, const raw16* __restrict__ v,
    const raw16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    raw16* __restrict__ dk, raw16* __restrict__ dv, int S, float scale, uint32_t seed, uint32_t thresh,
    float inv_keep) {
  constexpr int P = pitch<D>();
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  extern __shared__ float4 smem4[];
  raw16* ks = reinterpret_cast<raw16*>(smem4);  // [kTile][P], this block's keys
  raw16* vs = ks + kTile * P;                   // [kTile][P]
  raw16* qs = vs + kTile * P;                   // [2][kTile][P]
  raw16* dos = qs + 2 * kTile * P;              // [2][kTile][P]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTile * P);  // [2][kTile]
  float* delta_s = lse_s + 2 * kTile;                            // [2][kTile]

  const int b = blockIdx.y;
  const long long base = static_cast<long long>(b) * S * D;
  const float* lse_b = lse + static_cast<long long>(b) * S;
  const float* delta_b = delta + static_cast<long long>(b) * S;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int kb0 = blockIdx.x * kTile;
  const int w0 = warp * 16;  // this warp's first key within the block
  const int n_tiles = (S + kTile - 1) / kTile;

  stage_rows<D>(ks, k + base, kb0, S);
  stage_rows<D>(vs, v + base, kb0, S);
  stage_rows<D>(qs, q + base, 0, S);
  stage_rows<D>(dos, dout + base, 0, S);
  stage_vector(lse_s, lse_b, 0, S);
  stage_vector(delta_s, delta_b, 0, S);
  cp_async_commit();

  const bool dropout = thresh != 0u;
  const uint32_t stream = hash_stream(seed, b);
  const uint32_t key0 = static_cast<uint32_t>(kb0 + w0 + g), key1 = key0 + 8;  // rows of the transposed tiles
  const uint32_t hk0 = key0 * kColMul + stream, hk1 = key1 * kColMul + stream;
  const float kscale = scale * kLog2e;

  float dk_acc[ND][4], dv_acc[ND][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      const int q1 = (it + 1) * kTile;
      stage_rows<D>(qs + (stage ^ 1) * kTile * P, q + base, q1, S);
      stage_rows<D>(dos + (stage ^ 1) * kTile * P, dout + base, q1, S);
      stage_vector(lse_s + (stage ^ 1) * kTile, lse_b, q1, S);
      stage_vector(delta_s + (stage ^ 1) * kTile, delta_b, q1, S);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const raw16* qt = qs + stage * kTile * P;
    const raw16* dot = dos + stage * kTile * P;
    const float* lt = lse_s + stage * kTile;
    const float* dt = delta_s + stage * kTile;
    const int q0 = it * kTile;

    // S^T = K Q^T and dP^T = V dO^T for 16 keys x 64 queries, one bf16 pass each
    float s[kCols][4], dp[kCols][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      uint32_t ka[4], va[4];
      load_a<D>(ka, ks, w0, 16 * c, g, t);
      load_a<D>(va, vs, w0, 16 * c, g, t);
#pragma unroll
      for (int n = 0; n < kCols; ++n) {
        uint32_t b0, b1;
        load_b_rows<D>(b0, b1, qt, 8 * n, 16 * c, g, t);
        mma_bf16(s[n], ka, b0, b1);
        load_b_rows<D>(b0, b1, dot, 8 * n, 16 * c, g, t);
        mma_bf16(dp[n], va, b0, b1);
      }
    }

    // P^T, then (m o P)^T into s and dS^T into dp; queries past S get P = 0
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * n + 2 * t + (j & 1);
        const int qi = q0 + col;
        const float p = qi < S ? exp2f(s[n][j] * kscale - lt[col] * kLog2e) : 0.0f;
        float mk = 1.0f;
        if (dropout) mk = fmix32((j < 2 ? hk0 : hk1) + static_cast<uint32_t>(qi) * kRowMul) >= thresh ? inv_keep : 0.0f;
        s[n][j] = p * mk;                          // the probability the forward used
        dp[n][j] = p * (mk * dp[n][j] - dt[col]);  // softmax VJP through the mask
      }
    }

    // dV += (m o P)^T dO, then dK += dS^T Q, the tile's 64 queries in 4 steps of 16, split A
    float part[ND][4];
    zero(part);
#pragma unroll
    for (int j = 0; j < kCols / 2; ++j) {
      FragA2 pa;
      acc_to_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        uint32_t b0, b1;
        load_b_cols<D>(b0, b1, dot, 16 * j, 8 * c, g, t);
        mma_split(part[c], pa, b0, b1);
      }
    }
    add_to(dv_acc, part);
    zero(part);
#pragma unroll
    for (int j = 0; j < kCols / 2; ++j) {
      FragA2 dsa;
      acc_to_a(dsa, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        uint32_t b0, b1;
        load_b_cols<D>(b0, b1, qt, 16 * j, 8 * c, g, t);
        mma_split(part[c], dsa, b0, b1);
      }
    }
    add_to(dk_acc, part);
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < ND; ++c) {
    const int d = 8 * c + 2 * t;
    if (key0 < static_cast<uint32_t>(S)) {
      const long long off = base + static_cast<long long>(key0) * D + d;
      store_pair(dk, nullptr, off, dk_acc[c][0] * scale, dk_acc[c][1] * scale);
      store_pair(dv, nullptr, off, dv_acc[c][0], dv_acc[c][1]);
    }
    if (key1 < static_cast<uint32_t>(S)) {
      const long long off = base + static_cast<long long>(key1) * D + d;
      store_pair(dk, nullptr, off, dk_acc[c][2] * scale, dk_acc[c][3] * scale);
      store_pair(dv, nullptr, off, dv_acc[c][2], dv_acc[c][3]);
    }
  }
}

// dQ for 64 queries per block (16 per warp), walking all keys in tiles of 64.
template <int D>
__global__ void __launch_bounds__(kThreads) attention_bf16_bwd_dq(
    const raw16* __restrict__ q, const raw16* __restrict__ k, const raw16* __restrict__ v,
    const raw16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    raw16* __restrict__ dq, int S, float scale, uint32_t seed, uint32_t thresh, float inv_keep) {
  constexpr int P = pitch<D>();
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  extern __shared__ float4 smem4[];
  raw16* qs = reinterpret_cast<raw16*>(smem4);  // [kTile][P], this block's queries
  raw16* dos = qs + kTile * P;                  // [kTile][P]
  raw16* ks = dos + kTile * P;                  // [2][kTile][P]
  raw16* vs = ks + 2 * kTile * P;               // [2][kTile][P]

  const int b = blockIdx.y;
  const long long base = static_cast<long long>(b) * S * D;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int qb0 = blockIdx.x * kTile;
  const int w0 = warp * 16;
  const int n_tiles = (S + kTile - 1) / kTile;

  stage_rows<D>(qs, q + base, qb0, S);
  stage_rows<D>(dos, dout + base, qb0, S);
  stage_rows<D>(ks, k + base, 0, S);
  stage_rows<D>(vs, v + base, 0, S);
  cp_async_commit();

  const int row0 = qb0 + w0 + g, row1 = row0 + 8;
  const float lse0 = row0 < S ? __ldg(lse + static_cast<long long>(b) * S + row0) * kLog2e : 0.0f;
  const float lse1 = row1 < S ? __ldg(lse + static_cast<long long>(b) * S + row1) * kLog2e : 0.0f;
  const float delta0 = row0 < S ? __ldg(delta + static_cast<long long>(b) * S + row0) : 0.0f;
  const float delta1 = row1 < S ? __ldg(delta + static_cast<long long>(b) * S + row1) : 0.0f;
  const bool dropout = thresh != 0u;
  const uint32_t stream = hash_stream(seed, b);
  const uint32_t h0 = static_cast<uint32_t>(row0) * kRowMul + stream;
  const uint32_t h1 = static_cast<uint32_t>(row1) * kRowMul + stream;
  const float qscale = scale * kLog2e;

  float dq_acc[ND][4];
  zero(dq_acc);

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      stage_rows<D>(ks + (stage ^ 1) * kTile * P, k + base, (it + 1) * kTile, S);
      stage_rows<D>(vs + (stage ^ 1) * kTile * P, v + base, (it + 1) * kTile, S);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const raw16* kt = ks + stage * kTile * P;
    const raw16* vt = vs + stage * kTile * P;
    const int k0 = it * kTile;

    // S = Q K^T and dP = dO V^T for 16 queries x 64 keys, one bf16 pass each
    float s[kCols][4], dp[kCols][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      uint32_t qa[4], doa[4];
      load_a<D>(qa, qs, w0, 16 * c, g, t);
      load_a<D>(doa, dos, w0, 16 * c, g, t);
#pragma unroll
      for (int n = 0; n < kCols; ++n) {
        uint32_t b0, b1;
        load_b_rows<D>(b0, b1, kt, 8 * n, 16 * c, g, t);
        mma_bf16(s[n], qa, b0, b1);
        load_b_rows<D>(b0, b1, vt, 8 * n, 16 * c, g, t);
        mma_bf16(dp[n], doa, b0, b1);
      }
    }

    // dS into dp; keys past S get P = 0
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + 8 * n + 2 * t + (j & 1);
        const float p = kj < S ? exp2f(s[n][j] * qscale - (j < 2 ? lse0 : lse1)) : 0.0f;
        float mk = 1.0f;
        if (dropout) mk = fmix32((j < 2 ? h0 : h1) + static_cast<uint32_t>(kj) * kColMul) >= thresh ? inv_keep : 0.0f;
        dp[n][j] = p * (mk * dp[n][j] - (j < 2 ? delta0 : delta1));
      }
    }

    // dQ += dS K, the tile's 64 keys in 4 steps of 16, split A
    float part[ND][4];
    zero(part);
#pragma unroll
    for (int j = 0; j < kCols / 2; ++j) {
      FragA2 dsa;
      acc_to_a(dsa, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        uint32_t b0, b1;
        load_b_cols<D>(b0, b1, kt, 16 * j, 8 * c, g, t);
        mma_split(part[c], dsa, b0, b1);
      }
    }
    add_to(dq_acc, part);
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < ND; ++c) {
    const int d = 8 * c + 2 * t;
    if (row0 < S) store_pair(dq, nullptr, base + static_cast<long long>(row0) * D + d, dq_acc[c][0] * scale,
                             dq_acc[c][1] * scale);
    if (row1 < S) store_pair(dq, nullptr, base + static_cast<long long>(row1) * D + d, dq_acc[c][2] * scale,
                             dq_acc[c][3] * scale);
  }
}

// Sets a kernel's dynamic shared memory limit and launches it; returns the first cudaError_t.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, Args... args) {
  int err = static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err != 0) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd(const raw16* q, const raw16* k, const raw16* v, raw16* o, float* o32, float* lse, int B, int S,
               float scale, uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const dim3 grid((S + kTile - 1) / kTile, B);
  return launch(attention_bf16_fwd_kernel<D>, grid, fwd_smem_bytes<D>(), stream, q, k, v, o, o32, lse, S, scale, seed,
                thresh, inv_keep);
}

template <int D>
int launch_bwd(const raw16* q, const raw16* k, const raw16* v, const float* o32, const raw16* dout, const float* lse,
               float* delta, raw16* dq, raw16* dk, raw16* dv, int B, int S, float scale, uint32_t seed,
               uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * S;
  attention_bf16_bwd_delta<<<static_cast<unsigned>((rows + 255) / 256), 256, 0, stream>>>(o32, dout, delta, rows, D);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid((S + kTile - 1) / kTile, B);
  err = launch(attention_bf16_bwd_dkdv<D>, grid, bwd_smem_bytes<D>(), stream, q, k, v, dout, lse,
               static_cast<const float*>(delta), dk, dv, S, scale, seed, thresh, inv_keep);
  if (err != 0) return err;
  return launch(attention_bf16_bwd_dq<D>, grid, bwd_smem_bytes<D>(), stream, q, k, v, dout, lse,
                static_cast<const float*>(delta), dq, S, scale, seed, thresh, inv_keep);
}

}  // namespace

// Returns a cudaError_t code; cudaErrorInvalidValue for a head width it was not built for.
// q, k, v, out: [B, S, D] bf16. out32 ([B, S, D] float32, the output before its rounding) and lse
// ([B, S] float32) may be null (inference). thresh = 0 turns dropout off.
extern "C" int self_attention_bf16_fwd(const void* q, const void* k, const void* v, void* out, void* out32, void* lse,
                                       int B, int S, int D, float scale, unsigned int seed, unsigned int thresh,
                                       float inv_keep, void* stream) {
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const auto* qh = static_cast<const raw16*>(q);
  const auto* kh = static_cast<const raw16*>(k);
  const auto* vh = static_cast<const raw16*>(v);
  auto* oh = static_cast<raw16*>(out);
  auto* of = static_cast<float*>(out32);
  auto* lf = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_fwd<16>(qh, kh, vh, oh, of, lf, B, S, scale, seed, thresh, inv_keep, st);
    case 32: return launch_fwd<32>(qh, kh, vh, oh, of, lf, B, S, scale, seed, thresh, inv_keep, st);
    case 48: return launch_fwd<48>(qh, kh, vh, oh, of, lf, B, S, scale, seed, thresh, inv_keep, st);
    case 64: return launch_fwd<64>(qh, kh, vh, oh, of, lf, B, S, scale, seed, thresh, inv_keep, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out32 and lse are the forward's float32 outputs; delta is [B, S] float32 scratch; dq, dk, dv are
// [B, S, D] bf16 outputs.
extern "C" int self_attention_bf16_bwd(const void* q, const void* k, const void* v, const void* out32,
                                       const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
                                       int B, int S, int D, float scale, unsigned int seed, unsigned int thresh,
                                       float inv_keep, void* stream) {
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const auto* qh = static_cast<const raw16*>(q);
  const auto* kh = static_cast<const raw16*>(k);
  const auto* vh = static_cast<const raw16*>(v);
  const auto* of = static_cast<const float*>(out32);
  const auto* doh = static_cast<const raw16*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  auto* df = static_cast<float*>(delta);
  auto* dqh = static_cast<raw16*>(dq);
  auto* dkh = static_cast<raw16*>(dk);
  auto* dvh = static_cast<raw16*>(dv);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_bwd<16>(qh, kh, vh, of, doh, lf, df, dqh, dkh, dvh, B, S, scale, seed, thresh, inv_keep, st);
    case 32: return launch_bwd<32>(qh, kh, vh, of, doh, lf, df, dqh, dkh, dvh, B, S, scale, seed, thresh, inv_keep, st);
    case 48: return launch_bwd<48>(qh, kh, vh, of, doh, lf, df, dqh, dkh, dvh, B, S, scale, seed, thresh, inv_keep, st);
    case 64: return launch_bwd<64>(qh, kh, vh, of, doh, lf, df, dqh, dkh, dvh, B, S, scale, seed, thresh, inv_keep, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
