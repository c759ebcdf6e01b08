// K2: softmax(q k^T * D^-1/2) v with optional dropout on the probabilities,
// forward and backward, without writing the [S, S] scores out, for sm_90a.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` reached through
// `fused_self_attention` -> `_fwd_call` / `_bwd_call` (ops/attention.py of the
// JAX package). q, k, v, the output and the gradients are [B, S, D] float32,
// B = scans x heads, D in {16, 32, 48, 64}; lse and delta are [B, S].
//
// Dropout. The keep mask is a pure function of (seed, b, query row, key
// column): a murmur3-finalizer hash, keep_hash (attention_common.cuh). It
// never depends on a tile or block size, so the forward and the backward, and
// the plain PyTorch version on the CPU (ops/attention.py), drop the same entries.
// (The TPU kernel hashed (seed + grid cell, row in block, column); its query
// block differs between forward and backward under bfloat16, and so did its
// mask.) Kept probabilities are scaled by 1 / (1 - rate), as flax does. The
// softmax normaliser sums every key, dropped or not.
//
// What bounds it on the H100: operations. At the radar encoder's shape
// (S = 3,531 rays, D = 48) the forward does 4*S*S*D flops per scan and the
// backward 10*S*S*D (14 with the recompute) over inputs of a few S*D floats.
// In float32 outside the tensor cores (67 TFLOP/s) that bounds the train
// batch's forward at 0.57 ms; its first port did those products with SIMT
// fmaf and lost to SDPA, whose float32 path runs on the tensor cores.
//
// What the design does about it: every S*S*D product runs on the tensor
// cores as mma.sync.m16n8k8 in TF32 with error compensation ("3xTF32", as
// CUTLASS's OpMultiplyAddFastF32): each float32 operand x is split into
// big = rna_tf32(x) and small = rna_tf32(x - big), and a product is
// small_a*big_b + big_a*small_b + big_a*big_b accumulated in float32. That
// keeps the error near float32's (one TF32 product alone is off by ~5e-4
// relative, see tests/test_torch_attention_tc.py); its bound is 3x the flops
// over 495 TFLOP/s. The tensor cores' float32 accumulation does not round to
// nearest, so a product that sums over all S rows (P V, dV, dK, dQ) sums each
// tile in a fresh accumulator and adds it to the running sum in float32 SIMT.
//
// Layout. A block has 4 warps; a warp owns 16 rows of a 64-row tile and
// computes 16 x 64 score tiles with m16n8k8 (8 column tiles of 8). The tiles
// that a block walks are staged in dynamic shared memory by 16-byte cp.async
// copies, double-buffered, so the next tile's copy overlaps this tile's
// products; rows past S are zero-filled by the copy and masked. The row pitch
// is D + 4 floats: 16-byte aligned for cp.async, and every fragment read
// below (rows g = lane / 4, columns t = lane % 4, or the transposed pattern)
// touches 32 distinct banks. The accumulator of one product holds columns
// 2t, 2t+1 of each 8-column group, while an A operand wants columns t, t+4;
// since the order of a contraction is free, the next product reads its B
// rows in the matching order (2t, 2t+1) instead of moving the values.
//
// Forward (flash-attention style): one block per (scan, 64 queries). Q lives
// in registers as split A fragments, pre-scaled by D^-1/2 * log2(e) so that
// the online softmax uses exp2; K and V tiles of 64 keys stream through
// shared memory. S = Q K^T, the online softmax on the accumulator fragment
// (a row's 64 columns lie in the 4 threads of a quad: 2 shuffles for its
// max), the mask, then O = O * correction + P V. The row log-sum-exp is
// written for the backward.
//
// Backward (FlashAttention-2 style, two passes, no atomics, deterministic):
// delta_i = sum_d dO_id O_id first (attention_bwd_delta). With dropout,
// sum_j m_ij dP_ij P_ij = delta_i, so dS = P o (m o dP - delta).
// attention_bwd_dkdv: one block per (scan, 64 keys), K and V staged once,
// walking query tiles of Q, dO, lse and delta: S^T = K Q^T, P^T, dP^T = V dO^T,
// dV += (m o P)^T dO, dS^T, dK += dS^T Q. attention_bwd_dq: one block per
// (scan, 64 queries), Q and dO staged once, walking K and V tiles: S, dP =
// dO V^T, dS, dQ += dS K. Seven S*S*D products where the function needs five.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;     // rows of a block and of a staged tile; 16 per warp
constexpr int kCols = kTile / 8;  // 8-column groups of a 16 x 64 score tile

template <int D>
__host__ __device__ constexpr int pitch() { return D + 4; }

// ---- 3xTF32 on the tensor cores ----

// cvt.rna.tf32.f32 (round to nearest, ties away from zero), bit for bit on finite x: add half of
// the 13 dropped bits' range to the magnitude's bits, then clear them. Two integer operations; the
// instruction itself compiles to four here (it also passes NaN and infinity through, and no
// operand of these products is either).
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

struct FragA {  // rows (g, g + 8) x columns (t, t + 4) of a 16 x 8 operand, big and small parts
  uint32_t big[4], small[4];
  // x = {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)}
  __device__ __forceinline__ void set(float x0, float x1, float x2, float x3) {
    split(x0, big[0], small[0]);
    split(x1, big[1], small[1]);
    split(x2, big[2], small[2]);
    split(x3, big[3], small[3]);
  }
};

struct FragB {  // rows (t, t + 4) of column g of an 8 x 8 operand
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(float x0, float x1) {
    split(x0, big[0], small[0]);
    split(x1, big[1], small[1]);
  }
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, the small terms first. c holds rows (g, g + 8) x columns (2t, 2t + 1).
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// An accumulator's 8-column group c[4] as the A operand of the next product: its columns
// (2t, 2t + 1) go to the A slots (t, t + 4), so the next product's B rows are read in the order
// (2t, 2t + 1) too.
__device__ __forceinline__ void acc_to_a(FragA& a, const float (&c)[4]) { a.set(c[0], c[2], c[1], c[3]); }

// A fragment of rows r0 + (g, g + 8), columns c0 + (t, t + 4) of a tile in shared memory, times scale.
template <int D>
__device__ __forceinline__ void load_a(FragA& a, const float* tile, int r0, int c0, int g, int t, float scale) {
  const float* p = tile + (r0 + g) * pitch<D>() + c0 + t;
  const float* q = p + 8 * pitch<D>();
  a.set(p[0] * scale, q[0] * scale, p[4] * scale, q[4] * scale);
}

// B fragment of B[c][n] = tile[n0 + n][c0 + c] (the rows of the tile are B's columns):
// tile[n0 + g][c0 + t], tile[n0 + g][c0 + t + 4].
template <int D>
__device__ __forceinline__ void load_b_rows(FragB& b, const float* tile, int n0, int c0, int g, int t) {
  const float* p = tile + (n0 + g) * pitch<D>() + c0 + t;
  b.set(p[0], p[4]);
}

// B fragment of B[c][n] = tile[k0 + c][n0 + n] with the contraction index permuted as acc_to_a
// leaves it: tile[k0 + 2t][n0 + g], tile[k0 + 2t + 1][n0 + g].
template <int D>
__device__ __forceinline__ void load_b_cols(FragB& b, const float* tile, int k0, int n0, int g, int t) {
  const float* p = tile + (k0 + 2 * t) * pitch<D>() + n0 + g;
  b.set(p[0], p[pitch<D>()]);
}

// ---- asynchronous copies into shared memory ----

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Rows r0 .. r0 + 63 of one scan's [S, D] matrix into a [64, pitch] tile; rows past S become 0.
template <int D>
__device__ __forceinline__ void stage_rows(float* tile, const float* src, int r0, int S) {
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = 4 * (i % kChunks);
    const bool valid = r0 + r < S;
    cp_async16(tile + r * pitch<D>() + c, src + static_cast<long long>(valid ? r0 + r : 0) * D + c, valid);
  }
}

// Entries r0 .. r0 + 63 of one scan's [S] vector; entries past S become 0.
__device__ __forceinline__ void stage_vector(float* dst, const float* src, int r0, int S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool valid = r0 + r < S;
    cp_async4(dst + r, src + (valid ? r0 + r : 0), valid);
  }
}

// Accumulator helpers. A product that sums over all S rows (P V, dV, dK, dQ) adds each tile's part,
// summed by the tensor cores in a fresh accumulator, to its running sum here in float32 SIMT.
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

template <int D>
constexpr int fwd_smem_bytes() { return 2 * 2 * kTile * pitch<D>() * 4; }  // K and V, two stages

template <int D>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(const float* __restrict__ q,
                                                                 const float* __restrict__ k,
                                                                 const float* __restrict__ v,
                                                                 float* __restrict__ out, float* __restrict__ lse,
                                                                 int S, float scale, uint32_t seed,
                                                                 uint32_t thresh, float inv_keep) {
  constexpr int P = pitch<D>();
  constexpr int KD = D / 8;  // 8-wide groups along D
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [2][kTile][P]
  float* vs = ks + 2 * kTile * P;               // [2][kTile][P]

  const int b = blockIdx.y;
  const long long base = static_cast<long long>(b) * S * D;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int n_tiles = (S + kTile - 1) / kTile;

  stage_rows<D>(ks, k + base, 0, S);
  stage_rows<D>(vs, v + base, 0, S);
  cp_async_commit();

  // this thread's query rows, and Q as A fragments scaled by D^-1/2 * log2(e)
  const int row0 = blockIdx.x * kTile + warp * 16 + g;
  const int row1 = row0 + 8;
  const float qscale = scale * kLog2e;
  FragA qa[KD];
  {
    const float* q0 = q + base + static_cast<long long>(row0) * D;
    const float* q1 = q0 + 8 * D;
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      const int d = 8 * c + t;
      qa[c].set(row0 < S ? __ldg(q0 + d) * qscale : 0.0f, row1 < S ? __ldg(q1 + d) * qscale : 0.0f,
                row0 < S ? __ldg(q0 + d + 4) * qscale : 0.0f, row1 < S ? __ldg(q1 + d + 4) * qscale : 0.0f);
    }
  }
  const bool dropout = thresh != 0u;
  const uint32_t stream = hash_stream(seed, b);
  const uint32_t h0 = static_cast<uint32_t>(row0) * kRowMul + stream;
  const uint32_t h1 = static_cast<uint32_t>(row1) * kRowMul + stream;

  float o[KD][4];
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
    const float* kt = ks + stage * kTile * P;
    const float* vt = vs + stage * kTile * P;
    const int k0 = it * kTile;

    // S = Q K^T for 16 rows x 64 keys
    float s[kCols][4];
    zero(s);
#pragma unroll
    for (int c = 0; c < KD; ++c) {
#pragma unroll
      for (int n = 0; n < kCols; ++n) {
        FragB kb;
        load_b_rows<D>(kb, kt, 8 * n, 8 * c, g, t);
        mma3(s[n], qa[c], kb);
      }
    }
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

    // O = O * correction + P V, P's 64 keys in 8 steps of 8
    float pv[KD][4];
    zero(pv);
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      FragA pa;
      acc_to_a(pa, s[n]);
#pragma unroll
      for (int c = 0; c < KD; ++c) {
        FragB vb;
        load_b_cols<D>(vb, vt, 8 * n, 8 * c, g, t);
        mma3(pv[c], pa, vb);
      }
    }
#pragma unroll
    for (int c = 0; c < KD; ++c) {
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
  for (int c = 0; c < KD; ++c) {
    const int d = 8 * c + 2 * t;
    if (row0 < S) {
      *reinterpret_cast<float2*>(out + base + static_cast<long long>(row0) * D + d) = make_float2(o[c][0] * r0, o[c][1] * r0);
    }
    if (row1 < S) {
      *reinterpret_cast<float2*>(out + base + static_cast<long long>(row1) * D + d) = make_float2(o[c][2] * r1, o[c][3] * r1);
    }
  }
  if (lse != nullptr && t == 0) {
    if (row0 < S) lse[static_cast<long long>(b) * S + row0] = (m0 + log2f(l0)) * kLn2;
    if (row1 < S) lse[static_cast<long long>(b) * S + row1] = (m1 + log2f(l1)) * kLn2;
  }
}

// delta[b, i] = sum_d dO[b, i, d] * O[b, i, d]; one thread per row.
__global__ void attention_bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
                                    float* __restrict__ delta, long long rows, int D) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float s = 0.0f;
  for (int d = 0; d < D; ++d) s = fmaf(__ldg(dout + r * D + d), __ldg(o + r * D + d), s);
  delta[r] = s;
}

template <int D>
constexpr int bwd_smem_bytes() {  // two fixed tiles, two streamed tiles in two stages, two streamed vectors
  return (2 * kTile * pitch<D>() + 2 * 2 * kTile * pitch<D>() + 2 * 2 * kTile) * 4;
}

// dK and dV for 64 keys per block (16 per warp), walking all queries in tiles of 64.
template <int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkdv(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int S, float scale, uint32_t seed, uint32_t thresh,
    float inv_keep) {
  constexpr int P = pitch<D>();
  constexpr int KD = D / 8;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kTile][P], this block's keys
  float* vs = ks + kTile * P;                   // [kTile][P]
  float* qs = vs + kTile * P;                   // [2][kTile][P]
  float* dos = qs + 2 * kTile * P;              // [2][kTile][P]
  float* lse_s = dos + 2 * kTile * P;           // [2][kTile]
  float* delta_s = lse_s + 2 * kTile;           // [2][kTile]

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

  float dk_acc[KD][4], dv_acc[KD][4];
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
    const float* qt = qs + stage * kTile * P;
    const float* dot = dos + stage * kTile * P;
    const float* lt = lse_s + stage * kTile;
    const float* dt = delta_s + stage * kTile;
    const int q0 = it * kTile;

    // S^T = K Q^T and dP^T = V dO^T for 16 keys x 64 queries
    float s[kCols][4], dp[kCols][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      FragA ka, va;
      load_a<D>(ka, ks, w0, 8 * c, g, t, kscale);
      load_a<D>(va, vs, w0, 8 * c, g, t, 1.0f);
#pragma unroll
      for (int n = 0; n < kCols; ++n) {
        FragB qb, dob;
        load_b_rows<D>(qb, qt, 8 * n, 8 * c, g, t);
        mma3(s[n], ka, qb);
        load_b_rows<D>(dob, dot, 8 * n, 8 * c, g, t);
        mma3(dp[n], va, dob);
      }
    }

    // P^T, then (m o P)^T into s and dS^T into dp; queries past S get P = 0
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * n + 2 * t + (j & 1);
        const int qi = q0 + col;
        const float p = qi < S ? exp2f(s[n][j] - lt[col] * kLog2e) : 0.0f;
        float mk = 1.0f;
        if (dropout) mk = fmix32((j < 2 ? hk0 : hk1) + static_cast<uint32_t>(qi) * kRowMul) >= thresh ? inv_keep : 0.0f;
        s[n][j] = p * mk;                      // the probability the forward used
        dp[n][j] = p * (mk * dp[n][j] - dt[col]);  // softmax VJP through the mask
      }
    }

    // dV += (m o P)^T dO, then dK += dS^T Q, the tile's 64 queries in 8 steps of 8
    float part[KD][4];
    zero(part);
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      FragA pa;
      acc_to_a(pa, s[n]);
#pragma unroll
      for (int c = 0; c < KD; ++c) {
        FragB dob;
        load_b_cols<D>(dob, dot, 8 * n, 8 * c, g, t);
        mma3(part[c], pa, dob);
      }
    }
    add_to(dv_acc, part);
    zero(part);
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      FragA dsa;
      acc_to_a(dsa, dp[n]);
#pragma unroll
      for (int c = 0; c < KD; ++c) {
        FragB qb;
        load_b_cols<D>(qb, qt, 8 * n, 8 * c, g, t);
        mma3(part[c], dsa, qb);
      }
    }
    add_to(dk_acc, part);
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < KD; ++c) {
    const int d = 8 * c + 2 * t;
    if (key0 < static_cast<uint32_t>(S)) {
      const long long off = base + static_cast<long long>(key0) * D + d;
      *reinterpret_cast<float2*>(dk + off) = make_float2(dk_acc[c][0] * scale, dk_acc[c][1] * scale);
      *reinterpret_cast<float2*>(dv + off) = make_float2(dv_acc[c][0], dv_acc[c][1]);
    }
    if (key1 < static_cast<uint32_t>(S)) {
      const long long off = base + static_cast<long long>(key1) * D + d;
      *reinterpret_cast<float2*>(dk + off) = make_float2(dk_acc[c][2] * scale, dk_acc[c][3] * scale);
      *reinterpret_cast<float2*>(dv + off) = make_float2(dv_acc[c][2], dv_acc[c][3]);
    }
  }
}

// dQ for 64 queries per block (16 per warp), walking all keys in tiles of 64.
template <int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int S, float scale, uint32_t seed, uint32_t thresh, float inv_keep) {
  constexpr int P = pitch<D>();
  constexpr int KD = D / 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kTile][P], this block's queries
  float* dos = qs + kTile * P;                  // [kTile][P]
  float* ks = dos + kTile * P;                  // [2][kTile][P]
  float* vs = ks + 2 * kTile * P;               // [2][kTile][P]

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

  float dq_acc[KD][4];
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
    const float* kt = ks + stage * kTile * P;
    const float* vt = vs + stage * kTile * P;
    const int k0 = it * kTile;

    // S = Q K^T and dP = dO V^T for 16 queries x 64 keys
    float s[kCols][4], dp[kCols][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      FragA qa, doa;
      load_a<D>(qa, qs, w0, 8 * c, g, t, qscale);
      load_a<D>(doa, dos, w0, 8 * c, g, t, 1.0f);
#pragma unroll
      for (int n = 0; n < kCols; ++n) {
        FragB kb, vb;
        load_b_rows<D>(kb, kt, 8 * n, 8 * c, g, t);
        mma3(s[n], qa, kb);
        load_b_rows<D>(vb, vt, 8 * n, 8 * c, g, t);
        mma3(dp[n], doa, vb);
      }
    }

    // dS into dp; keys past S get P = 0
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + 8 * n + 2 * t + (j & 1);
        const float p = kj < S ? exp2f(s[n][j] - (j < 2 ? lse0 : lse1)) : 0.0f;
        float mk = 1.0f;
        if (dropout) mk = fmix32((j < 2 ? h0 : h1) + static_cast<uint32_t>(kj) * kColMul) >= thresh ? inv_keep : 0.0f;
        dp[n][j] = p * (mk * dp[n][j] - (j < 2 ? delta0 : delta1));
      }
    }

    // dQ += dS K, the tile's 64 keys in 8 steps of 8
    float part[KD][4];
    zero(part);
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      FragA dsa;
      acc_to_a(dsa, dp[n]);
#pragma unroll
      for (int c = 0; c < KD; ++c) {
        FragB kb;
        load_b_cols<D>(kb, kt, 8 * n, 8 * c, g, t);
        mma3(part[c], dsa, kb);
      }
    }
    add_to(dq_acc, part);
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < KD; ++c) {
    const int d = 8 * c + 2 * t;
    if (row0 < S) {
      *reinterpret_cast<float2*>(dq + base + static_cast<long long>(row0) * D + d) =
          make_float2(dq_acc[c][0] * scale, dq_acc[c][1] * scale);
    }
    if (row1 < S) {
      *reinterpret_cast<float2*>(dq + base + static_cast<long long>(row1) * D + d) =
          make_float2(dq_acc[c][2] * scale, dq_acc[c][3] * scale);
    }
  }
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int B, int S, float scale,
               uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const dim3 grid((S + kTile - 1) / kTile, B);
  return launch(attention_fwd_kernel<D>, grid, kThreads, fwd_smem_bytes<D>(), stream, q, k, v, o, lse, S, scale, seed,
                thresh, inv_keep);
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v, const float* o, const float* dout,
               const float* lse, float* delta, float* dq, float* dk, float* dv, int B, int S, float scale,
               uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * S;
  attention_bwd_delta<<<static_cast<unsigned>((rows + 255) / 256), 256, 0, stream>>>(o, dout, delta, rows, D);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid((S + kTile - 1) / kTile, B);
  err = launch(attention_bwd_dkdv<D>, grid, kThreads, bwd_smem_bytes<D>(), stream, q, k, v, dout, lse,
               static_cast<const float*>(delta), dk, dv, S, scale, seed, thresh, inv_keep);
  if (err != 0) return err;
  return launch(attention_bwd_dq<D>, grid, kThreads, bwd_smem_bytes<D>(), stream, q, k, v, dout, lse,
                static_cast<const float*>(delta), dq, S, scale, seed, thresh, inv_keep);
}

}  // namespace

// Returns a cudaError_t code; cudaErrorInvalidValue for a head width it was not built for.
// thresh = 0 turns dropout off; otherwise an entry is kept when keep_hash >= thresh.
// lse may be null (inference).
extern "C" int self_attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int S,
                                  int D, float scale, unsigned int seed, unsigned int thresh, float inv_keep,
                                  void* stream) {
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  auto* lf = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_fwd<16>(qf, kf, vf, of, lf, B, S, scale, seed, thresh, inv_keep, st);
    case 32: return launch_fwd<32>(qf, kf, vf, of, lf, B, S, scale, seed, thresh, inv_keep, st);
    case 48: return launch_fwd<48>(qf, kf, vf, of, lf, B, S, scale, seed, thresh, inv_keep, st);
    case 64: return launch_fwd<64>(qf, kf, vf, of, lf, B, S, scale, seed, thresh, inv_keep, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// delta is [B, S] scratch; dq, dk, dv are [B, S, D] outputs.
extern "C" int self_attention_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
                                  const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S, int D,
                                  float scale, unsigned int seed, unsigned int thresh, float inv_keep,
                                  void* stream) {
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(out);
  const auto* dof = static_cast<const float*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  auto* df = static_cast<float*>(delta);
  auto* dqf = static_cast<float*>(dq);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_bwd<16>(qf, kf, vf, of, dof, lf, df, dqf, dkf, dvf, B, S, scale, seed, thresh, inv_keep, st);
    case 32: return launch_bwd<32>(qf, kf, vf, of, dof, lf, df, dqf, dkf, dvf, B, S, scale, seed, thresh, inv_keep, st);
    case 48: return launch_bwd<48>(qf, kf, vf, of, dof, lf, df, dqf, dkf, dvf, B, S, scale, seed, thresh, inv_keep, st);
    case 64: return launch_bwd<64>(qf, kf, vf, of, dof, lf, df, dqf, dkf, dvf, B, S, scale, seed, thresh, inv_keep, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
