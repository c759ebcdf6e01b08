// K2: softmax(q k^T * D^-1/2) v with optional dropout on the probabilities,
// forward and backward, without writing the [S, S] scores out, for sm_90a.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` reached through
// `fused_self_attention` -> `_fwd_call` / `_bwd_call` (ops/attention.py of the
// JAX package). q, k, v, the output and the gradients are [B, S, D] float32,
// B = scans x heads; lse and delta are [B, S].
//
// Dropout. The keep mask is a pure function of (seed, b, query row, key
// column): a murmur3-finalizer hash, see keep_hash below. It never depends on
// a tile or block size, so the forward and the backward, and the plain
// PyTorch version on the CPU (ops/attention.py), drop the same entries.
// (The TPU kernel hashed (seed + grid cell, row in block, column); its query
// block differs between forward and backward under bfloat16, and so did its
// mask.) Kept probabilities are scaled by 1 / (1 - rate), as flax does.
//
// What bounds it on the H100: compute and latency. At the radar encoder's
// shape (S = 3,531 rays, D = 48) each scan does 2*S*S*D multiply-adds forward
// (4*S*S*D backward) over inputs of only a few S*D floats, and D = 48 is too
// narrow to keep many independent multiply-adds in flight per thread.
//
// Forward (flash-attention style, no tensor cores yet): one block of 128
// threads per (scan, tile of 32 queries). Four threads share a query; each
// takes every fourth key of a 64-key tile. Key and value tiles are staged in
// shared memory with a row pitch of D + 1 floats. Each thread keeps an
// online-softmax running max and sum and its [D] accumulator in registers;
// the four partial states of a query are merged with warp shuffles at the
// end. The row log-sum-exp is written for the backward. The ragged key tail
// is masked inside the kernel (no padding outside).
//
// Backward: delta_i = sum_d dO_id O_id first (attention_bwd_delta). With
// dropout, sum_j m_ij dP_ij P_ij = delta_i, so dS = P o (m o dP - delta).
// Then two passes, no atomics: attention_bwd_dkdv gives each block 32 keys
// and walks all query tiles, accumulating dK and dV in registers;
// attention_bwd_dq gives each block 32 queries and walks all key tiles. In
// both, four threads share a row and split D between them (D/4 registers
// each for the row, its operand and its accumulator); the two dot products
// of a (query, key) pair are finished with two shuffles each.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroups = 4;                      // threads per query (or key)
constexpr int kRows = kThreads / kGroups;       // queries (or keys) per block
constexpr int kTile = 64;                       // rows per shared-memory tile
constexpr int kKeysPerThread = kTile / kGroups;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The dropout hash; ops/attention.keep_mask computes the same bits on the CPU.
__device__ __forceinline__ uint32_t keep_hash(uint32_t seed, uint32_t b, uint32_t qi, uint32_t kj) {
  const uint32_t stream = fmix32(seed + b * 0x27D4EB2Fu);
  return fmix32(qi * 0x9E3779B9u + kj * 0x85EBCA6Bu + stream);
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(const float* __restrict__ q,
                                                                 const float* __restrict__ k,
                                                                 const float* __restrict__ v,
                                                                 float* __restrict__ out, float* __restrict__ lse,
                                                                 int S, float scale, uint32_t seed,
                                                                 uint32_t thresh, float inv_keep) {
  __shared__ float ks[kTile][D + 1];
  __shared__ float vs[kTile][D + 1];

  const int b = blockIdx.y;
  const long long base = static_cast<long long>(b) * S * D;
  const int group = threadIdx.x & (kGroups - 1);
  const int qi = blockIdx.x * kRows + (threadIdx.x / kGroups);
  const bool valid = qi < S;
  const bool dropout = thresh != 0u;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = valid ? __ldg(q + base + static_cast<long long>(qi) * D + d) * scale : 0.0f;
    acc[d] = 0.0f;
  }
  float m = -CUDART_INF_F;
  float l = 0.0f;

  for (int k0 = 0; k0 < S; k0 += kTile) {
    const int nk = min(kTile, S - k0);
    // stage the tile: float4 reads from device memory, zero rows past S
    for (int i = threadIdx.x; i < kTile * D / 4; i += kThreads) {
      const int j = (4 * i) / D;
      const int d = (4 * i) % D;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (j < nk) {
        const long long off = base + static_cast<long long>(k0 + j) * D + d;
        kv = __ldg(reinterpret_cast<const float4*>(k + off));
        vv = __ldg(reinterpret_cast<const float4*>(v + off));
      }
      ks[j][d] = kv.x; ks[j][d + 1] = kv.y; ks[j][d + 2] = kv.z; ks[j][d + 3] = kv.w;
      vs[j][d] = vv.x; vs[j][d + 1] = vv.y; vs[j][d + 2] = vv.z; vs[j][d + 3] = vv.w;
    }
    __syncthreads();

    float sc[kKeysPerThread];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < kKeysPerThread; ++t) {
      const int j = kGroups * t + group;
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j][d], s);
      sc[t] = j < nk ? s : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, sc[t]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new != -CUDART_INF_F) {  // this thread has seen at least one real key
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int t = 0; t < kKeysPerThread; ++t) {
        const int j = kGroups * t + group;
        const float p = expf(sc[t] - m_new);
        l += p;  // the softmax normalizer sums every key, dropped or not
        float pd = p;
        if (dropout) pd = keep_hash(seed, b, qi, k0 + j) >= thresh ? p * inv_keep : 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(pd, vs[j][d], acc[d]);
      }
      m = m_new;
    }
    __syncthreads();
  }

  // merge the four partial softmax states of each query (lanes differ in the low two bits)
  float m_all = m;
#pragma unroll
  for (int off = 1; off < kGroups; off <<= 1) m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, off));
  const float corr = m == -CUDART_INF_F ? 0.0f : expf(m - m_all);
  l *= corr;
#pragma unroll
  for (int off = 1; off < kGroups; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float a = acc[d] * corr;
#pragma unroll
    for (int off = 1; off < kGroups; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    acc[d] = a;
  }
  if (valid) {
    const float inv_l = 1.0f / l;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (d / (D / kGroups) == group) out[base + static_cast<long long>(qi) * D + d] = acc[d] * inv_l;
    }
    if (lse != nullptr && group == 0) lse[static_cast<long long>(b) * S + qi] = m_all + logf(l);
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

// dK and dV for 32 keys per block, walking all queries in tiles of 64.
template <int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkdv(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int S, float scale, uint32_t seed, uint32_t thresh,
    float inv_keep) {
  constexpr int P = D / kGroups;  // dims per thread
  __shared__ float qs[kTile][D + 1];
  __shared__ float dos[kTile][D + 1];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int b = blockIdx.y;
  const long long base = static_cast<long long>(b) * S * D;
  const int group = threadIdx.x & (kGroups - 1);
  const int kj = blockIdx.x * kRows + (threadIdx.x / kGroups);
  const bool valid = kj < S;
  const bool dropout = thresh != 0u;
  const int d0 = group * P;

  float kr[P], vr[P], dk_acc[P], dv_acc[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const long long off = base + static_cast<long long>(kj) * D + d0 + t;
    kr[t] = valid ? __ldg(k + off) : 0.0f;
    vr[t] = valid ? __ldg(v + off) : 0.0f;
    dk_acc[t] = 0.0f;
    dv_acc[t] = 0.0f;
  }

  for (int q0 = 0; q0 < S; q0 += kTile) {
    const int nq = min(kTile, S - q0);
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int r = i / D;
      const int d = i % D;
      const long long off = base + static_cast<long long>(q0 + r) * D + d;
      qs[r][d] = r < nq ? __ldg(q + off) : 0.0f;
      dos[r][d] = r < nq ? __ldg(dout + off) : 0.0f;
    }
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      lse_s[r] = r < nq ? __ldg(lse + static_cast<long long>(b) * S + q0 + r) : 0.0f;
      delta_s[r] = r < nq ? __ldg(delta + static_cast<long long>(b) * S + q0 + r) : 0.0f;
    }
    __syncthreads();

    for (int r = 0; r < nq; ++r) {
      float s = 0.0f;
      float dp = 0.0f;
#pragma unroll
      for (int t = 0; t < P; ++t) {
        s = fmaf(qs[r][d0 + t], kr[t], s);
        dp = fmaf(dos[r][d0 + t], vr[t], dp);
      }
      s = group_sum(s);
      dp = group_sum(dp);
      const float p = expf(s * scale - lse_s[r]);
      float mk = 1.0f;
      if (dropout) mk = keep_hash(seed, b, q0 + r, kj) >= thresh ? inv_keep : 0.0f;
      const float pd = p * mk;                       // the probability the forward used
      const float ds = p * (mk * dp - delta_s[r]);   // softmax VJP through the mask
#pragma unroll
      for (int t = 0; t < P; ++t) {
        dv_acc[t] = fmaf(pd, dos[r][d0 + t], dv_acc[t]);
        dk_acc[t] = fmaf(ds, qs[r][d0 + t], dk_acc[t]);
      }
    }
    __syncthreads();
  }

  if (valid) {
#pragma unroll
    for (int t = 0; t < P; ++t) {
      const long long off = base + static_cast<long long>(kj) * D + d0 + t;
      dk[off] = dk_acc[t] * scale;
      dv[off] = dv_acc[t];
    }
  }
}

// dQ for 32 queries per block, walking all keys in tiles of 64.
template <int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int S, float scale, uint32_t seed, uint32_t thresh, float inv_keep) {
  constexpr int P = D / kGroups;
  __shared__ float ks[kTile][D + 1];
  __shared__ float vs[kTile][D + 1];

  const int b = blockIdx.y;
  const long long base = static_cast<long long>(b) * S * D;
  const int group = threadIdx.x & (kGroups - 1);
  const int qi = blockIdx.x * kRows + (threadIdx.x / kGroups);
  const bool valid = qi < S;
  const bool dropout = thresh != 0u;
  const int d0 = group * P;

  float qr[P], dor[P], dq_acc[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const long long off = base + static_cast<long long>(qi) * D + d0 + t;
    qr[t] = valid ? __ldg(q + off) : 0.0f;
    dor[t] = valid ? __ldg(dout + off) : 0.0f;
    dq_acc[t] = 0.0f;
  }
  const float lse_i = valid ? __ldg(lse + static_cast<long long>(b) * S + qi) : 0.0f;
  const float delta_i = valid ? __ldg(delta + static_cast<long long>(b) * S + qi) : 0.0f;

  for (int k0 = 0; k0 < S; k0 += kTile) {
    const int nk = min(kTile, S - k0);
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int r = i / D;
      const int d = i % D;
      const long long off = base + static_cast<long long>(k0 + r) * D + d;
      ks[r][d] = r < nk ? __ldg(k + off) : 0.0f;
      vs[r][d] = r < nk ? __ldg(v + off) : 0.0f;
    }
    __syncthreads();

    for (int j = 0; j < nk; ++j) {
      float s = 0.0f;
      float dp = 0.0f;
#pragma unroll
      for (int t = 0; t < P; ++t) {
        s = fmaf(qr[t], ks[j][d0 + t], s);
        dp = fmaf(dor[t], vs[j][d0 + t], dp);
      }
      s = group_sum(s);
      dp = group_sum(dp);
      const float p = expf(s * scale - lse_i);
      float mk = 1.0f;
      if (dropout) mk = keep_hash(seed, b, qi, k0 + j) >= thresh ? inv_keep : 0.0f;
      const float ds = p * (mk * dp - delta_i);
#pragma unroll
      for (int t = 0; t < P; ++t) dq_acc[t] = fmaf(ds, ks[j][d0 + t], dq_acc[t]);
    }
    __syncthreads();
  }

  if (valid) {
#pragma unroll
    for (int t = 0; t < P; ++t) dq[base + static_cast<long long>(qi) * D + d0 + t] = dq_acc[t] * scale;
  }
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int B, int S, float scale,
               uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, B);
  attention_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(q, k, v, o, lse, S, scale, seed, thresh, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v, const float* o, const float* dout,
               const float* lse, float* delta, float* dq, float* dk, float* dv, int B, int S, float scale,
               uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * S;
  attention_bwd_delta<<<static_cast<unsigned>((rows + 255) / 256), 256, 0, stream>>>(o, dout, delta, rows, D);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid((S + kRows - 1) / kRows, B);
  attention_bwd_dkdv<D><<<grid, kThreads, 0, stream>>>(q, k, v, dout, lse, delta, dk, dv, S, scale, seed, thresh,
                                                       inv_keep);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  attention_bwd_dq<D><<<grid, kThreads, 0, stream>>>(q, k, v, dout, lse, delta, dq, S, scale, seed, thresh,
                                                     inv_keep);
  return static_cast<int>(cudaGetLastError());
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
