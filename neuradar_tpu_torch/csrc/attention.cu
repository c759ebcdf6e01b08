// K2 forward: softmax(q k^T * D^-1/2) v without writing the scores out, for sm_90a.
//
// Replaces the TPU kernel `_fwd_kernel` reached through
// `fused_self_attention` -> `_fwd_call` (ops/attention.py of the JAX package), at
// dropout rate 0 (the render path runs the radar encoder at eval). q, k, v
// and the output are [B, S, D] float32, B = scans x heads.
//
// What bounds it on the H100: compute and latency. At the radar encoder's
// shape (S = 3,531 rays, D = 48) each scan does 2*S*S*D multiply-adds over
// inputs of only 3*S*D floats, and D = 48 is too narrow to keep many
// independent multiply-adds in flight per thread.
//
// Design (flash-attention style, no tensor cores yet): one block of 128
// threads per (scan, tile of 32 queries). Four threads share a query; each
// takes every fourth key of a 64-key tile, so a block keeps 4 warps busy and
// the grid holds B * ceil(S / 32) blocks. Key and value tiles are staged in
// shared memory with a row pitch of D + 1 floats, which puts the four key
// groups of a warp on different banks. Each thread keeps an online-softmax
// running max and sum and its [D] accumulator in registers, all float32; the
// four partial states of a query are merged with warp shuffles at the end.
// The ragged key tail is masked inside the kernel (no padding outside).
//
// Measured limit of this design: every multiply-add reads its operand from
// shared memory, so the shared-memory pipe, not the FMA units, sets the pace
// (float4 reads did not help: a 128-bit warp load costs four such cycles).
// Register blocking (several queries x keys per thread) is the next step.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroups = 4;                      // threads per query
constexpr int kQueries = kThreads / kGroups;    // queries per block
constexpr int kKeys = 64;                       // keys per shared-memory tile
constexpr int kKeysPerThread = kKeys / kGroups;

template <int D>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(const float* __restrict__ q,
                                                                 const float* __restrict__ k,
                                                                 const float* __restrict__ v,
                                                                 float* __restrict__ out, int S, float scale) {
  __shared__ float ks[kKeys][D + 1];
  __shared__ float vs[kKeys][D + 1];

  const long long base = static_cast<long long>(blockIdx.y) * S * D;
  const int group = threadIdx.x & (kGroups - 1);
  const int qi = blockIdx.x * kQueries + (threadIdx.x / kGroups);
  const bool valid = qi < S;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = valid ? __ldg(q + base + static_cast<long long>(qi) * D + d) * scale : 0.0f;
    acc[d] = 0.0f;
  }
  float m = -CUDART_INF_F;
  float l = 0.0f;

  for (int k0 = 0; k0 < S; k0 += kKeys) {
    const int nk = min(kKeys, S - k0);
    // stage the tile: float4 reads from device memory, zero rows past S
    for (int i = threadIdx.x; i < kKeys * D / 4; i += kThreads) {
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
        l += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
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
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int B, int S, float scale,
           cudaStream_t stream) {
  const dim3 grid((S + kQueries - 1) / kQueries, B);
  attention_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(q, k, v, o, S, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t code; cudaErrorInvalidValue for a head width it was not built for.
extern "C" int self_attention_fwd(const void* q, const void* k, const void* v, void* out, int B, int S, int D,
                                  float scale, void* stream) {
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(qf, kf, vf, of, B, S, scale, st);
    case 32: return launch<32>(qf, kf, vf, of, B, S, scale, st);
    case 48: return launch<48>(qf, kf, vf, of, B, S, scale, st);
    case 64: return launch<64>(qf, kf, vf, of, B, S, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
