// K1: volume compositing with sky redistribution, forward and backward, for sm_90a;
// and K3, the same compositing without the sky sample, forward only (below).
//
// Replaces the TPU kernel `_composite_sky_fwd_kernel` reached through
// `fused_composite_sky` -> `_sky_pallas_fwd` (ops/volumetric.py of the JAX package).
// Semantics, per ray r with S samples and C feature channels:
//   T[s]     = prod_{j<s} (1 - alpha[j] + 1e-7)      (exclusive transmittance)
//   w[s]     = alpha[s] * T[s]
//   accum    = sum_s w[s]
//   w_sky[s] = w[s], except w_sky[S-1] = w[S-1] + 1 - accum   (sky sample)
//   feat[c]  = sum_s w_sky[s] * feats[s, c]
//
// What bounds it on the H100: memory. The feats read, R*S*C*4 bytes, is
// ~32x the alpha read and the writes together; the arithmetic is a few
// operations per byte.
//
// Design: one warp per ray, lane = feature channel (C = 32 on the render
// path, so one pass covers the row; wider C loops in steps of 32). A row of
// feats[r, s, :] is then one coalesced 128-byte read per sample. Every lane
// walks the S-step transmittance product itself, in the same order, so all
// lanes hold identical w[s] without shuffles; the alpha row is read with the
// same address by all lanes (one broadcast transaction). The product is
// taken directly: the exp(cumsum(log)) matmul of the TPU kernel was a Mosaic
// limit and is not carried over. Two passes over alpha: the first finds
// accum (needed by the sky sample), the second writes w_sky and accumulates
// the features; the second pass re-reads alpha from L1.
#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-7f;
constexpr int kWarpsPerBlock = 8;

__global__ void composite_sky_fwd_kernel(const float* __restrict__ alpha, const float* __restrict__ feats,
                                         float* __restrict__ w_sky, float* __restrict__ features,
                                         float* __restrict__ accum, int R, int S, int C) {
  const int lane = threadIdx.x & 31;
  const long long ray = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ray >= R) return;
  const float* a = alpha + ray * S;

  float trans = 1.0f;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float al = __ldg(a + s);
    acc += al * trans;
    trans *= 1.0f - al + kEps;
  }

  const float* f = feats + ray * static_cast<long long>(S) * C;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    float out = 0.0f;
    trans = 1.0f;
    for (int s = 0; s < S; ++s) {
      const float al = __ldg(a + s);
      float w = al * trans;
      trans *= 1.0f - al + kEps;
      if (s == S - 1) w = w + 1.0f - acc;
      if (c0 == 0 && (s & 31) == lane) w_sky[ray * S + s] = w;
      if (c < C) out += w * __ldg(f + static_cast<long long>(s) * C + c);
    }
    if (c < C) features[ray * C + c] = out;
  }
  if (lane == 0) accum[ray] = acc;
}

// K1 backward: replaces `_composite_sky_bwd_kernel` reached through
// `fused_composite_sky`'s VJP -> `_sky_pallas_bwd`. Per ray, with g the
// cotangents of (w_sky, feat, accum) = (dwsky [S], df [C], daccum):
//   dfeats[s, c] = w_sky[s] * df[c]
//   G[s]         = dwsky[s] + sum_c feats[s, c] * df[c]
//   dw[s]        = G[s] - G[S-1] + daccum   (s < S-1),   dw[S-1] = daccum
//   dalpha[i]    = dw[i] * T[i] - (sum_{k>i} dw[k] w[k]) / (1 - alpha[i] + 1e-7)
// What bounds it: memory, like the forward: the feats read and the dfeats
// write are R*S*C*4 bytes each, the rest is ~1/16 of that.
// Design: one warp per ray, lane = channel, so both feats[r, s, :] and
// dfeats[r, s, :] are one coalesced 128-byte row per sample. The transmittance
// is recomputed with the forward's direct product in the forward's order (not
// exp(cumsum(log))). G[s] needs a warp reduction per sample; G and T go to the
// warp's slice of shared memory, and a single reverse pass over the samples
// then forms the suffix sum sum_{k>i} dw[k] w[k] (every lane walks it, lane
// i % 32 writes dalpha[i]).
__global__ void composite_sky_bwd_kernel(const float* __restrict__ alpha, const float* __restrict__ feats,
                                         const float* __restrict__ dwsky, const float* __restrict__ df,
                                         const float* __restrict__ daccum, float* __restrict__ dalpha,
                                         float* __restrict__ dfeats, int R, int S, int C) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (ray >= R) return;
  float* G = smem + warp * 2 * S;
  float* T = G + S;
  const float* a = alpha + ray * S;
  const float* f = feats + ray * static_cast<long long>(S) * C;
  float* dfe = dfeats + ray * static_cast<long long>(S) * C;
  const float* g_out = dwsky + ray * S;
  const float* d_f = df + ray * C;

  float trans = 1.0f;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float al = __ldg(a + s);
    acc += al * trans;
    trans *= 1.0f - al + kEps;
  }

  trans = 1.0f;
  for (int s = 0; s < S; ++s) {
    const float al = __ldg(a + s);
    float w = al * trans;
    if (lane == 0) T[s] = trans;
    trans *= 1.0f - al + kEps;
    if (s == S - 1) w = w + 1.0f - acc;
    float part = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float dfc = __ldg(d_f + c);
      part += __ldg(f + static_cast<long long>(s) * C + c) * dfc;
      dfe[static_cast<long long>(s) * C + c] = w * dfc;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) G[s] = __ldg(g_out + s) + part;
  }
  __syncwarp();

  const float da = __ldg(daccum + ray);
  const float g_last = G[S - 1];
  float suffix = 0.0f;
  for (int i = S - 1; i >= 0; --i) {
    const float al = __ldg(a + i);
    const float t = T[i];
    const float dw = (i < S - 1 ? G[i] - g_last : 0.0f) + da;
    if ((i & 31) == lane) dalpha[ray * S + i] = dw * t - suffix / (1.0f - al + kEps);
    suffix += dw * (al * t);
  }
}

// K3: compositing without sky redistribution, forward only. Replaces the TPU
// kernel `_composite_kernel` reached through `fused_composite` (ops/volumetric.py
// of the JAX package). Per ray r with S samples, C channels and sample
// midpoints steps[S]:
//   w[s]    = alpha[s] * prod_{j<s} (1 - alpha[j] + 1e-7)
//   feat[c] = sum_s w[s] * feats[s, c],  depth = sum_s w[s] * steps[s],  accum = sum_s w[s]
// What bounds it: memory, as K1 forward (the feats read is ~30x everything else).
// Design: K1 forward's, one warp per ray and lane = channel, a coalesced
// 128-byte feats row per sample; with no sky sample the accumulation is not
// needed before the features, so one pass over the samples does it all. The
// transmittance is the direct running product (the TPU kernel's
// exp(cumsum(log)) was a Mosaic limit). Every lane walks the product in the
// same order and holds the same w[s]; steps[s] is a broadcast read.
__global__ void composite_fwd_kernel(const float* __restrict__ alpha, const float* __restrict__ feats,
                                     const float* __restrict__ steps, float* __restrict__ weights,
                                     float* __restrict__ features, float* __restrict__ depth,
                                     float* __restrict__ accum, int R, int S, int C) {
  const int lane = threadIdx.x & 31;
  const long long ray = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ray >= R) return;
  const float* a = alpha + ray * S;
  const float* t = steps + ray * S;
  const float* f = feats + ray * static_cast<long long>(S) * C;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    float out = 0.0f, acc = 0.0f, dep = 0.0f, trans = 1.0f;
    for (int s = 0; s < S; ++s) {
      const float al = __ldg(a + s);
      const float w = al * trans;
      trans *= 1.0f - al + kEps;
      if (c0 == 0) {
        if ((s & 31) == lane) weights[ray * S + s] = w;
        acc += w;
        dep += w * __ldg(t + s);
      }
      if (c < C) out += w * __ldg(f + static_cast<long long>(s) * C + c);
    }
    if (c < C) features[ray * C + c] = out;
    if (c0 == 0 && lane == 0) {
      depth[ray] = dep;
      accum[ray] = acc;
    }
  }
}

}  // namespace

extern "C" int composite_fwd(const void* alpha, const void* feats, const void* steps, void* weights, void* features,
                             void* depth, void* accum, int R, int S, int C, void* stream) {
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  composite_fwd_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alpha), static_cast<const float*>(feats), static_cast<const float*>(steps),
      static_cast<float*>(weights), static_cast<float*>(features), static_cast<float*>(depth),
      static_cast<float*>(accum), R, S, C);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory per block: two [S] float rows per warp; S up to kMaxBwdSamples.
constexpr int kMaxBwdSamples = 768;

extern "C" int composite_sky_bwd(const void* alpha, const void* feats, const void* dwsky, const void* df,
                                 const void* daccum, void* dalpha, void* dfeats, int R, int S, int C, void* stream) {
  if (R == 0) return static_cast<int>(cudaGetLastError());
  if (S > kMaxBwdSamples) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * 2 * S * sizeof(float);
  composite_sky_bwd_kernel<<<blocks, kWarpsPerBlock * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alpha), static_cast<const float*>(feats), static_cast<const float*>(dwsky),
      static_cast<const float*>(df), static_cast<const float*>(daccum), static_cast<float*>(dalpha),
      static_cast<float*>(dfeats), R, S, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int composite_sky_fwd(const void* alpha, const void* feats, void* w_sky, void* features, void* accum,
                                 int R, int S, int C, void* stream) {
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  composite_sky_fwd_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alpha), static_cast<const float*>(feats), static_cast<float*>(w_sky),
      static_cast<float*>(features), static_cast<float*>(accum), R, S, C);
  return static_cast<int>(cudaGetLastError());
}
