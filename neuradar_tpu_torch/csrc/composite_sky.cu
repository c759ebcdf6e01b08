// K1 forward: volume compositing with sky redistribution, for sm_90a.
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

}  // namespace

extern "C" int composite_sky_fwd(const void* alpha, const void* feats, void* w_sky, void* features, void* accum,
                                 int R, int S, int C, void* stream) {
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  composite_sky_fwd_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alpha), static_cast<const float*>(feats), static_cast<float*>(w_sky),
      static_cast<float*>(features), static_cast<float*>(accum), R, S, C);
  return static_cast<int>(cudaGetLastError());
}
