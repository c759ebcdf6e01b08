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

#include <cstdint>

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
// What bounds it: memory. The feats read and the dfeats write are R*S*C*4
// bytes each, the rest is ~1/16 of that; the arithmetic is a few operations
// per byte. At R = 113,840, S = 33, C = 32 the bound is ~0.305 ms at 3.35 TB/s, the
// data-sheet memory rate of an NVIDIA H100 80GB HBM3 at 700.00 W.
//
// Design (the float4 path: S <= 64, C a multiple of 4 up to 128, feats, df
// and dfeats 16-byte aligned). One warp per ray.
// - Lane = sample for every per-sample scalar: lane l holds samples l and
//   l + 32. The exclusive transmittance is a warp product scan by shuffles
//   (the upper half carried on the lower half's total), accum a warp sum, and
//   the suffix sum_{k>i} dw[k] w[k] a reverse warp sum scan; dalpha is stored
//   as coalesced rows. No shared memory, no serial pass over S.
// - The feats and dfeats rows move as float4s: L lanes per row (the smallest
//   power of two >= C/4), so one warp instruction covers 32/L samples (4 at
//   C = 32). Every feats load of a tile of up to 16 instructions (the whole
//   ray at S <= 64, C = 32) is issued before any is used, together with df,
//   alpha and dwsky, so a warp keeps every row of the ray in flight where a
//   serial loop kept one. df stays in registers for the ray. Each row's dot product with
//   df is log2(L) xor shuffles, and one more shuffle hands G[s] to the lane
//   that owns sample s; w_sky[s] comes back the same way for the dfeats row,
//   which is written with streaming stores (nothing reads it back here).
// The general path (any S up to 768, any C, any alignment) keeps the same
// per-sample arithmetic in the same order, in chunks of 32 samples whose scans
// carry the running product and the suffix sum; the feats rows go one float
// a lane, lane = channel, with G and T held in shared memory between passes.
// Both are deterministic: no atomics, every sum in a fixed order.

constexpr unsigned kFull = 0xffffffffu;

// inclusive product of x over lanes 0..lane (Hillis-Steele, 5 shuffles)
__device__ __forceinline__ float warp_scan_mul(float x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x *= y;
  }
  return x;
}

// inclusive sum of x over lanes lane..31
__device__ __forceinline__ float warp_rscan_add(float x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(kFull, x, off);
    if (lane + off < 32) x += y;
  }
  return x;
}

// sum over the warp, the same bits on every lane
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int L>  // lanes per feats row: the smallest power of two >= C / 4
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    composite_sky_bwd_float4_kernel(const float* __restrict__ alpha, const float4* __restrict__ feats,
                                    const float* __restrict__ dwsky, const float4* __restrict__ df,
                                    const float* __restrict__ daccum, float* __restrict__ dalpha,
                                    float4* __restrict__ dfeats, int R, int S, int C4) {
  constexpr int P = 32 / L;                 // samples per warp instruction
  constexpr int U = 2 * L < 16 ? 2 * L : 16;  // instructions whose loads are in flight together
  const int lane = threadIdx.x & 31;
  const long long ray = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ray >= R) return;
  const int j = lane / L, c4 = lane % L;  // this lane's row within an instruction, and its float4 of the row
  const bool c_ok = c4 < C4;
  const int K = (S + P - 1) / P;  // instructions that cover the ray's S rows
  const float4* f = feats + ray * S * C4;
  float4* dfe = dfeats + ray * S * C4;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // every load first: df, the first tile of feats rows, then the per-sample scalars
  const float4 d = c_ok ? __ldg(df + ray * C4 + c4) : zero;
  float4 x[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int s = u * P + j;
    x[u] = c_ok && s < S ? __ldg(f + s * C4 + c4) : zero;
  }
  const float* a = alpha + ray * S;
  const float* gw = dwsky + ray * S;
  const bool v_lo = lane < S, v_hi = lane + 32 < S;
  const float a_lo = v_lo ? __ldg(a + lane) : 0.0f, a_hi = v_hi ? __ldg(a + 32 + lane) : 0.0f;
  const float gw_lo = v_lo ? __ldg(gw + lane) : 0.0f, gw_hi = v_hi ? __ldg(gw + 32 + lane) : 0.0f;
  const float da = __ldg(daccum + ray);

  // lane = sample: T by product scans, w, accum, w_sky
  const float om_lo = 1.0f - a_lo + kEps, om_hi = 1.0f - a_hi + kEps;
  const float in_lo = warp_scan_mul(om_lo, lane), in_hi = warp_scan_mul(om_hi, lane);
  float t_lo = __shfl_up_sync(kFull, in_lo, 1), ex_hi = __shfl_up_sync(kFull, in_hi, 1);
  if (lane == 0) t_lo = ex_hi = 1.0f;
  const float t_hi = __shfl_sync(kFull, in_lo, 31) * ex_hi;
  const float w_lo = a_lo * t_lo, w_hi = a_hi * t_hi;
  const float acc = warp_sum(w_lo + w_hi);
  float ws_lo = w_lo, ws_hi = w_hi;
  if (lane == ((S - 1) & 31)) {
    if (S - 1 < 32) ws_lo = (w_lo + 1.0f) - acc;
    else ws_hi = (w_hi + 1.0f) - acc;
  }

  // the rows: dfeats = w_sky * df, and sum_c feats * df handed to the sample's lane
  float g_lo = 0.0f, g_hi = 0.0f;
  for (int k0 = 0; k0 < K; k0 += U) {
    if (k0 > 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = (k0 + u) * P + j;
        x[u] = c_ok && s < S ? __ldg(f + s * C4 + c4) : zero;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u;
      if (k >= K) break;
      const int s = k * P + j;
      const bool lo = k * P < 32;  // an instruction's P samples lie in one half: P divides 32
      const float w = __shfl_sync(kFull, lo ? ws_lo : ws_hi, s & 31);
      if (c_ok && s < S) __stcs(dfe + s * C4 + c4, make_float4(w * d.x, w * d.y, w * d.z, w * d.w));
      float p = x[u].x * d.x + x[u].y * d.y + x[u].z * d.z + x[u].w * d.w;
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) p += __shfl_xor_sync(kFull, p, off);
      // sample k*P + i lies on lanes i*L .. i*L + L-1; its owner is lane (k*P + i) & 31
      const float g = __shfl_sync(kFull, p, (lane % P) * L);
      if (lane / P == k % (32 / P)) {
        if (lo) g_lo = g;
        else g_hi = g;
      }
    }
  }

  // lane = sample: dw, the suffix sums by reverse scans, dalpha as coalesced rows
  const float G_lo = gw_lo + g_lo, G_hi = gw_hi + g_hi;
  const float g_last = __shfl_sync(kFull, S - 1 < 32 ? G_lo : G_hi, (S - 1) & 31);
  const float dw_lo = (lane < S - 1 ? G_lo - g_last : 0.0f) + da;
  const float dw_hi = (lane + 32 < S - 1 ? G_hi - g_last : 0.0f) + da;
  const float in2_lo = warp_rscan_add(v_lo ? dw_lo * w_lo : 0.0f, lane);
  const float in2_hi = warp_rscan_add(v_hi ? dw_hi * w_hi : 0.0f, lane);
  float su_lo = __shfl_down_sync(kFull, in2_lo, 1), su_hi = __shfl_down_sync(kFull, in2_hi, 1);
  if (lane == 31) su_lo = su_hi = 0.0f;
  su_lo += __shfl_sync(kFull, in2_hi, 0);
  float* out = dalpha + ray * S;
  if (v_lo) out[lane] = dw_lo * t_lo - su_lo / om_lo;
  if (v_hi) out[32 + lane] = dw_hi * t_hi - su_hi / om_hi;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    composite_sky_bwd_general_kernel(const float* __restrict__ alpha, const float* __restrict__ feats,
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

  // lane = sample, 32 at a time: T carried across chunks, accum
  float carry = 1.0f, acc = 0.0f;
  for (int c0 = 0; c0 < S; c0 += 32) {
    const int s = c0 + lane;
    const float al = s < S ? __ldg(a + s) : 0.0f;
    const float in = warp_scan_mul(1.0f - al + kEps, lane);
    float ex = __shfl_up_sync(kFull, in, 1);
    if (lane == 0) ex = 1.0f;
    const float t = carry * ex;
    if (s < S) T[s] = t;
    acc += al * t;
    carry *= __shfl_sync(kFull, in, 31);
  }
  acc = warp_sum(acc);
  __syncwarp();

  // lane = channel, sample by sample: dfeats and G
  for (int s = 0; s < S; ++s) {
    float w = __ldg(a + s) * T[s];
    if (s == S - 1) w = (w + 1.0f) - acc;
    float part = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float dfc = __ldg(d_f + c);
      part += __ldg(f + static_cast<long long>(s) * C + c) * dfc;
      dfe[static_cast<long long>(s) * C + c] = w * dfc;
    }
    part = warp_sum(part);
    if (lane == 0) G[s] = __ldg(g_out + s) + part;
  }
  __syncwarp();

  // lane = sample, last chunk first: the suffix carried across chunks, dalpha
  const float g_last = G[S - 1];
  const float da = __ldg(daccum + ray);
  float carry_s = 0.0f;
  for (int c0 = (S - 1) & ~31; c0 >= 0; c0 -= 32) {
    const int s = c0 + lane;
    const bool ok = s < S;
    const float al = ok ? __ldg(a + s) : 0.0f;
    const float t = ok ? T[s] : 0.0f;
    const float dw = (s < S - 1 ? G[s] - g_last : 0.0f) + da;
    const float in = warp_rscan_add(ok ? dw * (al * t) : 0.0f, lane);
    float su = __shfl_down_sync(kFull, in, 1);
    if (lane == 31) su = 0.0f;
    su += carry_s;
    if (ok) dalpha[ray * S + s] = dw * t - su / (1.0f - al + kEps);
    carry_s += __shfl_sync(kFull, in, 0);
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

namespace {

// The float4 path's limits (ops/volumetric.py holds the same)
constexpr int kMaxFloat4Samples = 64;
constexpr int kMaxFloat4Channels = 128;
// The general path's shared memory per block: two [S] float rows per warp; S up to kMaxBwdSamples.
constexpr int kMaxBwdSamples = 768;

template <int L>
void launch_bwd_float4(const void* alpha, const void* feats, const void* dwsky, const void* df, const void* daccum,
                       void* dalpha, void* dfeats, int R, int S, int C, cudaStream_t stream) {
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  composite_sky_bwd_float4_kernel<L><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const float*>(alpha), static_cast<const float4*>(feats), static_cast<const float*>(dwsky),
      static_cast<const float4*>(df), static_cast<const float*>(daccum), static_cast<float*>(dalpha),
      static_cast<float4*>(dfeats), R, S, C / 4);
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// K1 backward, the float4 path; refuses (cudaErrorInvalidValue) what only the general path takes
extern "C" int composite_sky_bwd(const void* alpha, const void* feats, const void* dwsky, const void* df,
                                 const void* daccum, void* dalpha, void* dfeats, int R, int S, int C, void* stream) {
  if (S < 1 || S > kMaxFloat4Samples || C < 4 || C > kMaxFloat4Channels || C % 4 != 0 || !aligned16(feats) ||
      !aligned16(df) || !aligned16(dfeats))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c4 = C / 4;
  if (c4 <= 1) launch_bwd_float4<1>(alpha, feats, dwsky, df, daccum, dalpha, dfeats, R, S, C, s);
  else if (c4 <= 2) launch_bwd_float4<2>(alpha, feats, dwsky, df, daccum, dalpha, dfeats, R, S, C, s);
  else if (c4 <= 4) launch_bwd_float4<4>(alpha, feats, dwsky, df, daccum, dalpha, dfeats, R, S, C, s);
  else if (c4 <= 8) launch_bwd_float4<8>(alpha, feats, dwsky, df, daccum, dalpha, dfeats, R, S, C, s);
  else if (c4 <= 16) launch_bwd_float4<16>(alpha, feats, dwsky, df, daccum, dalpha, dfeats, R, S, C, s);
  else launch_bwd_float4<32>(alpha, feats, dwsky, df, daccum, dalpha, dfeats, R, S, C, s);
  return static_cast<int>(cudaGetLastError());
}

// K1 backward, the general path: 1 <= S <= kMaxBwdSamples, any C, any alignment
extern "C" int composite_sky_bwd_general(const void* alpha, const void* feats, const void* dwsky, const void* df,
                                         const void* daccum, void* dalpha, void* dfeats, int R, int S, int C,
                                         void* stream) {
  if (S < 1 || S > kMaxBwdSamples) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * 2 * S * sizeof(float);
  composite_sky_bwd_general_kernel<<<blocks, kWarpsPerBlock * 32, smem, static_cast<cudaStream_t>(stream)>>>(
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
