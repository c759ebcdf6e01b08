// K5: the tile rasterizer of 3D Gaussian splatting (splatfacto), for sm_90a.
//
// Replaces no TPU kernel: the JAX package's rasterizer is XLA (neuradar_tpu/models/splatfacto.py,
// rasterize): a dense [tiles, G] overlap test, jax.lax.top_k of each tile's scores, and dense
// compositing over [tiles, 256 pixels, K]. The port's plain version (ops/splat.py, render_plain)
// does the same in PyTorch. Here the overlap test runs per gaussian over the tiles near it, and the
// compositing per tile over its own list, which is what gsplat's CUDA rasterizer does; the lists and
// the sums are the JAX package's: a tile lists its K nearest overlapping gaussians (ties to the
// lower index), and every listed gaussian is composited, with no cut at small alpha or at low
// transmittance.
//
// Kernels:
//  * splat_bin_count: a thread a gaussian; counts the tiles it overlaps (the JAX package's circle
//    test: centre distance under radius + TILE_RADIUS, in float32 without fused adds) and adds one
//    to each such tile's count.
//  * splat_bin_emit: the same walk, writing each pair's key (tile << 32 | the depth's float bits,
//    a positive float's bits order as the float does) and its gaussian id at the gaussian's offset,
//    so that a stable sort by key (ops/splat.py) orders pairs by tile, then depth, then id.
//  * splat_raster_fwd: a block a 16 x 16 tile, a thread a pixel. The tile's first min(count, K)
//    sorted ids are loaded 256 at a time into shared memory with their ten features; every thread
//    composites each of them front to back. Writes colour, alpha and depth of the pixels inside the
//    image (the canvas is the image rounded up to whole tiles).
//  * splat_raster_bwd: the same walk, front to back again. A pixel's loss reads
//    sum_k g_k w_k, g_k = dC . c_k + dA + dD d_k and w_k = alpha_k T_k, whose total is
//    dC . C + dA A + dD D from the forward's outputs; so at gaussian k the later ones' part is that
//    total less the running sum, and dalpha_k = g_k T_k - (later) / (1 - alpha_k + 1e-10). (A walk
//    from the back, dividing the transmittance out, would need the transmittance at the end, which
//    underflows to 0 behind 512 opaque gaussians.) The ten gradients of each gaussian are summed
//    over the warp with shuffles, over the block in shared memory, and added once a block to the
//    gaussian's row with float atomics.
//
// What bounds it on the H100: float32 arithmetic. A listed pair costs 256 pixels x about 23
// operations forward and 47 backward (benchmark/harness/splat_count.py counts them), against 48
// bytes of list and features, read once a tile; the forward also evaluates an exp a pixel and pair.
// The backward's warp sums (5 shuffles for each of ten values a gaussian) take as many issue slots
// as its arithmetic.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads a block of the raster kernels
constexpr int kFeats = 10;              // x, y, ia, ib, ic, opacity, r, g, b, depth
constexpr int kBinThreads = 256;

// The tiles whose centre lies within R of (mx, my), clamped to the grid: a superset of those that
// pass the exact test (one tile of margin each way).
__device__ __forceinline__ void tile_rect(float mx, float my, float R, int tw, int th, int& x0, int& x1, int& y0,
                                          int& y1) {
  const float inv = 1.0f / kTile;
  x0 = (int)fmaxf(floorf((mx - R - kTile / 2) * inv) - 1.0f, 0.0f);
  x1 = (int)fminf(ceilf((mx + R - kTile / 2) * inv) + 1.0f, (float)(tw - 1));
  y0 = (int)fmaxf(floorf((my - R - kTile / 2) * inv) - 1.0f, 0.0f);
  y1 = (int)fminf(ceilf((my + R - kTile / 2) * inv) + 1.0f, (float)(th - 1));
}

// The JAX package's test: sum((centre - mean)^2) < (radius + tile_r)^2, float32, no fused adds.
__device__ __forceinline__ bool overlaps(int tx, int ty, float mx, float my, float R2) {
  const float dx = __fsub_rn((float)(tx * kTile) + kTile / 2, mx);
  const float dy = __fsub_rn((float)(ty * kTile) + kTile / 2, my);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < R2;
}

__global__ void __launch_bounds__(kBinThreads)
    bin_count_kernel(const float* __restrict__ feats, const float* __restrict__ radius,
                     const uint8_t* __restrict__ in_view, int G, int tw, int th, float tile_r,
                     int* __restrict__ counts, int* __restrict__ tile_counts) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  int n = 0;
  if (in_view[g]) {
    const float mx = feats[(long long)g * kFeats], my = feats[(long long)g * kFeats + 1];
    const float R = __fadd_rn(radius[g], tile_r);
    const float R2 = __fmul_rn(R, R);
    int x0, x1, y0, y1;
    tile_rect(mx, my, R, tw, th, x0, x1, y0, y1);
    for (int ty = y0; ty <= y1; ++ty)
      for (int tx = x0; tx <= x1; ++tx)
        if (overlaps(tx, ty, mx, my, R2)) {
          ++n;
          atomicAdd(tile_counts + ty * tw + tx, 1);
        }
  }
  counts[g] = n;
}

__global__ void __launch_bounds__(kBinThreads)
    bin_emit_kernel(const float* __restrict__ feats, const float* __restrict__ radius,
                    const uint8_t* __restrict__ in_view, const long long* __restrict__ ends,
                    const int* __restrict__ counts, int G, int tw, int th, float tile_r,
                    long long* __restrict__ keys, int* __restrict__ gids) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G || !in_view[g] || counts[g] == 0) return;
  const float mx = feats[(long long)g * kFeats], my = feats[(long long)g * kFeats + 1];
  const unsigned long long depth_bits = __float_as_uint(feats[(long long)g * kFeats + 9]);
  const float R = __fadd_rn(radius[g], tile_r);
  const float R2 = __fmul_rn(R, R);
  long long at = ends[g] - counts[g];
  int x0, x1, y0, y1;
  tile_rect(mx, my, R, tw, th, x0, x1, y0, y1);
  for (int ty = y0; ty <= y1; ++ty)
    for (int tx = x0; tx <= x1; ++tx)
      if (overlaps(tx, ty, mx, my, R2)) {
        keys[at] = (long long)(((unsigned long long)(ty * tw + tx) << 32) | depth_bits);
        gids[at] = g;
        ++at;
      }
}

// One batch of a tile's list into shared memory: s[f][i] is feature f of the batch's i-th gaussian.
__device__ __forceinline__ void load_batch(const float* __restrict__ feats, const int* __restrict__ gids,
                                           long long at, int m, float (*s)[kPixels], int* sid) {
  const int i = threadIdx.x;
  if (i < m) {
    const int g = gids[at + i];
    sid[i] = g;
    const float* row = feats + (long long)g * kFeats;
#pragma unroll
    for (int f = 0; f < kFeats; ++f) s[f][i] = row[f];
  }
}

__global__ void __launch_bounds__(kPixels)
    splat_raster_fwd_kernel(const float* __restrict__ feats, const int* __restrict__ gids,
                            const long long* __restrict__ tile_start, const int* __restrict__ tile_counts,
                            int K, int tw, int out_w, int out_h, float* __restrict__ color,
                            float* __restrict__ alpha_out, float* __restrict__ depth_out) {
  __shared__ float s[kFeats][kPixels];
  __shared__ int sid[kPixels];
  const int t = blockIdx.x;
  const int px = (t % tw) * kTile + (threadIdx.x & (kTile - 1));
  const int py = (t / tw) * kTile + (threadIdx.x / kTile);
  const float fx = (float)px + 0.5f, fy = (float)py + 0.5f;
  const int n = min(tile_counts[t], K);
  const long long start = tile_start[t];
  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, acc = 0.0f, dep = 0.0f;
  for (int b = 0; b < n; b += kPixels) {
    const int m = min(kPixels, n - b);
    __syncthreads();
    load_batch(feats, gids, start + b, m, s, sid);
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const float dx = fx - s[0][k], dy = fy - s[1][k];
      const float power = -0.5f * (s[2][k] * dx * dx + 2.0f * s[3][k] * dx * dy + s[4][k] * dy * dy);
      const float a = fminf(fmaxf(s[5][k] * expf(fminf(power, 0.0f)), 0.0f), 0.999f);
      const float w = a * T;
      c0 += w * s[6][k];
      c1 += w * s[7][k];
      c2 += w * s[8][k];
      acc += w;
      dep += w * s[9][k];
      T *= (1.0f - a) + 1e-10f;
    }
  }
  if (px < out_w && py < out_h) {
    const long long o = (long long)py * out_w + px;
    color[3 * o] = c0;
    color[3 * o + 1] = c1;
    color[3 * o + 2] = c2;
    alpha_out[o] = acc;
    depth_out[o] = dep;
  }
}

__global__ void __launch_bounds__(kPixels)
    splat_raster_bwd_kernel(const float* __restrict__ feats, const int* __restrict__ gids,
                            const long long* __restrict__ tile_start, const int* __restrict__ tile_counts,
                            int K, int tw, int out_w, int out_h, const float* __restrict__ color,
                            const float* __restrict__ alpha_out, const float* __restrict__ depth_out,
                            const float* __restrict__ dcolor, const float* __restrict__ dalpha,
                            const float* __restrict__ ddepth, float* __restrict__ dfeats) {
  __shared__ float s[kFeats][kPixels];
  __shared__ float sacc[kFeats][kPixels];
  __shared__ int sid[kPixels];
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int px = (t % tw) * kTile + (threadIdx.x & (kTile - 1));
  const int py = (t / tw) * kTile + (threadIdx.x / kTile);
  const float fx = (float)px + 0.5f, fy = (float)py + 0.5f;
  // pixels past the image are cropped: their upstream gradients are zero
  float dC0 = 0.0f, dC1 = 0.0f, dC2 = 0.0f, dA = 0.0f, dD = 0.0f, total = 0.0f;
  if (px < out_w && py < out_h) {
    const long long o = (long long)py * out_w + px;
    dC0 = dcolor[3 * o];
    dC1 = dcolor[3 * o + 1];
    dC2 = dcolor[3 * o + 2];
    dA = dalpha[o];
    dD = ddepth[o];
    total = dC0 * color[3 * o] + dC1 * color[3 * o + 1] + dC2 * color[3 * o + 2] + dA * alpha_out[o] +
            dD * depth_out[o];
  }
  const int n = min(tile_counts[t], K);
  const long long start = tile_start[t];
  float T = 1.0f, done = 0.0f;  // transmittance, and sum of g_k w_k so far
  for (int b = 0; b < n; b += kPixels) {
    const int m = min(kPixels, n - b);
    __syncthreads();
    load_batch(feats, gids, start + b, m, s, sid);
#pragma unroll
    for (int f = 0; f < kFeats; ++f) sacc[f][threadIdx.x] = 0.0f;
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const float ia = s[2][k], ib = s[3][k], ic = s[4][k], op = s[5][k];
      const float dx = fx - s[0][k], dy = fy - s[1][k];
      const float power = -0.5f * (ia * dx * dx + 2.0f * ib * dx * dy + ic * dy * dy);
      const float e = expf(fminf(power, 0.0f));
      const float raw = op * e;
      const float a = fminf(fmaxf(raw, 0.0f), 0.999f);
      const float w = a * T;
      const float gk = dC0 * s[6][k] + dC1 * s[7][k] + dC2 * s[8][k] + dA + dD * s[9][k];
      done += gk * w;
      const float fac = (1.0f - a) + 1e-10f;
      const float da = gk * T - (total - done) / fac;
      const float draw = (raw > 0.0f && raw < 0.999f) ? da : 0.0f;
      const float dpower = power < 0.0f ? draw * op * e : 0.0f;
      float v[kFeats];
      v[0] = dpower * (ia * dx + ib * dy);  // d mean x: -d dx, d dx = -dpower (ia dx + ib dy)
      v[1] = dpower * (ib * dx + ic * dy);
      v[2] = -0.5f * dpower * dx * dx;
      v[3] = -dpower * dx * dy;
      v[4] = -0.5f * dpower * dy * dy;
      v[5] = draw * e;
      v[6] = w * dC0;
      v[7] = w * dC1;
      v[8] = w * dC2;
      v[9] = w * dD;
      T *= fac;
#pragma unroll
      for (int f = 0; f < kFeats; ++f) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v[f] += __shfl_xor_sync(0xffffffffu, v[f], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kFeats; ++f) atomicAdd(&sacc[f][k], v[f]);
      }
    }
    __syncthreads();
    if (threadIdx.x < m) {
      float* row = dfeats + (long long)sid[threadIdx.x] * kFeats;
#pragma unroll
      for (int f = 0; f < kFeats; ++f) atomicAdd(row + f, sacc[f][threadIdx.x]);
    }
  }
}

inline int blocks(long long n, int threads) { return (int)((n + threads - 1) / threads); }

}  // namespace

extern "C" {

int splat_bin_count(const float* feats, const float* radius, const uint8_t* in_view, int G, int tw, int th,
                    float tile_r, int* counts, int* tile_counts, cudaStream_t stream) {
  if (G > 0)
    bin_count_kernel<<<blocks(G, kBinThreads), kBinThreads, 0, stream>>>(feats, radius, in_view, G, tw, th, tile_r,
                                                                          counts, tile_counts);
  return (int)cudaGetLastError();
}

int splat_bin_emit(const float* feats, const float* radius, const uint8_t* in_view, const long long* ends,
                   const int* counts, int G, int tw, int th, float tile_r, long long* keys, int* gids,
                   cudaStream_t stream) {
  if (G > 0)
    bin_emit_kernel<<<blocks(G, kBinThreads), kBinThreads, 0, stream>>>(feats, radius, in_view, ends, counts, G, tw,
                                                                         th, tile_r, keys, gids);
  return (int)cudaGetLastError();
}

int splat_raster_fwd(const float* feats, const int* gids, const long long* tile_start, const int* tile_counts,
                     int T, int K, int tw, int out_w, int out_h, float* color, float* alpha, float* depth,
                     cudaStream_t stream) {
  if (T > 0)
    splat_raster_fwd_kernel<<<T, kPixels, 0, stream>>>(feats, gids, tile_start, tile_counts, K, tw, out_w, out_h,
                                                       color, alpha, depth);
  return (int)cudaGetLastError();
}

int splat_raster_bwd(const float* feats, const int* gids, const long long* tile_start, const int* tile_counts,
                     int T, int K, int tw, int out_w, int out_h, const float* color, const float* alpha,
                     const float* depth, const float* dcolor, const float* dalpha, const float* ddepth,
                     float* dfeats, cudaStream_t stream) {
  if (T > 0)
    splat_raster_bwd_kernel<<<T, kPixels, 0, stream>>>(feats, gids, tile_start, tile_counts, K, tw, out_w, out_h,
                                                       color, alpha, depth, dcolor, dalpha, ddepth, dfeats);
  return (int)cudaGetLastError();
}

}  // extern "C"
