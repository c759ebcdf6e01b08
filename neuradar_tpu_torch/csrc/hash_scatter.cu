// K4 backward: the hash tables' gradient scatter of one hash-grid encode, for sm_90a.
//
// Replaces no TPU kernel: the JAX package's hash encode is XLA, whose backward adds every corner's
// gradient into one table gradient (neuradar_tpu/field_components/encodings.py, _hash_encode_bwd,
// d_table.at[eidx].add(upd)). The port's plain version (ops/hash_scatter.py,
// hash_scatter_reference) does what autograd does for 2^d separate gathers: a zero table a corner,
// torch's accumulating index put into it (a sort by index, then a walk of each run of equal
// indices), and the sum of the corner tables.
//
// What bounds it on the H100: memory. Every contribution reads one int64 index and one row of F
// gradient values once, and the encode writes its table gradient once; the adds themselves are
// float32 atomics in the L2. The table rows they hit are random, and a coarse level's few rows take
// thousands of adds each.
//
// Design: one launch covers every corner of an encode for a group of levels. A thread takes one
// (point, level) pair, loads its 2^d indices and gradient rows (streamed: each is read once, so
// they are loaded evict-first and leave the L2 to the accumulator), and adds each row into a float32
// accumulator with one vector atomic (red of 4 or 2 floats on sm_90, where the row and the pointers
// allow; else one float at a time). Consecutive threads take consecutive pairs, so the loads of a
// warp are coalesced wherever a group holds every level. A row of exact zeros (+0 or -0) is skipped
// before its atomic: adding a zero to a float32 sum that starts at +0 changes no bit, so this does
// the same arithmetic, minus the adds that cannot change it (an actor grid's samples outside every
// box, and ray samples whose weight is zero, give such rows).
//
// Hot rows: a ray's consecutive samples share cells, most of all at the coarse levels, so a row can
// take many atomics one after another in the L2. The lanes still add one by one: combining a warp's
// equal rows first (__match_any_sync and a tree of shuffles) took the field's static grid from 5.38 to
// 1.94 ms an encode on a neuradar train step's own contributions (H100), but a step was no faster end
// to end, since the host sets it, and on scattered samples combining cost 2.5-3x.
//
// The card's float32 atomic adds flush a subnormal input or result to zero (PTX's atom.add.f32), so
// a contribution or a sum under 2^-126 in magnitude reads as zero; the plain version keeps it.
//
// bf16 tables: no bf16 atomics (each add would round); the sum is float32 and rounds once, when
// the accumulator is written into the bf16 gradient. The accumulator covers the group's levels only
// (ops/hash_scatter.py sizes the groups), is zeroed here and is wholly converted, so every element
// of the gradient is written once and no zero-filled table is made. float32 tables: the gradient is
// the accumulator itself, zeroed here.
//
// An index outside the group's rows is skipped: the scratch is never written out of bounds.
// hash_encode's indices (hash & (T - 1) plus the level's offset) always lie in their level's rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // threads a block of the scatter
constexpr int kMaxCorners = 16;    // 2^d for d <= 4
constexpr int kConvThreads = 256;  // threads a block of the conversion

// Each corner's gradient [N, L, F] (float32 or bf16) and indices [N, L] (int64, rows of the whole
// table): passed by value, so the launch needs no copy of pointers to the card.
struct Corners {
  const void* grad[kMaxCorners];
  const long long* idx[kMaxCorners];
};

// V gradient values of row element e * F + j, as floats.
template <int V, bool kBf16>
__device__ __forceinline__ void load_row(const void* base, long long at, float (&v)[V]);

template <>
__device__ __forceinline__ void load_row<1, false>(const void* base, long long at, float (&v)[1]) {
  v[0] = __ldcs(static_cast<const float*>(base) + at);
}
template <>
__device__ __forceinline__ void load_row<2, false>(const void* base, long long at, float (&v)[2]) {
  const float2 x = __ldcs(reinterpret_cast<const float2*>(static_cast<const float*>(base) + at));
  v[0] = x.x;
  v[1] = x.y;
}
template <>
__device__ __forceinline__ void load_row<4, false>(const void* base, long long at, float (&v)[4]) {
  const float4 x = __ldcs(reinterpret_cast<const float4*>(static_cast<const float*>(base) + at));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
// a bf16 value is the high half of a float32's bits
__device__ __forceinline__ float bf16_lo(unsigned int u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned int u) { return __uint_as_float(u & 0xffff0000u); }
template <>
__device__ __forceinline__ void load_row<1, true>(const void* base, long long at, float (&v)[1]) {
  v[0] = bf16_lo(__ldcs(static_cast<const unsigned short*>(base) + at));
}
template <>
__device__ __forceinline__ void load_row<2, true>(const void* base, long long at, float (&v)[2]) {
  const unsigned int x = __ldcs(reinterpret_cast<const unsigned int*>(static_cast<const unsigned short*>(base) + at));
  v[0] = bf16_lo(x);
  v[1] = bf16_hi(x);
}
template <>
__device__ __forceinline__ void load_row<4, true>(const void* base, long long at, float (&v)[4]) {
  const uint2 x = __ldcs(reinterpret_cast<const uint2*>(static_cast<const unsigned short*>(base) + at));
  v[0] = bf16_lo(x.x);
  v[1] = bf16_hi(x.x);
  v[2] = bf16_lo(x.y);
  v[3] = bf16_hi(x.y);
}

__device__ __forceinline__ void add_row(float* dst, const float (&v)[1]) { atomicAdd(dst, v[0]); }
__device__ __forceinline__ void add_row(float* dst, const float (&v)[2]) {
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
}
__device__ __forceinline__ void add_row(float* dst, const float (&v)[4]) {
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
}

template <int V>
__device__ __forceinline__ bool nonzero(const float (&v)[V]) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < V; ++k) any |= v[k] != 0.0f;
  return any;
}

// pairs = N * (l1 - l0): pair p is point p / Lg at level l0 + p % Lg. acc holds the group's rows
// [row0, row0 + rows) of F floats each.
template <int C, int V, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    hash_scatter_kernel(Corners corners, float* __restrict__ acc, long long pairs, int Lg, int L, int l0, int F,
                        long long row0, long long rows) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= pairs) return;
  const long long n = p / Lg;
  const long long e = n * L + l0 + (p - n * Lg);  // the pair's element of idx [N, L]
  long long row[C];
#pragma unroll
  for (int c = 0; c < C; ++c) row[c] = __ldcs(corners.idx[c] + e) - row0;
  for (int j = 0; j < F; j += V) {
    float v[C][V];
#pragma unroll
    for (int c = 0; c < C; ++c) load_row<V, kBf16>(corners.grad[c], e * F + j, v[c]);
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (nonzero<V>(v[c]) && row[c] >= 0 && row[c] < rows) add_row(acc + row[c] * F + j, v[c]);
  }
}

__global__ void __launch_bounds__(kConvThreads)
    to_bf16_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kConvThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kConvThreads + threadIdx.x; i < n; i += stride)
    out[i] = __float2bfloat16_rn(__ldcs(acc + i));
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<std::uintptr_t>(p) % bytes == 0; }

template <int C, int V, bool kBf16>
void launch_scatter(const Corners& corners, float* acc, long long pairs, int Lg, int L, int l0, int F, long long row0,
                    long long rows, cudaStream_t s) {
  const long long blocks = (pairs + kThreads - 1) / kThreads;
  hash_scatter_kernel<C, V, kBf16>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(corners, acc, pairs, Lg, L, l0, F, row0, rows);
}

template <int C, bool kBf16>
void dispatch_width(const Corners& corners, int V, float* acc, long long pairs, int Lg, int L, int l0, int F,
                    long long row0, long long rows, cudaStream_t s) {
  if (V == 4) {
    launch_scatter<C, 4, kBf16>(corners, acc, pairs, Lg, L, l0, F, row0, rows, s);
  } else if (V == 2) {
    launch_scatter<C, 2, kBf16>(corners, acc, pairs, Lg, L, l0, F, row0, rows, s);
  } else {
    launch_scatter<C, 1, kBf16>(corners, acc, pairs, Lg, L, l0, F, row0, rows, s);
  }
}

template <bool kBf16>
int dispatch_corners(const Corners& corners, int C, int V, float* acc, long long pairs, int Lg, int L, int l0, int F,
                     long long row0, long long rows, cudaStream_t s) {
  switch (C) {
    case 2: dispatch_width<2, kBf16>(corners, V, acc, pairs, Lg, L, l0, F, row0, rows, s); return 0;
    case 4: dispatch_width<4, kBf16>(corners, V, acc, pairs, Lg, L, l0, F, row0, rows, s); return 0;
    case 8: dispatch_width<8, kBf16>(corners, V, acc, pairs, Lg, L, l0, F, row0, rows, s); return 0;
    case 16: dispatch_width<16, kBf16>(corners, V, acc, pairs, Lg, L, l0, F, row0, rows, s); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The gradient of levels [l0, l1) of a table of L levels of T rows of F values, from the 2^d
// (``corners``) gradients [N, L, F] and indices [N, L] of one encode. ``acc``: float32, (l1 - l0) * T * F
// values; it is zeroed, then every contribution of those levels is added into it. bf16 gradients
// (``bf16`` 1): acc is then rounded into ``out``, the bf16 table gradient's rows of those levels.
// float32 gradients: acc is those rows of the gradient itself and ``out`` is unused.
extern "C" int hash_scatter(const void* const* grads, const void* const* idx, int corners, long long N, int L, int F,
                            long long T, int l0, int l1, int bf16, void* acc, void* out, void* stream) {
  if (corners < 1 || corners > kMaxCorners || l0 < 0 || l1 > L || l0 >= l1 || F < 1 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(l1 - l0) * T;
  float* accf = static_cast<float*>(acc);
  cudaError_t err = cudaMemsetAsync(acc, 0, static_cast<size_t>(rows) * F * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Corners c{};
  const int elem = bf16 ? 2 : 4;
  // the widest row vector that F and every pointer allow
  int V = F % 4 == 0 ? 4 : (F % 2 == 0 ? 2 : 1);
  for (int k = 0; k < corners; ++k) {
    c.grad[k] = grads[k];
    c.idx[k] = static_cast<const long long*>(idx[k]);
  }
  while (V > 1) {
    bool ok = aligned(acc, V * 4);
    for (int k = 0; k < corners; ++k) ok = ok && aligned(grads[k], V * elem);
    if (ok) break;
    V /= 2;
  }
  const long long pairs = N * (l1 - l0);
  if (pairs > 0) {
    const long long row0 = static_cast<long long>(l0) * T;
    const int code = bf16 ? dispatch_corners<true>(c, corners, V, accf, pairs, l1 - l0, L, l0, F, row0, rows, s)
                          : dispatch_corners<false>(c, corners, V, accf, pairs, l1 - l0, L, l0, F, row0, rows, s);
    if (code != 0) return code;
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (bf16) {
    const long long n = rows * F;
    const long long blocks = (n + kConvThreads - 1) / kConvThreads;
    const unsigned int grid = static_cast<unsigned int>(blocks < 65535 * 8 ? blocks : 65535 * 8);
    to_bf16_kernel<<<grid, kConvThreads, 0, s>>>(accf, static_cast<__nv_bfloat16*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
