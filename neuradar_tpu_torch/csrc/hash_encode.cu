// K4: the multiresolution hash-grid encode (Instant-NGP) of one grid, forward and backward, for sm_90a.
//
// Replaces no TPU kernel: the JAX package's hash encode is XLA (neuradar_tpu/field_components/
// encodings.py: _hash_encode_fwd gathers the 2^d corners of every level, _hash_encode_bwd adds their
// gradients into the table with d_table.at[eidx].add). The port's plain version is
// field_components/encodings.hash_encode, a loop over the 2^d cell corners of torch operators, and
// ops/hash_scatter.hash_scatter_reference for the table's gradient.
//
// What bounds it on the H100: memory, and random rows at that. Each (point, level) reads 2^d table
// rows of F values (8 or 16 bytes at most) at hashed addresses; the coarse levels and the small grids
// live in the L2, the fine levels of a 2^22-row grid do not. The arithmetic (a few dozen float32
// operations a corner) is far below the card's rate.
//
// Forward (one launch an encode): a thread takes one (point, level) pair, levels fastest, so a warp's
// output rows are contiguous. It computes the cell and its offsets, issues all 2^d row loads before it
// uses any (the loads are independent, so they are in flight together), and sums the weighted rows.
// The result is the plain path's bit for bit: every operation is the plain path's, in its order, with
// its roundings to the compute type R (the table's dtype, float32 or bf16), and with the _rn
// intrinsics, so that nvcc contracts no multiply and add into an FMA:
//   s = the level's scaling rounded to R (done once, on the host);
//   x = R(p * s), f = floor(x), o = R(x - f), r = R(1 - o);
//   a corner's weight = the product of its d factors (o or r) in axis order, each product rounded to R;
//   a corner's row = (the uint32 hash of f + the corner's bits) & (T - 1), plus the level's first row
//     (uint32 products wrap; the plain path's int64 products have the same low bits);
//   a corner's term = R(row * weight), summed in float32 in corner order 0 .. 2^d - 1, rounded to R,
//   then stored as float32, the positions' dtype.
// Positions are float32, rounded to R here, as the plain path's cast does.
//
// Backward (one launch a group of levels): a thread takes one point and walks the group's levels. It
// recomputes each corner's row and weight from the positions (nothing but the positions is saved), and
//  - adds each corner's gradient row R(R(grad) * weight) into a float32 accumulator of the group's
//    rows with vector atomics (red of 4 or 2 floats; sm_90). A row of exact zeros (+0 or -0) is
//    skipped: adding a zero to a float32 sum that starts at +0 changes no bit. The card's float32
//    atomics flush a subnormal input or result to zero (PTX's atom.add.f32). A bf16 table's gradient
//    is the accumulator rounded once (no bf16 atomics: each add would round); the accumulator covers
//    the group's levels only, is zeroed here and is wholly converted, so every element of the gradient
//    is written once. A float32 table's gradient is the accumulator itself. The groups keep the
//    accumulator under ops/hash_scatter.SCRATCH_FLOATS values (one level of the largest grid);
//  - where the positions need a gradient, reads the 2^d rows too and adds d out / d p: per level and
//    axis i, s * sum over corners of (grad . row) * (+1 or -1) * the product of the other factors,
//    corners in order, levels in order (a level group continues the previous group's sum from a
//    buffer), rounded once to float32 after the last level. The terms cancel (the corners'
//    signs alternate), so it sums in float64: the card's double rate is far above what this memory-bound
//    loop asks of it, and the one rounding is then the only error that counts (float32 sums erred as
//    much as plain autograd's). It takes the gradient as it comes (float32), not rounded to R.
// Hot rows: a ray's samples are consecutive points, so a warp holds 32 neighbouring samples of one ray, and at the
// coarse levels runs of neighbouring lanes lie in one cell: their 2^d corner rows are the same rows, which would
// take one atomic a lane one after another in the L2. So at each level a lane compares its cell with its left
// neighbour's (d shuffles and one ballot: lanes in one cell share every corner row). A warp whose gradient rows at
// the level are all exact zeros adds nothing and skips the level (the actor grids' rows mostly are). Each corner's
// rows are summed over each run in registers (a segmented shuffle-down sum, as many steps as the longest run needs)
// and the run's first lane adds the sum with one atomic, again skipping an exact-zero sum. Where no lane continues a
// run, every run is one lane: the sum takes no step, and each lane adds its own row with one atomic, as above. Any
// order of float32 adds stays within ops/hash_scatter.float64_sum's bound, and the atomics flush no more than one
// subnormal an add. (A general combine of a warp's equal rows, __match_any_sync on every corner of every lane, was
// 2.8x faster on hot rows alone but cost 2.5-3x on scattered rows.) With a stats buffer, each warp counts its
// nonzero contributions and the atomics it issued, so their ratio says how far the run sums engage.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;      // threads a block of the forward and the backward
constexpr int kConvThreads = 256;  // threads a block of the conversion
constexpr int kMaxLevels = 32;

// The levels' scalings, already rounded to R: passed by value, so a launch copies nothing to the card;
// the kernels take it as a __grid_constant__, so a level's scaling is read from the parameter space where
// it lies (a plain by-value struct indexed by a runtime level is first copied to each thread's stack).
struct Scalings {
  float s[kMaxLevels];
};

__device__ __forceinline__ unsigned int hash_prime(int i) {
  // Instant-NGP / tcnn primes; the fourth hashes the actor index of the 4-D grid
  return i == 0 ? 1u : (i == 1 ? 2654435761u : (i == 2 ? 805459861u : 3674653429u));
}

// a value of R: float32 as it is, bf16 rounded to nearest even
template <bool kBf16>
__device__ __forceinline__ float rnd(float x) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// a bf16 value is the high half of a float32's bits
__device__ __forceinline__ float bf16_lo(unsigned int u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned int u) { return __uint_as_float(u & 0xffff0000u); }

// one table row of F values (element row * F), read through the read-only path
template <int F, bool kBf16>
__device__ __forceinline__ void load_row(const void* table, long long row, float (&v)[F]);

template <>
__device__ __forceinline__ void load_row<1, false>(const void* t, long long row, float (&v)[1]) {
  v[0] = __ldg(static_cast<const float*>(t) + row);
}
template <>
__device__ __forceinline__ void load_row<2, false>(const void* t, long long row, float (&v)[2]) {
  const float2 x = __ldg(reinterpret_cast<const float2*>(t) + row);
  v[0] = x.x;
  v[1] = x.y;
}
template <>
__device__ __forceinline__ void load_row<4, false>(const void* t, long long row, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(t) + row);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
template <>
__device__ __forceinline__ void load_row<1, true>(const void* t, long long row, float (&v)[1]) {
  v[0] = bf16_lo(__ldg(static_cast<const unsigned short*>(t) + row));
}
template <>
__device__ __forceinline__ void load_row<2, true>(const void* t, long long row, float (&v)[2]) {
  const unsigned int x = __ldg(reinterpret_cast<const unsigned int*>(t) + row);
  v[0] = bf16_lo(x);
  v[1] = bf16_hi(x);
}
template <>
__device__ __forceinline__ void load_row<4, true>(const void* t, long long row, float (&v)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(t) + row);
  v[0] = bf16_lo(x.x);
  v[1] = bf16_hi(x.x);
  v[2] = bf16_lo(x.y);
  v[3] = bf16_hi(x.y);
}

// F float32 values stored at element at, in one vector store
template <int F>
__device__ __forceinline__ void store_row(float* base, long long at, const float (&v)[F]);

template <>
__device__ __forceinline__ void store_row<1>(float* base, long long at, const float (&v)[1]) {
  base[at] = v[0];
}
template <>
__device__ __forceinline__ void store_row<2>(float* base, long long at, const float (&v)[2]) {
  *reinterpret_cast<float2*>(base + at) = make_float2(v[0], v[1]);
}
template <>
__device__ __forceinline__ void store_row<4>(float* base, long long at, const float (&v)[4]) {
  *reinterpret_cast<float4*>(base + at) = make_float4(v[0], v[1], v[2], v[3]);
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

// A point's cell at one level: the corner's integer coordinates and the factors o (offset) and
// r (1 - offset) of each axis, in the plain path's roundings.
template <int D>
struct Cell {
  unsigned int base[D];
  float o[D];
  float r[D];
};

template <int D, bool kBf16>
__device__ __forceinline__ Cell<D> make_cell(const float (&p)[D], float s) {
  Cell<D> cell;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float x = rnd<kBf16>(__fmul_rn(p[i], s));
    const float f = floorf(x);
    cell.o[i] = rnd<kBf16>(__fsub_rn(x, f));
    cell.r[i] = rnd<kBf16>(__fsub_rn(1.0f, cell.o[i]));
    cell.base[i] = static_cast<unsigned int>(static_cast<long long>(f));
  }
  return cell;
}

template <int D>
__device__ __forceinline__ float factor(const Cell<D>& cell, int c, int i) {
  return ((c >> i) & 1) ? cell.o[i] : cell.r[i];
}

// corner c's weight: its factors multiplied in axis order, each product rounded to R
template <int D, bool kBf16>
__device__ __forceinline__ float corner_weight(const Cell<D>& cell, int c) {
  float w = factor<D>(cell, c, 0);
#pragma unroll
  for (int i = 1; i < D; ++i) w = rnd<kBf16>(__fmul_rn(w, factor<D>(cell, c, i)));
  return w;
}

// corner c's row of its level, counted from the level's first row
template <int D>
__device__ __forceinline__ long long corner_row(const Cell<D>& cell, int c, unsigned int mask) {
  unsigned int h = cell.base[0] + static_cast<unsigned int>(c & 1);
#pragma unroll
  for (int i = 1; i < D; ++i) h ^= (cell.base[i] + static_cast<unsigned int>((c >> i) & 1)) * hash_prime(i);
  return static_cast<long long>(h & mask);
}

// the point's d coordinates, in R
template <int D, bool kBf16>
__device__ __forceinline__ void load_point(const float* pos, long long n, float (&p)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) p[i] = rnd<kBf16>(pos[n * D + i]);
}

// pairs = N * L (under 2^32): pair q is point q / L at level q % L; out [N, L * F]
template <int D, int F, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    hash_encode_fwd_kernel(const float* __restrict__ pos, const void* __restrict__ table, float* __restrict__ out,
                           const __grid_constant__ Scalings sc, unsigned int pairs,
                           unsigned int L, unsigned int mask, long long T) {
  constexpr int C = 1 << D;
  const unsigned int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= pairs) return;
  const unsigned int n = q / L;  // 32-bit: a 64-bit division is a long software routine
  const unsigned int l = q - n * L;
  float p[D];
  load_point<D, kBf16>(pos, n, p);
  const Cell<D> cell = make_cell<D, kBf16>(p, sc.s[l]);
  const long long row0 = static_cast<long long>(l) * T;
  float feat[C][F];
#pragma unroll
  for (int c = 0; c < C; ++c) load_row<F, kBf16>(table, row0 + corner_row<D>(cell, c, mask), feat[c]);
  float acc[F];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float w = corner_weight<D, kBf16>(cell, c);
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const float term = rnd<kBf16>(__fmul_rn(feat[c][k], w));
      acc[k] = c == 0 ? term : __fadd_rn(acc[k], term);
    }
  }
#pragma unroll
  for (int k = 0; k < F; ++k) acc[k] = rnd<kBf16>(acc[k]);
  store_row<F>(out, static_cast<long long>(q) * F, acc);
}

// One level's table gradient of a warp's points: each lane's 2^d corner rows R(R(grad) * weight) summed
// over each run of lanes in one cell (a run of one lane where the neighbours' cells differ) and added into
// acc (the level's first row) by the run's first lane. Every lane of the warp calls it; a lane not valid
// (past N) adds nothing and joins no run. Counts the lane's nonzero contributions and its atomics.
template <int D, int F, bool kBf16>
__device__ __forceinline__ void add_level(const Cell<D>& cell, const float (&g)[F], float* acc, unsigned int mask,
                                          bool valid, unsigned int lane, unsigned int& contributions,
                                          unsigned int& atomics) {
  constexpr int C = 1 << D;
  float gr[F];
#pragma unroll
  for (int k = 0; k < F; ++k) gr[k] = rnd<kBf16>(g[k]);
  // a lane whose gradient row is exact zeros adds nothing at any corner: a warp of such lanes is done
  if (!__any_sync(~0u, nonzero<F>(gr))) return;
  // a valid lane's left neighbour is valid: the lane continues a run if their cells are equal
  bool same = valid && lane > 0;
#pragma unroll
  for (int i = 0; i < D; ++i) same &= __shfl_up_sync(~0u, cell.base[i], 1) == cell.base[i];
  const unsigned int heads = __ballot_sync(~0u, !same);
  // the run's last lane: the lane before the next head above this one (2u << 31 wraps to 0)
  const unsigned int above = heads & ~((2u << lane) - 1u);
  const unsigned int end = above ? __ffs(above) - 2 : 31;
  const unsigned int longest = __reduce_max_sync(~0u, same ? 0u : end - lane + 1);
  const int steps = 32 - __clz(longest - 1);  // ceil(log2(longest)): 0 where every run is one lane
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float w = corner_weight<D, kBf16>(cell, c);
    float v[F];
#pragma unroll
    for (int k = 0; k < F; ++k) v[k] = rnd<kBf16>(__fmul_rn(gr[k], w));
    contributions += nonzero<F>(v);
    // after the step of offset o, a lane holds the sum of lanes [lane, lane + 2o) of its run
    for (int st = 0, o = 1; st < steps; ++st, o <<= 1) {
#pragma unroll
      for (int k = 0; k < F; ++k) {
        const float other = __shfl_down_sync(~0u, v[k], o);
        if (lane + o <= end) v[k] = __fadd_rn(v[k], other);
      }
    }
    if (!same && nonzero<F>(v)) {
      add_row(acc + corner_row<D>(cell, c, mask) * F, v);
      ++atomics;
    }
  }
}

// Levels [l0, l1) of N points. acc: the float32 gradient of the group's rows [l0 * T, l1 * T) (null: the
// table needs none). kPosGrad: the positions' gradient, continued from pos_acc [N, D] (float64) unless
// first, and written to pos_grad if last, else to pos_acc. stats (null: none): two counts added, the
// nonzero contributions to the table's gradient and the atomics that added them. Every lane of a warp
// runs the level loop (add_level's shuffles take the whole warp); lanes past N only take part.
template <int D, int F, bool kBf16, bool kPosGrad>
__global__ void __launch_bounds__(kThreads)
    hash_encode_bwd_kernel(const float* __restrict__ pos, const void* __restrict__ table,
                           const float* __restrict__ grad_out, const __grid_constant__ Scalings sc, long long N,
                           int L, int l0, int l1, unsigned int mask, long long T, float* __restrict__ acc,
                           double* __restrict__ pos_acc, float* __restrict__ pos_grad, int first, int last,
                           unsigned long long* __restrict__ stats) {
  constexpr int C = 1 << D;
  const long long n = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool valid = n < N;
  const unsigned int lane = threadIdx.x & 31u;
  float p[D];
  if (valid) {
    load_point<D, kBf16>(pos, n, p);
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) p[i] = 0.0f;
  }
  double dp[D];
#pragma unroll
  for (int i = 0; i < D; ++i) dp[i] = (kPosGrad && !first && valid) ? pos_acc[n * D + i] : 0.0;
  unsigned int contributions = 0, atomics = 0;
  for (int l = l0; l < l1; ++l) {
    const float s = sc.s[l];
    const Cell<D> cell = make_cell<D, kBf16>(p, s);
    float g[F];
#pragma unroll
    for (int k = 0; k < F; ++k) g[k] = valid ? grad_out[(n * L + l) * F + k] : 0.0f;
    if (acc != nullptr)
      add_level<D, F, kBf16>(cell, g, acc + static_cast<long long>(l - l0) * T * F, mask, valid, lane, contributions,
                             atomics);
    if (kPosGrad && valid) {
      const long long trow0 = static_cast<long long>(l) * T;
      float feat[C][F];
#pragma unroll
      for (int c = 0; c < C; ++c) load_row<F, kBf16>(table, trow0 + corner_row<D>(cell, c, mask), feat[c]);
      double dot[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dot[c] = static_cast<double>(g[0]) * feat[c][0];
#pragma unroll
        for (int k = 1; k < F; ++k) dot[c] = __fma_rn(static_cast<double>(g[k]), feat[c][k], dot[c]);
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        double sum = 0.0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          double t = dot[c];
#pragma unroll
          for (int j = 0; j < D; ++j)
            if (j != i) t *= factor<D>(cell, c, j);
          sum = ((c >> i) & 1) ? sum + t : sum - t;
        }
        dp[i] = __fma_rn(static_cast<double>(s), sum, dp[i]);
      }
    }
  }
  if (kPosGrad && valid) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      if (last)
        pos_grad[n * D + i] = __double2float_rn(dp[i]);
      else
        pos_acc[n * D + i] = dp[i];
    }
  }
  if (stats != nullptr && acc != nullptr) {
    const unsigned int warp_contributions = __reduce_add_sync(~0u, contributions);
    const unsigned int warp_atomics = __reduce_add_sync(~0u, atomics);
    if (lane == 0) {
      atomicAdd(stats, static_cast<unsigned long long>(warp_contributions));
      atomicAdd(stats + 1, static_cast<unsigned long long>(warp_atomics));
    }
  }
}

__global__ void __launch_bounds__(kConvThreads)
    to_bf16_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kConvThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kConvThreads + threadIdx.x; i < n; i += stride)
    out[i] = __float2bfloat16_rn(__ldcs(acc + i));
}

unsigned int blocks_for(long long n, int threads) { return static_cast<unsigned int>((n + threads - 1) / threads); }

Scalings scalings_arg(const float* scalings, int L) {
  Scalings sc{};
  for (int l = 0; l < L; ++l) sc.s[l] = scalings[l];
  return sc;
}

template <int D, int F, bool kBf16>
void launch_fwd(const float* pos, const void* table, float* out, const Scalings& sc, long long N, int L, long long T,
                cudaStream_t s) {
  const long long pairs = N * L;
  hash_encode_fwd_kernel<D, F, kBf16><<<blocks_for(pairs, kThreads), kThreads, 0, s>>>(
      pos, table, out, sc, static_cast<unsigned int>(pairs), static_cast<unsigned int>(L),
      static_cast<unsigned int>(T - 1), T);
}

template <int D, int F, bool kBf16>
void launch_bwd(const float* pos, const void* table, const float* grad_out, const Scalings& sc, long long N, int L,
                int l0, int l1, long long T, float* acc, double* pos_acc, float* pos_grad, int first, int last,
                unsigned long long* stats, cudaStream_t s) {
  const unsigned int mask = static_cast<unsigned int>(T - 1);
  if (pos_grad != nullptr) {
    hash_encode_bwd_kernel<D, F, kBf16, true><<<blocks_for(N, kThreads), kThreads, 0, s>>>(
        pos, table, grad_out, sc, N, L, l0, l1, mask, T, acc, pos_acc, pos_grad, first, last, stats);
  } else {
    hash_encode_bwd_kernel<D, F, kBf16, false><<<blocks_for(N, kThreads), kThreads, 0, s>>>(
        pos, table, grad_out, sc, N, L, l0, l1, mask, T, acc, pos_acc, pos_grad, first, last, stats);
  }
}

// the template of (d, F, table dtype); false where there is none
template <typename Fn>
bool dispatch(int D, int F, int bf16, Fn&& fn);

#define HASH_ENCODE_CASE(D_, F_)                                   \
  if (D == D_ && F == F_) {                                        \
    if (bf16)                                                      \
      fn(std::integral_constant<int, D_>{}, std::integral_constant<int, F_>{}, std::true_type{});  \
    else                                                           \
      fn(std::integral_constant<int, D_>{}, std::integral_constant<int, F_>{}, std::false_type{}); \
    return true;                                                   \
  }

template <typename Fn>
bool dispatch(int D, int F, int bf16, Fn&& fn) {
  HASH_ENCODE_CASE(3, 1)
  HASH_ENCODE_CASE(3, 2)
  HASH_ENCODE_CASE(3, 4)
  HASH_ENCODE_CASE(4, 1)
  HASH_ENCODE_CASE(4, 2)
  HASH_ENCODE_CASE(4, 4)
  return false;
}

#undef HASH_ENCODE_CASE

bool valid(long long N, int D, int L, int F, long long T) {
  return N >= 0 && N * L < (1LL << 32) && (D == 3 || D == 4) && L >= 1 && L <= kMaxLevels && (F == 1 || F == 2 || F == 4) && T >= 1 &&
         T <= (1LL << 32) && (T & (T - 1)) == 0;
}

}  // namespace

// The encode of N points [N, D] (float32) through a table of L levels of T rows of F values (float32, or
// bf16 if table_bf16: the compute type R): out [N, L * F], float32. scalings: L floats on the host,
// rounded to R.
extern "C" int hash_encode_fwd(const void* pos, const void* table, int table_bf16, void* out, const float* scalings,
                               long long N, int D, int L, int F, long long T, void* stream) {
  if (!valid(N, D, L, F, T)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scalings sc = scalings_arg(scalings, L);
  const bool ok = dispatch(D, F, table_bf16, [&](auto d, auto f, auto b) {
    launch_fwd<decltype(d)::value, decltype(f)::value, decltype(b)::value>(
        static_cast<const float*>(pos), table, static_cast<float*>(out), sc, N, L, T, s);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The backward of levels [l0, l1) of that encode, from grad_out [N, L * F] (float32). acc (null: the table
// needs no gradient): float32, (l1 - l0) * T * F values, zeroed here, then every contribution of those
// levels added; a bf16 table's (table_bf16 1) is then rounded into table_grad, the bf16 gradient's rows of
// those levels; a float32 table's gradient is acc itself. pos_grad (null: the positions need no
// gradient): [N, D], float32, written when last is 1; pos_acc, float64 [N, D], carries the sum from one
// group to the next (read unless first, written unless last). stats (null: none): two unsigned 64-bit
// counts on the device, to which the launch adds the table gradient's nonzero contributions (rows of F
// values) and the atomics that added them.
extern "C" int hash_encode_bwd(const void* pos, const void* table, int table_bf16, const void* grad_out,
                               const float* scalings, long long N, int D, int L, int F, long long T, int l0, int l1,
                               void* acc, void* table_grad, void* pos_acc, void* pos_grad, int first, int last,
                               void* stats, void* stream) {
  if (!valid(N, D, L, F, T) || l0 < 0 || l1 > L || l0 >= l1 || (acc == nullptr && pos_grad == nullptr) ||
      (pos_grad != nullptr && pos_acc == nullptr && !(first && last)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(l1 - l0) * T;
  float* accf = static_cast<float*>(acc);
  if (acc != nullptr) {
    const cudaError_t err = cudaMemsetAsync(acc, 0, static_cast<size_t>(rows) * F * sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (N > 0) {
    const Scalings sc = scalings_arg(scalings, L);
    const bool ok = dispatch(D, F, table_bf16, [&](auto d, auto f, auto b) {
      launch_bwd<decltype(d)::value, decltype(f)::value, decltype(b)::value>(
          static_cast<const float*>(pos), table, static_cast<const float*>(grad_out), sc, N, L, l0, l1, T, accf,
          static_cast<double*>(pos_acc), static_cast<float*>(pos_grad), first, last,
          static_cast<unsigned long long*>(stats), s);
    });
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (acc != nullptr && table_bf16) {
    const long long n = rows * F;
    const long long blocks = (n + kConvThreads - 1) / kConvThreads;
    const unsigned int grid = static_cast<unsigned int>(blocks < 65535 * 8 ? blocks : 65535 * 8);
    to_bf16_kernel<<<grid, kConvThreads, 0, s>>>(accf, static_cast<__nv_bfloat16*>(table_grad), n);
  }
  return static_cast<int>(cudaGetLastError());
}
