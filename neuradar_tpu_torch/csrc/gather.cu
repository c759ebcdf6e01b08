// P1: row gather out[i, :] = table[idx[i], :] for sm_90a.
//
// Replaces the TPU probe `run` of tools/probe_mosaic_gather.py, whose Pallas
// forms (advanced indexing, jnp.take, a one-hot matmul, a loop of row loads)
// all compute this function on a [T, F] float32 table and int32 indices. It is
// the access pattern of a hash-grid encode (one random row per corner), so its
// time at a hash grid's table size is what a fused encode kernel can expect.
//
// What bounds it on the H100: memory. Each index reads 4 bytes of index and
// one F*4-byte row at a random place, and writes one row. A random row smaller
// than a 32-byte sector still costs the whole sector, so for 16-byte rows the
// bytes that move are 52 per index, not 36. Where the table is far larger
// than the L2, what holds the gather is the card's rate of random DRAM reads,
// below the sector bound: scripts/p1_ladder.py's ceiling probe, the same
// random reads with no output, takes about five sixths of this kernel's time
// there, at every L2 fetch granularity, and the output's writes add the rest.
//
// Design: one row a thread, in blocks of kThreads consecutive rows, so every
// index load and every row store of a warp is coalesced and a warp writes
// whole 32-byte sectors at once; enough warps are resident that the index
// wait of one hides behind the row loads of others. Rows are written with
// st.global.cs (evict-first), so the output does not push table sectors out of
// the L2. Where a row is a whole number of 16-byte vectors and the table and
// output are 16-byte aligned, rows move as float4s ("vec4"); otherwise as
// floats ("scalar"); ops/gather.py, row_gather_path, mirrors the choice. The
// knobs below are where p1_ladder.py's variants change this source. On an
// H100 each of them was slower at some of its shapes and none faster by more
// than 1.1 % at any: more rows a thread (kThreads apart), 256 or 512 threads a
// block, a persistent grid, a thread's rows side by side (its stores write
// half sectors), nc/no-allocate loads, an L2 evict-last policy for the table,
// and plain stores (5 % slower where the table fits in the L2).
//
// The indices are checked on the card, so the launch never waits on the host:
// a row whose index lies outside [0, T) sets the device flag word, is written
// as zeros and reads nothing of the table; the wrapper reads the flag at its
// next check (ops/gather.py, check_indices).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kRows = 1;       // rows a thread, kThreads apart

// The thread's first row, and its row k.
__device__ __forceinline__ long long first_row() {
  return static_cast<long long>(blockIdx.x) * kThreads * kRows + threadIdx.x;
}
__device__ __forceinline__ long long row_k(long long first, int k) {
  return first + static_cast<long long>(k) * kThreads;
}

__device__ __forceinline__ float4 load_row(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float load_row(const float* p) { return __ldg(p); }

__device__ __forceinline__ void store_row(float4* p, float4 v) { __stcs(p, v); }
__device__ __forceinline__ void store_row(float* p, float v) { __stcs(p, v); }

__device__ __forceinline__ float4 zero(float4) { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ float zero(float) { return 0.0f; }

// V is float4 (W = F / 4 vectors a row) or float (W = F).
template <typename V>
__global__ void __launch_bounds__(kThreads) row_gather_kernel(const V* __restrict__ table,
                                                              const int* __restrict__ idx, V* __restrict__ out,
                                                              int* __restrict__ flag, int T, long long N, int W) {
  const long long first = first_row();
  if (first >= N) return;
  int rows[kRows];
  bool ok[kRows];
  bool bad = false;
#pragma unroll
  for (int k = 0; k < kRows; ++k) rows[k] = row_k(first, k) < N ? __ldg(idx + row_k(first, k)) : 0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const bool live = row_k(first, k) < N;
    ok[k] = live && rows[k] >= 0 && rows[k] < T;
    bad |= live && !ok[k];
  }
  if (bad) *flag = 1;
  for (int j = 0; j < W; ++j) {
    V v[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      v[k] = ok[k] ? load_row(table + static_cast<long long>(rows[k]) * W + j) : zero(V());
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (row_k(first, k) < N) store_row(out + row_k(first, k) * W + j, v[k]);
  }
}  // row_gather_kernel

template <typename V>
void launch(const void* table, const void* idx, void* out, void* flag, int T, int N, int W, cudaStream_t s) {
  const long long rows_a_block = static_cast<long long>(kThreads) * kRows;
  const long long tiles = (N + rows_a_block - 1) / rows_a_block;
  const int blocks = static_cast<int>(tiles);
  row_gather_kernel<V><<<blocks, kThreads, 0, s>>>(static_cast<const V*>(table), static_cast<const int*>(idx),
                                                   static_cast<V*>(out), static_cast<int*>(flag), T, N, W);
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int row_gather(const void* table, const void* idx, void* out, void* flag, int T, int N, int F,
                          void* stream) {
  if (N == 0 || F == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F % 4 == 0 && aligned16(table) && aligned16(out)) {
    launch<float4>(table, idx, out, flag, T, N, F / 4, s);
  } else {
    launch<float>(table, idx, out, flag, T, N, F, s);
  }
  return static_cast<int>(cudaGetLastError());
}
