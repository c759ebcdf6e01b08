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
// bytes that move are 52 per index, not 36.
//
// Design: one thread per output row. Where a row is a whole number of 16-byte
// vectors and both pointers are 16-byte aligned, the row moves as float4
// loads and stores (one load instruction per 16-byte row); otherwise as
// floats. Threads past N return (the ragged tail of the last block). Indices
// are validated by the wrapper; the kernel trusts them.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void row_gather_vec4_kernel(const float4* __restrict__ table, const int* __restrict__ idx,
                                       float4* __restrict__ out, int N, int F4) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= N) return;
  const float4* src = table + static_cast<long long>(__ldg(idx + i)) * F4;
  float4* dst = out + i * F4;
  for (int j = 0; j < F4; ++j) dst[j] = __ldg(src + j);
}

__global__ void row_gather_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                                  float* __restrict__ out, int N, int F) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= N) return;
  const float* src = table + static_cast<long long>(__ldg(idx + i)) * F;
  float* dst = out + i * F;
  for (int j = 0; j < F; ++j) dst[j] = __ldg(src + j);
}

}  // namespace

extern "C" int row_gather(const void* table, const void* idx, void* out, int N, int F, void* stream) {
  if (N == 0 || F == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (N + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = F % 4 == 0 && reinterpret_cast<std::uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  if (vec) {
    row_gather_vec4_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float4*>(table), static_cast<const int*>(idx),
                                                       static_cast<float4*>(out), N, F / 4);
  } else {
    row_gather_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(table), static_cast<const int*>(idx),
                                                  static_cast<float*>(out), N, F);
  }
  return static_cast<int>(cudaGetLastError());
}
