// What the two K2 sources share: csrc/attention.cu (float32, 3xTF32 mma.sync) and
// csrc/attention_bf16.cu (bf16, wgmma on TMA tiles).
//  - The dropout hash. keep_hash(seed, b, qi, kj) = fmix32(qi * kRowMul + kj * kColMul + hash_stream(seed, b)),
//    and an entry is kept when it is >= thresh; ops/attention.keep_mask computes the same bits on the
//    CPU. The kernels hoist the stream and the term of their fixed row out of the key loop.
//  - The quad reductions of the online softmax (a row's columns lie in the 4 threads of a quad).
//  - The launch: a kernel's dynamic shared-memory limit is raised once per (kernel, device), and only
//    above the 48 KB that every kernel may use without it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

constexpr uint32_t kRowMul = 0x9E3779B9u;
constexpr uint32_t kColMul = 0x85EBCA6Bu;

__device__ __forceinline__ uint32_t hash_stream(uint32_t seed, uint32_t b) { return fmix32(seed + b * 0x27D4EB2Fu); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr int kDefaultSmemLimit = 48 * 1024;

// Raises a kernel's dynamic shared-memory limit on the current device to smem bytes, once per
// (kernel, device, size); returns a cudaError_t code.
inline int raise_smem_limit(const void* kernel, int smem) {
  struct Raised {
    const void* kernel;
    int device, smem;
  };
  static std::mutex lock;
  static Raised raised[64];
  static int n_raised = 0;
  int device = 0;
  int err = static_cast<int>(cudaGetDevice(&device));
  if (err != 0) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < n_raised; ++i) {
    if (raised[i].kernel == kernel && raised[i].device == device && raised[i].smem >= smem) return 0;
  }
  err = static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err == 0 && n_raised < 64) raised[n_raised++] = {kernel, device, smem};
  return err;
}

// Launches a kernel with smem bytes of dynamic shared memory; returns the first cudaError_t.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, dim3 block, int smem, cudaStream_t stream, Args... args) {
  if (smem > kDefaultSmemLimit) {
    const int err = raise_smem_limit(reinterpret_cast<const void*>(kernel), smem);
    if (err != 0) return err;
  }
  kernel<<<grid, block, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
