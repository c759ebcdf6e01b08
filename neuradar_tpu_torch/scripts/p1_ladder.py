"""P1's design ladder on the card: the committed row gather beside variants of its design, an earlier
kernel and a ceiling probe of random reads, timed in turns.

    python -m neuradar_tpu_torch.scripts.p1_ladder [--baseline NAME=PATH ...] [--reps 20]

Each variant is ``csrc/gather.cu`` with a few lines replaced (``VARIANTS``: rows a thread, block
size, a persistent grid, a thread's rows side by side, cache hints), built by nvcc into its own
library under ``build/p1_ladder/`` and launched through the same C interface as the port's kernel;
"cp.async" is a kernel of its own (``CP_ASYNC_SOURCE``) that copies rows into shared memory with
Hopper's asynchronous copies and writes each tile out as coalesced stores; ``--baseline`` adds
another source with the same C interface as it stands (an earlier commit's gather.cu, for example).
Every variant must give the plain version's rows bit for bit.

The ceiling probe (``CEILING_SOURCE``, with 1, 2 and 4 rows a thread) is not a gather: each thread
reads 16 bytes of the 32-byte sector that holds each of its indices' rows and folds them into a
sum, and each block writes one float. It reads the indices and the random sectors the gather reads
and writes almost nothing, so its time is what the card's memory system gives for these random
reads alone. It runs at each L2 fetch granularity of ``GRANULARITIES``
(``cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, ...)``, set before its row and restored
after, read back beside the row), as does the committed kernel; the port never sets it.

Shapes: the five of ``probe_gather.SHAPES`` and the two hash-grid tables of the neuradar-synthetic
preset that those lack (a proposal grid's [6 * 2^20, 1], the scalar path, and the actor grid's
[4 * 2^17, 4]), each with uniform random indices. ``ms`` is the device time alone
(utils/timing.device_ms: ``--reps`` launches queued behind a spin of the card, one event pair),
``call_ms`` one launch's time with its host work. At each shape the committed kernel first runs
for ``WARM_UP_S``; then each row runs in three turns, in order, in reverse and in order again, and
its times are the medians over the turns (the rows timed first at a shape can still run a few %
slow in the first turn). Bounds at 3.35 TB/s as probe_gather.py's. One JSON line per shape and
row; the first line names the card and its power limit, the second the L2 fetch granularity in
effect before the ladder set any.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from neuradar_tpu_torch.ops import build, gather
from neuradar_tpu_torch.scripts.probe_gather import SHAPES as PROBE_SHAPES, bounds_ms
from neuradar_tpu_torch.utils.timing import call_ms, device_ms

SOURCE = build.CSRC / "gather.cu"
OUT_DIR = build.BUILD_DIR.parent / "p1_ladder"
SHAPES = (*PROBE_SHAPES, (6 * 2**20, 1, 2**22), (4 * 2**17, 4, 2**22))  # (table rows, features, indices)
GRANULARITIES = (32, 64, 128)  # L2 fetch granularities (bytes) of the ceiling probe's rows
WARM_UP_S = 2.0  # seconds of the committed kernel at each shape before its turns

ROWS = "constexpr int kRows = 1;"
THREADS = "constexpr int kThreads = 128;"
LOADS = ("__device__ __forceinline__ float4 load_row(const float4* p) { return __ldg(p); }\n"
         "__device__ __forceinline__ float load_row(const float* p) { return __ldg(p); }\n")
STORES = ("__device__ __forceinline__ void store_row(float4* p, float4 v) { __stcs(p, v); }\n"
          "__device__ __forceinline__ void store_row(float* p, float v) { __stcs(p, v); }\n")
NC_LOADS = [(LOADS, "__device__ __forceinline__ float4 load_row(const float4* p) {\n"
                    "  float4 v;\n"
                    '  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"\n'
                    '      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));\n'
                    "  return v;\n"
                    "}\n"
                    "__device__ __forceinline__ float load_row(const float* p) {\n"
                    "  float v;\n"
                    '  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));\n'
                    "  return v;\n"
                    "}\n")]
CONTIGUOUS = [(ROWS, "constexpr int kRows = 4;"),
              ("  return static_cast<long long>(blockIdx.x) * kThreads * kRows + threadIdx.x;\n",
               "  return (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kRows;\n"),
              ("  return first + static_cast<long long>(k) * kThreads;\n", "  return first + k;\n")]
# name -> (what it probes, [(committed text, replacement)])
VARIANTS = {
    "committed": ("1 row a thread; one block per 128 rows; __ldg loads, evict-first stores", []),
    "rows-2": ("2 rows a thread, 128 apart", [(ROWS, "constexpr int kRows = 2;")]),
    "rows-4": ("4 rows a thread, 128 apart", [(ROWS, "constexpr int kRows = 4;")]),
    "rows-8": ("8 rows a thread, 128 apart", [(ROWS, "constexpr int kRows = 8;")]),
    "threads-256": ("256 threads a block", [(THREADS, "constexpr int kThreads = 256;")]),
    "threads-512": ("512 threads a block", [(THREADS, "constexpr int kThreads = 512;")]),
    "persistent": ("a persistent grid (the SMs times the blocks that fit on one) in a grid-stride loop",
                   [("  const long long first = first_row();\n  if (first >= N) return;\n",
                     "  for (long long first = first_row(); first < N;\n"
                     "       first += static_cast<long long>(gridDim.x) * kThreads * kRows) {\n"),
                    ("\n}  // row_gather_kernel\n", "\n  }\n}  // row_gather_kernel\n"),
                    ("  const int blocks = static_cast<int>(tiles);\n",
                     "  static int resident = 0;\n"
                     "  if (resident == 0) {\n"
                     "    int device = 0, sms = 0, per_sm = 0;\n"
                     "    cudaGetDevice(&device);\n"
                     "    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);\n"
                     "    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_gather_kernel<V>, kThreads, 0);\n"
                     "    resident = sms * (per_sm > 0 ? per_sm : 1);\n"
                     "  }\n"
                     "  const int blocks = static_cast<int>(tiles < resident ? tiles : resident);\n")]),
    "contiguous-4": ("4 rows a thread side by side: a warp's stores write half sectors", CONTIGUOUS),
    "contiguous-4-nc": ("contiguous-4 with nc/no-allocate loads", CONTIGUOUS + NC_LOADS),
    "nc-no-allocate": ("rows read by ld.global.nc.L1::no_allocate", NC_LOADS),
    "evict-last-table": ("rows read with an L2 evict-last policy (createpolicy), to keep the table in the L2",
                         [(LOADS, "__device__ __forceinline__ unsigned long long evict_last() {\n"
                                  "  unsigned long long policy;\n"
                                  '  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));\n'
                                  "  return policy;\n"
                                  "}\n"
                                  "__device__ __forceinline__ float4 load_row(const float4* p) {\n"
                                  "  float4 v;\n"
                                  '  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"\n'
                                  '      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(evict_last()));\n'
                                  "  return v;\n"
                                  "}\n"
                                  "__device__ __forceinline__ float load_row(const float* p) {\n"
                                  "  float v;\n"
                                  '  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"\n'
                                  '      : "=f"(v) : "l"(p), "l"(evict_last()));\n'
                                  "  return v;\n"
                                  "}\n")]),
    "plain-stores": ("rows written by plain stores (st.global, no evict-first hint)",
                     [(STORES, "__device__ __forceinline__ void store_row(float4* p, float4 v) { *p = v; }\n"
                               "__device__ __forceinline__ void store_row(float* p, float v) { *p = v; }\n")]),
}

# Rows copied into shared memory by cp.async (16 bytes by .cg for float4 rows, 4 by .ca for floats),
# double-buffered per block over tiles of kThreads * kRows rows, a bad index zero-filled (source
# size 0) and flagged; each tile goes out as coalesced evict-first stores.
CP_ASYNC_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
namespace {
constexpr int kThreads = 256;
constexpr int kRows = 4;

__device__ __forceinline__ void cp_async(float4* dst, const float4* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(bytes));
}

template <typename V>
__device__ void start_copies(const V* table, const int* idx, V* buf, int* flag, int T, long long N, int W,
                             long long tile) {
  const long long base = tile * kThreads * kRows;
  bool bad = false;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i >= N) break;
    const int row = __ldg(idx + i);
    const bool ok = row >= 0 && row < T;
    bad |= !ok;
    const V* src = table + (ok ? static_cast<long long>(row) * W : 0);
    for (int j = 0; j < W; ++j)
      cp_async(buf + (k * kThreads + threadIdx.x) * W + j, src + j, ok ? static_cast<int>(sizeof(V)) : 0);
  }
  if (bad) *flag = 1;
}

template <typename V>
__global__ void __launch_bounds__(kThreads) row_gather_cp_async(const V* __restrict__ table,
    const int* __restrict__ idx, V* __restrict__ out, int* __restrict__ flag, int T, long long N, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* bufs = reinterpret_cast<V*>(smem);
  const long long tiles = (N + kThreads * kRows - 1) / (kThreads * kRows);
  const int per_buf = kThreads * kRows * W;
  int b = 0;
  long long tile = blockIdx.x;
  if (tile < tiles) start_copies(table, idx, bufs, flag, T, N, W, tile);
  asm volatile("cp.async.commit_group;");
  for (; tile < tiles; tile += gridDim.x) {
    if (tile + gridDim.x < tiles) start_copies(table, idx, bufs + (b ^ 1) * per_buf, flag, T, N, W, tile + gridDim.x);
    asm volatile("cp.async.commit_group;");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    const long long base = tile * kThreads * kRows;
    const long long n = (N - base < kThreads * kRows ? N - base : kThreads * kRows) * W;
    for (long long e = threadIdx.x; e < n; e += kThreads) __stcs(out + base * W + e, bufs[b * per_buf + e]);
    __syncthreads();
    b ^= 1;
  }
}

template <typename V>
void launch(const void* table, const void* idx, void* out, void* flag, int T, int N, int W, cudaStream_t s) {
  auto kernel = row_gather_cp_async<V>;
  const int smem = static_cast<int>(2 * kThreads * kRows * W * sizeof(V));
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  const long long tiles = (static_cast<long long>(N) + kThreads * kRows - 1) / (kThreads * kRows);
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  kernel<<<static_cast<int>(tiles < resident ? tiles : resident), kThreads, smem, s>>>(
      static_cast<const V*>(table), static_cast<const int*>(idx), static_cast<V*>(out), static_cast<int*>(flag),
      T, N, W);
}
}  // namespace

extern "C" int row_gather(const void* table, const void* idx, void* out, void* flag, int T, int N, int F,
                          void* stream) {
  if (N == 0 || F == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = F % 4 == 0 && reinterpret_cast<std::uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  if (vec) launch<float4>(table, idx, out, flag, T, N, F / 4, s);
  else launch<float>(table, idx, out, flag, T, N, F, s);
  return static_cast<int>(cudaGetLastError());
}
"""

# The ceiling probe: per index, one 16-byte load from the 32-byte sector that holds its row (the
# aligned 16 bytes where the row starts), summed; the gather's layout (rows a thread kThreads apart).
CEILING_SOURCE = r"""
#include <cuda_runtime.h>
namespace {
constexpr int kThreads = 256;
constexpr int kRows = 1;

__global__ void __launch_bounds__(kThreads) sector_sum(const char* __restrict__ table, const int* __restrict__ idx,
                                                       float* __restrict__ partial, long long N, int row_bytes) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads * kRows;
  float acc = 0.0f;
  for (long long first = static_cast<long long>(blockIdx.x) * kThreads * kRows + threadIdx.x; first < N;
       first += step) {
    int rows[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) rows[k] = first + k * kThreads < N ? __ldg(idx + first + k * kThreads) : -1;
    float4 a[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const long long at = static_cast<long long>(rows[k]) * row_bytes;
      a[k] = rows[k] >= 0 ? __ldg(reinterpret_cast<const float4*>(table + (at & ~15LL)))
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc += (a[k].x + a[k].y) + (a[k].z + a[k].w);
  }
  for (int o = 16; o > 0; o /= 2) acc += __shfl_down_sync(0xffffffffu, acc, o);
  __shared__ float warps[kThreads / 32];
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) total += warps[w];
    partial[blockIdx.x] = total;
  }
}
}  // namespace

// One launch over N indices, one block per kThreads * kRows of them; partial gets one float a block.
extern "C" int p1_sector_ceiling(const void* table, const void* idx, void* partial, int N, int row_bytes,
                                 int max_blocks, void* stream) {
  const long long blocks = (static_cast<long long>(N) + kThreads * kRows - 1) / (kThreads * kRows);
  if (blocks > max_blocks) return static_cast<int>(cudaErrorInvalidValue);
  sector_sum<<<static_cast<int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(table), static_cast<const int*>(idx), static_cast<float*>(partial), N, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// Sets the L2 fetch granularity if bytes > 0; returns the granularity in effect after, or -(the error).
extern "C" int p1_l2_fetch_granularity(int bytes) {
  if (bytes > 0) {
    const cudaError_t err = cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, static_cast<size_t>(bytes));
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  size_t now = 0;
  const cudaError_t err = cudaDeviceGetLimit(&now, cudaLimitMaxL2FetchGranularity);
  return err == cudaSuccess ? static_cast<int>(now) : -static_cast<int>(err);
}
"""
CEILING_ROWS = (1, 2, 4)  # rows a thread of the ceiling probe's variants
CEILING_BLOCKS = 2**22 // 256  # the partial sums' length: one float a block, at most 2^22 indices of 1 row a thread


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in {SOURCE} exactly once")
        text = text.replace(old, new)
    return text


def _launch(lib, table, idx):
    """One launch of ``lib``'s row_gather, as the wrapper launches the port's (flag word included)."""
    T, F = table.shape
    out = torch.empty((idx.shape[0], F), dtype=table.dtype, device=table.device)
    code = lib.row_gather(table.data_ptr(), idx.data_ptr(), out.data_ptr(), gather._flag(table.device).data_ptr(),
                          T, idx.shape[0], F, torch.cuda.current_stream().cuda_stream)
    build.check(code, "row_gather")
    return out


def _granularity(probe, bytes_: int) -> int:
    torch.cuda.synchronize()
    now = probe.p1_l2_fetch_granularity(bytes_)
    if now < 0:
        raise RuntimeError(f"cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, {bytes_}) failed: {-now}")
    return now


def _warm_up(fn, seconds: float = WARM_UP_S) -> None:
    """Launch ``fn`` for ``seconds`` before a shape's turns: on an H100 the rows timed first at a shape
    ran slower than the same kernels later in the turn."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()


def _build(sources: dict) -> dict:
    """``build.build_each`` on each source alone, all at once; a source that does not build is
    reported on a JSON line of its own and left out."""
    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {n: pool.submit(build.build_each, {n: path}, OUT_DIR) for n, path in sources.items()}
    libs = {}
    for n, future in futures.items():
        try:
            libs.update(future.result())
        except RuntimeError as err:
            print(json.dumps({"row": n, "build_failed": str(err)[-3000:]}), flush=True)
    for n in ("committed", f"ceiling-r{CEILING_ROWS[0]}"):
        if n not in libs:
            raise RuntimeError(f"{n} did not build")
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", action="append", default=[], metavar="NAME=PATH",
                        help="another source of csrc/gather.cu's C interface, built as it is")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("p1_ladder measures the card; no CUDA device here")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    texts = {name: variant_source(name) for name in VARIANTS}
    texts["cp.async"] = CP_ASYNC_SOURCE
    for r in CEILING_ROWS:
        texts[f"ceiling-r{r}"] = CEILING_SOURCE.replace("constexpr int kRows = 1;", f"constexpr int kRows = {r};")
    sources = {}
    for name, text in texts.items():
        sources[name] = OUT_DIR / f"{name}.cu"
        sources[name].write_text(text)
    for spec in args.baseline:
        name, path = spec.split("=", 1)
        sources[name] = Path(path).resolve()
    libs = _build(sources)
    probes = {n: libs.pop(n) for n in list(libs) if n.startswith("ceiling-")}
    for probe in probes.values():
        probe.p1_sector_ceiling.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        probe.p1_l2_fetch_granularity.argtypes = [ctypes.c_int]
    limit = probes[f"ceiling-r{CEILING_ROWS[0]}"]  # the granularity is the process's, set through any probe
    about = {**{n: VARIANTS[n][0] for n in VARIANTS},
             "cp.async": "4 rows a thread copied into shared memory by cp.async, double-buffered tiles on a "
                         "persistent grid, coalesced evict-first stores",
             **{n: f"random reads alone: one 16-byte load an index from its row's sector, {n[9:]} rows a thread, "
                   "summed; no output" for n in probes},
             **{spec.split("=", 1)[0]: spec for spec in args.baseline}}
    default = _granularity(limit, 0)
    print(json.dumps({"l2_fetch_granularity_default": default}), flush=True)
    partial = torch.empty(CEILING_BLOCKS, device=device)

    gen = torch.Generator(device=device).manual_seed(0)
    for T, F, N in SHAPES:
        table = torch.randn((T, F), generator=gen, device=device)
        idx = torch.randint(0, T, (N,), generator=gen, device=device, dtype=torch.int32)
        want = gather.row_gather_reference(table, idx)
        for n, lib in libs.items():
            if not torch.equal(_launch(lib, table, idx), want):
                raise RuntimeError(f"{n} at [{T}, {F}] x {N}: the gather differs from its plain version")
        gather.check_indices(device)

        def ceiling(probe):
            build.check(probe.p1_sector_ceiling(table.data_ptr(), idx.data_ptr(), partial.data_ptr(), N, F * 4,
                                                CEILING_BLOCKS, torch.cuda.current_stream().cuda_stream),
                        "p1_sector_ceiling")

        # a check that each probe reads what it names: its sum against the same sum in float64
        chunks = table.reshape(-1, 4)[(idx.long() * F * 4) // 16].double()
        for n, probe in probes.items():
            partial.zero_()
            ceiling(probe)
            if abs(float(partial.double().sum()) - float(chunks.sum())) > 1e-5 * float(chunks.abs().sum()):
                raise RuntimeError(f"{n} at [{T}, {F}] x {N}: its sum differs from the rows' sum")

        rows = {n: (lambda lib=lib: _launch(lib, table, idx)) for n, lib in libs.items()}
        rows["index_select"] = lambda: torch.index_select(table, 0, idx)
        for g in GRANULARITIES:
            for n, probe in probes.items():
                rows[f"{n}@{g}B"] = lambda probe=probe: ceiling(probe)
            rows[f"committed@{g}B"] = rows["committed"]
        _warm_up(rows["committed"])
        times, calls, set_to = {n: [] for n in rows}, {n: [] for n in rows}, {}
        for order in (list(rows), list(reversed(rows)), list(rows)):
            for n in order:
                g = int(n.rsplit("@", 1)[1][:-1]) if "@" in n else None
                if g is not None:
                    set_to[n] = _granularity(limit, g)
                try:
                    times[n].append(device_ms(rows[n], args.reps))
                    calls[n].append(call_ms(rows[n], args.reps))
                finally:
                    if g is not None:
                        _granularity(limit, default)
        gather.check_indices(device)
        bound = bounds_ms(F, N)
        for n in rows:
            ms = statistics.median(times[n])
            base = n.split("@")[0]
            print(json.dumps({
                "table": [T, F], "indices": N, "row": n,
                "probes": "torch.index_select" if n == "index_select" else about[base],
                "path": gather.row_gather_path(table) if base in libs else None,
                "l2_fetch_granularity": set_to.get(n, default),
                "ms": ms, "turns_ms": times[n], "call_ms": statistics.median(calls[n]), **bound,
                "pct_of_bytes_bound": 100 * bound["bound_ms"] / ms,
                "pct_of_sector_bound": 100 * bound["sector_bound_ms"] / ms,
            }), flush=True)
        del table, idx, want, chunks
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
