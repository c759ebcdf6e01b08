"""Row-gather microbenchmark (kernel P1) on the card, from the [4096, 8] x 1,024 probe of the JAX
package's tools/probe_mosaic_gather.py up to one static hash grid's table, [8 * 2^22, 4] float32
(512 MiB, 16-byte rows), gathered at 2^22 random indices.

    python -m neuradar_tpu_torch.scripts.probe_gather [--reps 20]

One JSON line per shape: the kernel alone (``kernel_ms``), the wrapper with its index check
(``ms``), ``torch.index_select`` on the same inputs (``library_ms``), and two bounds at the card's
3.35 TB/s: by the bytes the gather needs (``bound_ms``: a row read, a row written and 4 index
bytes per index) and by the 32-byte sectors a random read costs (``sector_bound_ms``). Times are
medians of CUDA-event timed launches after warm-up. The first line names the card and its power
limit. The indices are uniform at random, as a hash grid's corners are.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess

import torch

from neuradar_tpu_torch.ops import gather

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SHAPES = (  # (table rows, features, indices)
    (4096, 8, 1024),
    (2**16, 8, 2**16),
    (2**20, 4, 2**20),
    (2**22, 4, 2**22),
    (8 * 2**22, 4, 2**22),
)


def _time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_gather measures the card; no CUDA device here")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    for T, F, N in SHAPES:
        table = torch.randn((T, F), generator=gen, device=device)
        idx = torch.randint(0, T, (N,), generator=gen, device=device, dtype=torch.int32)
        if not torch.equal(gather.row_gather(table, idx), gather.row_gather_reference(table, idx)):
            raise RuntimeError(f"[{T}, {F}] x {N}: the kernel differs from its plain version")
        need = N * (2 * F * 4 + 4)
        sectors = N * (math.ceil(F * 4 / 32) * 32 + F * 4 + 4)
        kernel_ms = _time_ms(lambda: gather._launch(table, idx), args.reps)
        print(json.dumps({
            "table": [T, F], "indices": N, "table_mib": T * F * 4 / 2**20,
            "kernel_ms": kernel_ms,
            "ms": _time_ms(lambda: gather.row_gather(table, idx), args.reps),
            "library_ms": _time_ms(lambda: torch.index_select(table, 0, idx), args.reps),
            "bound_ms": need / HBM_BYTES_PER_S * 1e3, "sector_bound_ms": sectors / HBM_BYTES_PER_S * 1e3,
            "kernel_gb_per_s": need / kernel_ms / 1e6,
        }), flush=True)
        del table, idx
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
