"""Row-gather microbenchmark (kernel P1) on the card, from the [4096, 8] x 1,024 probe of the JAX
package's tools/probe_mosaic_gather.py up to one static hash grid's table, [8 * 2^22, 4] float32
(512 MiB, 16-byte rows), gathered at 2^22 random indices.

    python -m neuradar_tpu_torch.scripts.probe_gather [--reps 20]

One JSON line per shape: the kernel's path (``path``, ops.gather.row_gather_path), the wrapper's
device time alone (``ms``, utils/timing.device_ms: launches queued behind a spin of the card, one
event pair; the wrapper checks the indices on the card and never syncs), one call's time with its host work (``call_ms``), ``torch.index_select`` on the same
inputs (``library_ms``, device time), and two bounds at 3.35 TB/s (the data-sheet rate of an NVIDIA
H100 80GB HBM3 at 700.00 W): by the bytes the gather needs (``bound_ms``: a row read, a row written
and 4 index bytes per index) and by the 32-byte sectors a random read costs (``sector_bound_ms``).
The first line names the card and its power limit. The indices are uniform at random, as a hash
grid's corners are.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from neuradar_tpu_torch.ops import gather
from neuradar_tpu_torch.utils.timing import call_ms, device_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SHAPES = (  # (table rows, features, indices)
    (4096, 8, 1024),
    (2**16, 8, 2**16),
    (2**20, 4, 2**20),
    (2**22, 4, 2**22),
    (8 * 2**22, 4, 2**22),
)


def bounds_ms(F: int, N: int) -> dict:
    """The two bounds of a gather of N rows of F floats at HBM_BYTES_PER_S: by the bytes it needs (a row
    read, a row written and 4 index bytes per index) and by the 32-byte sectors a random read costs."""
    need = N * (2 * F * 4 + 4)
    sectors = N * (math.ceil(F * 4 / 32) * 32 + F * 4 + 4)
    return {"bound_ms": need / HBM_BYTES_PER_S * 1e3, "sector_bound_ms": sectors / HBM_BYTES_PER_S * 1e3}


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
        ms = device_ms(lambda: gather.row_gather(table, idx), args.reps)
        print(json.dumps({
            "table": [T, F], "indices": N, "table_mib": T * F * 4 / 2**20, "path": gather.row_gather_path(table),
            "ms": ms, "call_ms": call_ms(lambda: gather.row_gather(table, idx), args.reps),
            "library_ms": device_ms(lambda: torch.index_select(table, 0, idx), args.reps),
            **bounds_ms(F, N), "gb_per_s": N * (2 * F * 4 + 4) / ms / 1e6,
        }), flush=True)
        gather.check_indices(device)
        del table, idx
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
