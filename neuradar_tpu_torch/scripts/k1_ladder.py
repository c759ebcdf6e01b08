"""K1 backward's ladder on the card: the committed kernel beside other sources of it, timed in turns.

    python -m neuradar_tpu_torch.scripts.k1_ladder [--baseline NAME=PATH ...] [--reps 20]

Builds ``csrc/composite_sky.cu`` and each ``--baseline`` source with the same C interface (an
earlier commit's composite_sky.cu, unpacked into a git-ignored directory, e.g. ``git archive
<commit> neuradar_tpu_torch/csrc/composite_sky.cu | tar -x -C build/parent``), each into its own
library under ``build/k1_ladder/`` (ops/build.build_each: one nvcc each, all started together).
Variants: the committed kernel's float4 path, its general path, and each baseline's
``composite_sky_bwd``. Rows: K1 backward at the train step's [113840, 33, 32] and at one of 8
chunks, [14230, 33, 32]. ``ms`` is the device time alone (utils/timing.device_ms: ``--reps``
launches queued behind a spin of the card, one event pair) and ``call_ms`` one launch's time with
its host work; each variant runs a row in turn, in order and then in reverse, and a row's times are
the medians over both turns. Each line also gives the bound (the bytes the function must move over
3.35 TB/s, the data-sheet rate of an NVIDIA H100 80GB HBM3 at 700.00 W), the share of it reached,
and the max abs error against the plain version. The first line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

import torch

from neuradar_tpu_torch.ops import build, volumetric
from neuradar_tpu_torch.utils.timing import call_ms, device_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
OUT_DIR = build.BUILD_DIR.parent / "k1_ladder"
ROWS = (("train", 113840), ("train, one of 8 chunks", 14230))
S, C = 33, 32


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", action="append", default=[], metavar="NAME=PATH",
                        help="another source of csrc/composite_sky.cu's C interface, built as it is")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_ladder measures the card; no CUDA device here")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)

    sources = {"committed": build.CSRC / "composite_sky.cu"}
    for spec in args.baseline:
        name, path = spec.split("=", 1)
        sources[name] = Path(path).resolve()
    libs = build.build_each(sources, OUT_DIR)
    # variant -> (source, path); a baseline's composite_sky_bwd is bound as the float4 launcher
    variants = {"committed float4": ("committed", "float4"), "committed general": ("committed", "general"),
                **{name: (name, "float4") for name in sources if name != "committed"}}

    gen = torch.Generator(device=device).manual_seed(0)
    for row, R in ROWS:
        alpha = torch.rand((R, S), generator=gen, device=device)
        feats = torch.randn((R, S, C), generator=gen, device=device)
        cots = (torch.randn((R, S), generator=gen, device=device), torch.randn((R, C), generator=gen, device=device),
                torch.randn((R, 1), generator=gen, device=device))
        want = volumetric.composite_sky_bwd_reference(alpha, feats, *cots)
        bound_ms = 4 * (2 * R * S * C + 3 * R * S + R * C + R) / HBM_BYTES_PER_S * 1e3

        def run(name):
            source, path = variants[name]
            return volumetric.launch_bwd(libs[source], alpha, feats, *cots, path)

        errs = {n: max(float((g - w).abs().max()) for g, w in zip(run(n), want)) for n in variants}
        times = {n: [] for n in variants}
        calls = {n: [] for n in variants}
        for order in (list(variants), list(reversed(variants))):
            for n in order:
                times[n].append(device_ms(lambda: run(n), args.reps))
                calls[n].append(call_ms(lambda: run(n), args.reps))
        for n in variants:
            ms = statistics.median(times[n])
            print(json.dumps({"variant": n, "source": str(sources[variants[n][0]]), "row": row, "shape": [R, S, C],
                              "ms": ms, "turns_ms": times[n], "call_ms": statistics.median(calls[n]), "bound_ms": bound_ms,
                              "share_of_bound": bound_ms / ms, "max_abs_err": errs[n]}), flush=True)
        del alpha, feats, cots, want
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
