"""The benchmark of neuradar_tpu_torch (the PyTorch and CUDA port) on NVIDIA GPUs.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1> [--control 1]

Run from the root of a checkout that holds ``BENCHMARK.json``. It runs one cell of the manifest on
the first card (cells ask for one), prints the compared numbers beside their limits as the last
lines of standard error, and prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``. ``--control 1`` also runs the reference in float8 (the precision control) and prints its
numbers under ``control``; the benchmark's own runs leave it off.

It exits with another code than 0, and prints no result, where no CUDA card is there or fewer than the
cell asks for, where the port cannot be imported, and where JAX, flax or the JAX package is loaded
once the window has closed. Build and kernel caches stay in ``build/`` of the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from harness.runner import process_start  # noqa: E402  (the benchmark's own modules, after the path)

FORBIDDEN = ("jax", "jaxlib", "flax", "neuradar_tpu")


def loaded_forbidden() -> list:
    """Modules whose top-level name (the part before the first dot) is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def execute(workload: str, seed: int, seconds: float, trace: bool, device, root: Path, control: bool = False,
            started: float = None, bench: Path = HERE):
    """One run of ``workload`` on ``device`` from the manifest at ``root`` and the benchmark's files
    in ``bench``: (result line, lines for standard error)."""
    from harness import manifest as mf
    from harness.runner import Cell, RunArgs, run_cell

    manifest = mf.load_manifest(root)
    w = mf.find(manifest["workloads"], workload, "workload")
    c = mf.find(manifest["configs"], w["config"], "configuration")
    cell = Cell(workload=w, config=json.loads((root / c["file"]).read_text()),
                traffic=mf.load_json("traffic", w["traffic"], bench), limits=mf.load_json("limits", workload, bench),
                per_layer=mf.cell_metrics(manifest, workload, "per_layer"),
                end_to_end=mf.cell_metrics(manifest, workload, "end_to_end"), bench=bench)
    from harness import port  # the system under test

    args = RunArgs(seed=seed, seconds=seconds, trace=trace, device=device, control=control,
                   out_dir=root / "build" / "bench" if trace else None)
    if started is not None:
        args.started = started
    result = run_cell(cell, args, port)
    wanted = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in wanted}
    metrics = {name: {"value": m if isinstance(m, float) else m["value"], "unit": units[name]}
               for name, m in result["metrics"].items() if name in units}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch_device_name(device), "count": int(w["chips"]), "memory_peak_bytes": result["peak"]}
    if trace:
        dev.update(busy_s=result["busy_s"], window_s=result["window_s"])
    line = {"correct": bool(result["correct"]), "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": dev}
    if trace:
        line["breakdown"] = result["breakdown"]
    if result.get("control") is not None:
        line["control"] = result["control"]
    line["checks"] = result["checks"]
    err = [f"trace read in {result['reading_s']}"] if trace else []
    err += [f"worst leaf of {k}: {leaf}" for k, leaf in result.get("worst_leaf", {}).items()]
    err += [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in result["checks"].items()]
    if result.get("control") is not None:
        err += [f"control {k}: {v!r}" for k, v in result["control"].items()]
    return line, err


def torch_device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    sys.path.insert(1, str(root))  # the port's package, at the checkout's root
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

    from harness import manifest as mf

    try:
        w = mf.find(mf.load_manifest(root)["workloads"], args.workload, "workload")
    except (FileNotFoundError, KeyError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(f"benchmark: {args.workload} needs {w['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} here", file=sys.stderr)
        return 1
    try:
        line, err = execute(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), root,
                            bool(args.control), started)
    except ImportError as e:
        print(f"benchmark: the port cannot be imported here: {e}", file=sys.stderr)
        return 1
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    for text in err:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
