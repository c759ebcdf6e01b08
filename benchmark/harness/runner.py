"""One run of a cell: set-up, the measured (or traced) window, the correctness check against the
plain reference, and the result.

``run_cell`` takes a ``Cell`` (the manifest's entries with the files they name) and returns the
result's fields, ``correct`` decided by ``limits/<workload>.json``. The traffic mix's ``kind`` names
the module ``kinds/<kind>.py`` of the benchmark's folder that drives it: a module with a ``run``
function drives the whole run itself (``kinds/train.py``); any other kind is served as requests by
``run_requests``, a closed loop of one client, from the module's ``requests``, ``serving``,
``numbers`` and ``RATE_METRIC`` (the name of its rays-per-second metric). The program is reached
only through ``harness/port.py``; the reference (``reference/nrref``) runs once the window has
closed, ``memory_peak_bytes`` has been read and the program's state is freed, with TF32 off.

With ``trace`` the window is instead ``trace_units`` steps or requests under ``torch.profiler``,
and the result carries the cell's per-layer metrics, the device's busy and window seconds and the
breakdown; the chrome trace and the per-label device ms go to ``build/bench/`` in the checkout.
"""

from __future__ import annotations

import gc
import gzip
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from harness import traceio
from harness.manifest import load_kind, load_reader
from harness.scene import make_scene
from harness.weights import fill_weights
from reference.nrref import lowp
from reference.nrref.pipeline import ReferencePipeline, model_config

MAX_REQUESTS = 100000
# the host ranges whose kernels a reader may ask for: the port's own, and the RGB decoder's operators
LABELS = tuple(sorted(traceio.PORT_RANGES)) + ("aten::convolution", "aten::batch_norm")


@dataclass
class Cell:
    workload: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    per_layer: List[Dict] = field(default_factory=list)  # the manifest's per-layer entries of this cell
    end_to_end: List[Dict] = field(default_factory=list)
    bench: Path = Path(__file__).resolve().parent.parent  # the folder of the kinds and metric readers


@dataclass
class RunArgs:
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    control: bool = False
    out_dir: Optional[Path] = None  # where a traced run writes its trace
    started: float = field(default_factory=time.time)  # the process's start, epoch seconds


@dataclass
class Serving:
    """What a kind of request gives the closed loop, for one cell."""

    rays: int  # rays a request renders
    unit_flops: float  # model FLOPs of a request
    layout: object  # the reference's SegmentLayout of a request, for the trace's readers
    serve: Callable  # request -> the program's answer on the host
    reference: Callable  # (ReferencePipeline, request) -> the reference's answer


def process_start() -> float:
    """The epoch second this process started (from /proc), or now where /proc has no answer."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        boot = next(float(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def sub_seeds(seed: int) -> Dict[str, int]:
    """Independent 32-bit seeds of the run's parts, from ``seed`` (any non-negative integer)."""
    names = ("sampler", "weights", "traffic", "sample")
    return dict(zip(names, (int(v) for v in np.random.SeedSequence(int(seed)).generate_state(len(names)))))


def reference_config(config: Dict):
    return model_config(config["model"])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free() -> None:
    """Give the freed program's device memory back before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


_TF32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)  # torch's defaults


def plain_math(on: bool = True) -> None:
    """TF32 off for the reference; ``on=False`` gives the program torch's defaults back."""
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = (False, False) if on else _TF32


def reference_pipeline(cell: Cell, scene, seeds: Dict[str, int], drawn: List[str], device) -> ReferencePipeline:
    """The reference of the cell's configuration on ``scene``, with the seed's weights (the same
    tree as the program's, ``drawn``)."""
    plain_math()
    ref = ReferencePipeline(reference_config(cell.config), cell.config["batch"], scene, device)
    if fill_weights(ref.model, seeds["weights"], float(cell.config["weights"]["hash_table_scale"])) != drawn:
        raise RuntimeError("the reference's parameter tree differs from the port's")
    return ref


class Tracer:
    """torch.profiler over a window of units; writes the chrome trace and the label table."""

    def __init__(self, args: RunArgs):
        self.args = args
        acts = [torch.profiler.ProfilerActivity.CPU]
        if args.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def finish(self, cell: Cell, units: int, window_s: float, layout, cfg, unit_flops: float) -> Dict:
        t0 = time.perf_counter()
        view = traceio.trace_view(self.prof, layout, cfg, units, window_s * 1e6, LABELS, unit_flops)
        t_view = time.perf_counter() - t0
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"], cell.bench)(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        out = {"metrics": metrics, "busy_s": view.busy_us / 1e6, "window_s": window_s,
               "breakdown": traceio.breakdown(self.prof, view)}
        t_breakdown = time.perf_counter() - t0 - t_view
        if self.args.out_dir is not None:
            self.args.out_dir.mkdir(parents=True, exist_ok=True)
            stem = self.args.out_dir / cell.workload["name"]
            self.prof.export_chrome_trace(str(stem) + ".trace.json.gz")
            labels = {k: {n[:100]: us / 1e3 for n, us in v.items()} for k, v in view.labels.items()}
            with gzip.open(str(stem) + ".labels.json.gz", "wt") as f:
                json.dump({"units": units, "window_s": window_s, "busy_s": out["busy_s"], "label_kernel_ms": labels}, f)
        out["reading_s"] = {"events": t_view, "breakdown": t_breakdown, "all": time.perf_counter() - t0}
        return out


def run_cell(cell: Cell, args: RunArgs, port) -> Dict:
    """The result's fields of one run; ``port`` is ``harness.port`` (the system under test)."""
    plain_math(False)
    kind = load_kind(cell.traffic["kind"], cell.bench)
    if hasattr(kind, "run"):
        return kind.run(cell, args, port)
    return run_requests(cell, args, port, kind)


def checks(numbers: Dict, limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in limits}


def correct(found: Dict[str, Dict[str, float]]) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in found.values())


def run_requests(cell: Cell, args: RunArgs, port, kind) -> Dict:
    """A closed loop of one client: set-up builds the pipeline, writes the weights and serves
    ``warmup`` requests; the window serves one request after another, each timed from its send until
    its answer is on the host, until ``seconds`` have passed. Once the window has closed, a sample of
    the finished requests drawn from the seed is answered again by the reference, and the kind's
    ``numbers`` compare the two."""
    config, device, seeds, tr = cell.config, args.device, sub_seeds(args.seed), cell.traffic
    scene = make_scene(config["scene"])
    pipeline = port.build_pipeline(config, scene, seeds["sampler"], device)
    drawn = fill_weights(pipeline.model, seeds["weights"], float(config["weights"]["hash_table_scale"]))
    cfg = reference_config(config)
    serving = kind.serving(pipeline, tr, cfg, port)
    warmup = int(tr["warmup"])
    count = warmup + (int(tr["trace_units"]) if args.trace else MAX_REQUESTS)
    reqs = kind.requests(tr, scene, seeds["traffic"], count)
    for req in reqs[:warmup]:
        serving.serve(req)
    sync(device)
    setup_s = time.time() - args.started

    outs, lat = [], []

    def closed_loop() -> float:
        """One request after another until ``seconds`` have passed (traced: until the requests
        run out); returns the window's length."""
        t0 = t_end = time.perf_counter()
        for req in reqs[warmup:]:
            if not args.trace and t_end - t0 >= args.seconds:
                break
            sent = time.perf_counter()
            outs.append(serving.serve(req))
            t_end = time.perf_counter()
            lat.append(t_end - sent)
        return t_end - t0

    if args.trace:
        tracer = Tracer(args)
        with tracer:
            window = closed_loop()
        traced = tracer.finish(cell, len(outs), window, serving.layout, cfg, serving.unit_flops)
    else:
        window = closed_loop()
    peak = peak_bytes(device)
    done = reqs[warmup:warmup + len(outs)]
    failed = int(sum(not np.all(np.isfinite(o)) for o in outs))
    answer, rays = serving.reference, serving.rays
    del pipeline, serving
    free()

    ref = reference_pipeline(cell, scene, seeds, drawn, device)
    rng = np.random.RandomState(seeds["sample"])
    sample = sorted(rng.choice(len(outs), size=min(int(tr["checked"]), len(outs)), replace=False).tolist())
    refs = [answer(ref, done[i]) for i in sample]
    numbers = kind.numbers([outs[i] for i in sample], refs)
    control = None
    if args.control:
        with lowp.float8_weights():
            control = kind.numbers([answer(ref, done[i]) for i in sample], refs)

    found = checks(numbers, cell.limits)
    result = {"correct": correct(found), "attempted": len(outs), "failed": failed, "peak": peak, "checks": found,
              "control": control}
    if args.trace:
        result.update(traced)
    else:
        result["metrics"] = {kind.RATE_METRIC: len(outs) * rays / window, "setup_s": setup_s,
                             "peak_mem_gb": peak / 1e9,
                             "request_ms_p95": float(np.percentile(np.asarray(lat) * 1e3, 95))}
    return result
