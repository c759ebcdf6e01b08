"""Profile the port's neuradar-synthetic train step at full width on one GPU.

    python -m neuradar_tpu_torch.scripts.profile_train [--nff-chunks 1] [--compute-dtype bfloat16]
        [--radar-decode-chunks 4] [--steps 5] [--out FILE] [--path.to.field value]...

Dotted overrides after the flags change the preset as scripts/train.py's do (for the set radar
decoder: ``--pipeline.model.radar_decoder_type set --pipeline.model.loss.radar_set_loss detr``).

Builds the seeded trainer at the preset's full width and batch, runs one
warm-up step, times ``--steps`` untraced steps (host clock around a
synchronized step; median, min, max), then traces one more step with
torch.profiler. It prints, as JSON lines: the wall times and peak memory;
the traced step's device busy time (the union of its kernel intervals) and
idle share (1 - busy / wall); the device time of the kernels launched inside
each labelled range (train/forward, train/optimizer, and the model's layers:
proposal_sampling, field, hash_encode, composite_sky, rgb_decoder,
radar_decoder, losses; a layer's time sums its forward and, with
nff_chunks > 1, its recompute in the backward pass), and beside it the
range's span on the device, first kernel to last, which the profiler's key
averages report for some ranges in its place; the backward's device time,
which is the busy time less the forward and the optimizer (autograd runs the
backward on its own device thread, outside the step's labelled ranges); the
largest kernels under each model layer's label; the kernels with the
most device time overall; and each of the port's hand-written kernels
(K1, K2, K3, P1) that ran in the step, with its calls and device ms per
call, to hold beside chip_smoke.py's kernel times. ``--out`` also writes the whole record as one JSON file. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from neuradar_tpu_torch.configs.cli import parse_overrides
from neuradar_tpu_torch.configs.method_configs import method_configs
from neuradar_tpu_torch.engine.trainer import Trainer

# name fragments of the hand-written kernels in csrc/ (K1 forward and backward, K3, K2 in float32 and bf16, P1)
PORT_KERNELS = ("composite_sky", "composite_fwd", "attention_", "row_gather")
LABELS = ("train/forward", "train/optimizer", "proposal_sampling", "field", "hash_encode", "composite_sky",
          "rgb_decoder", "radar_decoder", "losses")


def _busy_ms(events) -> float:
    """Union of the device kernel intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3  # us -> ms


def _kernels_under(events, label: str, top: int) -> dict:
    """The kernels launched inside the CPU ranges named ``label``: their summed device ms, and the
    ``top`` of them by device ms (the label's own breakdown); and the device-side span that the
    profiler records for the same label (first kernel's start to last kernel's end)."""
    sums = {}

    def walk(e):
        for k in e.kernels:
            name = k.name[:120]
            sums[name] = sums.get(name, 0.0) + k.duration / 1e3
        for child in e.cpu_children:
            walk(child)

    span_us = 0.0
    for e in events:
        if e.name == label and e.device_type == torch.autograd.DeviceType.CPU:
            walk(e)
        elif e.name == label:
            span_us += e.time_range.elapsed_us()
    return {"kernel_ms": sum(sums.values()), "device_span_ms": span_us / 1e3,
            "top": [{"name": n, "device_ms": ms} for n, ms in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]}


def _step(trainer: Trainer) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nff-chunks", type=int, default=1)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--compute-dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--radar-decode-chunks", type=int, default=None, help="default: the model's (4)")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=None)
    args, overrides = ap.parse_known_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = method_configs["neuradar-synthetic"]()
    cfg.pipeline.model.nff_chunks = args.nff_chunks
    cfg.pipeline.model.compute_dtype = args.compute_dtype
    if args.radar_decode_chunks is not None:
        cfg.pipeline.model.radar_decode_chunks = args.radar_decode_chunks
    parse_overrides(cfg, overrides)
    trainer = Trainer(cfg, cfg.dataparser.setup().get_dataparser_outputs(), "cuda")
    trainer.setup()
    rays = trainer.pipeline.layout.total
    record = {"card": smi, "rays_per_step": rays, "nff_chunks": args.nff_chunks,
              "compute_dtype": args.compute_dtype,
              "radar_decode_chunks": cfg.pipeline.model.radar_decode_chunks, "overrides": overrides,
              "warmup_s": _step(trainer)}
    torch.cuda.reset_peak_memory_stats()
    walls = [_step(trainer) for _ in range(args.steps)]
    record.update(wall_s_median=statistics.median(walls), wall_s_min=min(walls), wall_s_max=max(walls),
                  rays_per_s_median=rays / statistics.median(walls),
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    print(json.dumps({"phase": "wall", **record}), flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_wall = _step(trainer)
    events = prof.events()
    busy = _busy_ms(events)
    layers = {label: _kernels_under(events, label, 8) for label in LABELS}
    labels = {label: layer["kernel_ms"] for label, layer in layers.items()}
    on_device = [a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CUDA]
    kernels = sorted(on_device, key=lambda a: a.self_device_time_total, reverse=True)[:args.top]
    port = [{"name": a.key[:120], "calls": a.count, "device_ms": a.self_device_time_total / 1e3,
             "device_ms_per_call": a.self_device_time_total / 1e3 / a.count}
            for a in on_device if a.key not in LABELS and any(k in a.key for k in PORT_KERNELS)]
    trace = {"traced_wall_ms": traced_wall * 1e3, "device_busy_ms": busy,
             "idle_share": 1.0 - busy / (traced_wall * 1e3), "label_device_ms": labels,
             "label_device_span_ms": {label: layer["device_span_ms"] for label, layer in layers.items()},
             "backward_device_ms": busy - labels["train/forward"] - labels["train/optimizer"],
             "label_kernels": {label: layers[label]["top"] for label in LABELS[2:]},
             "top_kernels": [{"name": a.key[:120], "device_ms": a.self_device_time_total / 1e3, "calls": a.count}
                             for a in kernels],
             "port_kernels": port}
    print(json.dumps({"phase": "trace", **trace}), flush=True)
    trainer.shutdown()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**record, **trace}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
