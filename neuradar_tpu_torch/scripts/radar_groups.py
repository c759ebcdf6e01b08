"""Radar decode groups on the card: 1 group against the model's 4, in one process.

    python -m neuradar_tpu_torch.scripts.radar_groups [--groups 4 1] [--steps 2] [--reps 5] [--out FILE]

The grouping changes no output (a scan's decode reads no other scan, and K2's dropout hashes the
global scan index); it sets how many scans each radar decoder launch takes and, when training,
recomputes each group in the backward pass. For each program, "float32" (neuradar-synthetic at
full width and batch, the per-ray core unchunked as chip_smoke.py trains it) and "bf16"
(configs/bench_program.bench_pipeline_config("full", 8)), one seeded Trainer takes a warm-up step;
then each group count in turn, in the order A B B A, measures:

* the radar decoder alone (``NeuRadarModel._decode_radar``) on the step's 16 scans, forward and
  backward, and forward without gradients on the render path's 4 scans: median wall ms of
  ``--reps`` synchronized calls, and the peak memory above what was allocated before;
* ``--steps`` train steps: wall seconds (host clock around a synchronized step), peak memory, and
  the K2 launches of a step.

It prints one JSON line per program, count and turn, after one with the card's name and power
limit (nvidia-smi). ``--out`` also writes them all as one JSON file. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from neuradar_tpu_torch.configs.bench_program import bench_pipeline_config, bench_scene_outputs
from neuradar_tpu_torch.configs.method_configs import method_configs
from neuradar_tpu_torch.engine.optimizers import default_optimizer_groups
from neuradar_tpu_torch.engine.trainer import Trainer, TrainerConfig
from neuradar_tpu_torch.ops import attention

K2 = (attention.self_attention_fwd, attention.self_attention_bwd, attention.self_attention_bf16_fwd,
      attention.self_attention_bf16_bwd)
RENDER_SCANS = 4


def _synced(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _peak_above(fn) -> float:
    """GiB allocated at ``fn``'s peak beyond what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def _trainer(program: str) -> Trainer:
    if program == "float32":
        cfg = method_configs["neuradar-synthetic"]()
        cfg.pipeline.model.nff_chunks = 1
        outputs = cfg.dataparser.setup().get_dataparser_outputs()
    else:
        cfg = TrainerConfig(pipeline=bench_pipeline_config("full", chunks=8), optimizers=default_optimizer_groups(2001),
                            steps_per_eval_batch=0, steps_per_eval_image=0, steps_per_eval_all_images=0,
                            steps_per_eval_all_radars=0, steps_per_save=0, save_final_checkpoint=False,
                            output_dir="chiprun_out/radar_groups")
        outputs = bench_scene_outputs()
    trainer = Trainer(cfg, outputs, "cuda")
    trainer.setup()
    return trainer


def _measure(trainer: Trainer, groups: int, steps: int, reps: int) -> dict:
    model = trainer.model
    model.config.radar_decode_chunks = groups
    layout = trainer.pipeline.layout
    ns, nr = layout.num_radar_scans, layout.rays_per_scan
    gen = torch.Generator(device="cuda").manual_seed(0)
    feats = torch.randn((ns, nr, model.radar_decoder.d_model), generator=gen, device="cuda")
    geometry = 30.0 * torch.randn((ns, nr, 3), generator=gen, device="cuda")
    feats.requires_grad_(True)

    def train_decode():
        out, angles = model._decode_radar(feats, geometry, gen)
        torch.autograd.grad((out.sum() + angles.sum(),), (feats,))

    def render_decode():
        with torch.no_grad():
            model._decode_radar(feats[:RENDER_SCANS].detach(), geometry[:RENDER_SCANS], None)

    model.train()
    train_decode()
    rec = {"groups": groups, "scans": ns, "rays_per_scan": nr,
           "decoder_train_ms": 1e3 * statistics.median(_synced(train_decode) for _ in range(reps)),
           "decoder_train_peak_gb": _peak_above(train_decode)}
    model.eval()
    render_decode()
    rec.update(decoder_render_ms=1e3 * statistics.median(_synced(render_decode) for _ in range(reps)),
               decoder_render_peak_gb=_peak_above(render_decode))
    del feats, geometry
    walls, peaks, launches = [], [], []
    for _ in range(steps):
        for k in K2:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        walls.append(_synced(trainer.train_step))
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        launches.append({k.__name__: k.launches for k in K2 if k.launches})
    rec.update(step_s=walls, step_s_median=statistics.median(walls), rays_per_s=layout.total / statistics.median(walls),
               step_peak_gb=max(peaks), k2_launches_per_step=launches[-1])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, nargs=2, default=(4, 1), metavar=("A", "B"))
    ap.add_argument("--programs", nargs="+", choices=("float32", "bf16"), default=("float32", "bf16"))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("radar_groups: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi}), flush=True)
    records = []
    a, b = args.groups
    for program in args.programs:
        trainer = _trainer(program)
        trainer.train_step()  # warm-up
        for turn, groups in enumerate((a, b, b, a)):
            records.append({"program": program, "turn": turn, **_measure(trainer, groups, args.steps, args.reps)})
            print(json.dumps(records[-1]), flush=True)
        trainer.shutdown()
        del trainer
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "records": records}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
