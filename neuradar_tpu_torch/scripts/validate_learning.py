"""Learning check of the port: train NeuRadar briefly on the synthetic scene, bf16 (``--no-bf16``:
float32), and check that it learns.

    python -m neuradar_tpu_torch.scripts.validate_learning --scale tiny --iters 300 --eval-every 50

PASS when camera PSNR rises and the lidar depth loss and the radar loss fall from the mean of the
first quarter of the logged steps to that of the last quarter (the total loss is reported, not
required: its weighted terms trade off against each other). ``--eval-every N`` also runs an eval
batch and the single-image / radar eval every N steps and writes every logged scalar as [step,
value] curves, with the keys of the JAX package's curves, to ``--curve-output``. Scales: ``tiny``
(CPU-speed shapes: 512 rays a step, small hash tables, a shrunk radar FoV), ``micro`` (~6.6k rays),
``small`` (a quarter batch), ``full``. It trains on the card unless ``--device`` says otherwise.
As the JAX package's check: ``compute_dtype`` bfloat16 by default (the dtype of its banked curve),
the VGG loss off. ``--set-decoder`` trains the DETR-style set radar decoder (``radar_decoder_type``
"set", with the multi-Bernoulli loss, ``radar_set_loss`` "mb"); ``--radar-assignment hungarian``
associates the radar points by scipy's exact Hungarian on the host instead of the auction. The
report and the curves record both.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

_BATCHES = {  # ADDataManagerConfig fields per scale
    "tiny": dict(num_rgb_patches=2, patch_size=8, num_lidar_rays=256, num_radar_scans=2, max_radar_gt=32),
    "micro": dict(num_rgb_patches=2, patch_size=32, num_lidar_rays=1029, num_radar_scans=1, max_radar_gt=128),
    "small": dict(num_rgb_patches=10, patch_size=32, num_lidar_rays=4100, num_radar_scans=4, max_radar_gt=256),
    "full": dict(num_rgb_patches=40, patch_size=32, num_lidar_rays=16384, num_radar_scans=16, max_radar_gt=256),
}
_PASS_KEYS = ("psnr", "depth_loss", "radar_loss")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=300)
    parser.add_argument("--scale", choices=tuple(_BATCHES), default="full")
    parser.add_argument("--chunks", type=int, default=8, help="nff_chunks (the tiny scale runs 1)")
    parser.add_argument("--eval-every", type=int, default=0)
    parser.add_argument("--output-dir", default="outputs/learning_check")
    parser.add_argument("--output", default="", help="the report (default: <run dir>/learning_check.json)")
    parser.add_argument("--curve-output", default="", help="default: <run dir>/learning_curve.json")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                        help="--no-bf16 runs the check in float32")
    parser.add_argument("--set-decoder", action="store_true",
                        help="the DETR-style set radar decoder (radar_decoder_type 'set')")
    parser.add_argument("--radar-assignment", choices=("auction", "hungarian"), default=None,
                        help="the radar association (default: the model's, 'auction')")
    args = parser.parse_args(argv)

    from neuradar_tpu_torch.data.datamanager import ADDataManagerConfig
    from neuradar_tpu_torch.data.dataparsers.synthetic import SyntheticDataParser, SyntheticDataParserConfig
    from neuradar_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from neuradar_tpu_torch.pipelines.ad_neuradar_pipeline import ADNeuRadarPipelineConfig

    pipe = ADNeuRadarPipelineConfig(datamanager=ADDataManagerConfig(**_BATCHES[args.scale]))
    m = pipe.model
    m.nff_chunks = args.chunks
    m.loss.vgg_mult = 0.0
    m.compute_dtype = "bfloat16" if args.bf16 else "float32"
    if args.scale == "tiny":
        m.field.grid.static.log2_hashmap_size = 12
        m.field.grid.actor.log2_hashmap_size = 10
        for pf in (m.sampling.proposal_field_1, m.sampling.proposal_field_2):
            pf.grid.static.log2_hashmap_size = 11
            pf.grid.actor.log2_hashmap_size = 9
        m.sampling.num_proposal_samples = (16, 8)
        m.sampling.num_nerf_samples = 6
        m.nff_chunks = 1
    if args.set_decoder:
        m.radar_decoder_type = "set"
    if args.radar_assignment:
        m.loss.radar_assignment = args.radar_assignment
    cfg = TrainerConfig(
        pipeline=pipe,
        max_num_iterations=args.iters,
        steps_per_eval_batch=args.eval_every,
        steps_per_eval_image=args.eval_every,
        steps_per_eval_all_images=0,
        steps_per_eval_all_radars=0,
        steps_per_save=0,
        save_final_checkpoint=False,
        steps_per_log=10,
        # a new run directory per call: the event log appends, and another run's events would
        # enter the quarter means
        experiment_name=time.strftime("learning_check_%Y%m%d_%H%M%S"),
        output_dir=args.output_dir,
    )
    if args.scale == "tiny":
        outputs = SyntheticDataParser(SyntheticDataParserConfig(
            num_frames=8, image_height=48, image_width=72, lidar_points_per_scan=512)).get_dataparser_outputs()
        outputs.radar_fov = dict(min_azimuth=-0.8, max_azimuth=0.8, min_elevation=-0.08, max_elevation=0.32,
                                 azimuth_step=0.1, elevation_step=0.1)  # 16 x 4 rays a scan
    else:
        outputs = SyntheticDataParser(SyntheticDataParserConfig(
            num_frames=24, image_height=96, image_width=156, lidar_points_per_scan=32768)).get_dataparser_outputs()
    trainer = Trainer(cfg, outputs, args.device)
    trainer.setup()
    try:
        trainer.train()
    finally:
        trainer.shutdown()

    events = [json.loads(line) for line in open(trainer.writer.log_path)]

    def series(key):
        return [(e["step"], e[key]) for e in events if key in e]

    report = {"set_decoder": args.set_decoder, "radar_assignment": m.loss.radar_assignment}
    for key, direction in (("loss", -1), ("psnr", 1), ("depth_loss", -1), ("radar_loss", -1)):
        vals = series(key)
        if len(vals) < 4:
            report[key] = "missing"
            continue
        q = max(len(vals) // 4, 1)
        first = sum(v for _, v in vals[:q]) / q
        last = sum(v for _, v in vals[-q:]) / q
        report[key] = {"first": round(first, 5), "last": round(last, 5), "improved": bool((last - first) * direction > 0)}
    run_dir = trainer.run_dir
    if args.eval_every:
        curve_keys = sorted({k for e in events for k in e if k != "step"})
        curve_path = Path(args.curve_output or run_dir / "learning_curve.json")
        curve_doc = {"scale": args.scale, "iters": args.iters, "dtype": m.compute_dtype,
                     "eval_every": args.eval_every, "device": str(trainer.device),
                     "set_decoder": args.set_decoder, "radar_assignment": m.loss.radar_assignment,
                     "curves": {k: series(k) for k in curve_keys}}
        curve_path.write_text(json.dumps(curve_doc))
        report["curve_output"] = str(curve_path)
        report["curve_keys"] = curve_keys

    print(json.dumps(report, indent=2))
    Path(args.output or run_dir / "learning_check.json").write_text(json.dumps(report, indent=2))
    ok = all(isinstance(report.get(k), dict) and report[k]["improved"] for k in _PASS_KEYS)
    print("LEARNING CHECK:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
