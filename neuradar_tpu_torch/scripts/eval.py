"""Eval entry point of the port: reload a run's config and latest checkpoint, compute the image,
lidar and radar metrics of the eval split, and write them as JSON.

    python -m neuradar_tpu_torch.scripts.eval --load-config <run dir> [--output-path eval_output.json]
        [--radar-sampling-rounds 10] [--device cpu]

The output holds ``results`` (every metric) and ``seconds`` (the wall time of each family).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Union

import torch


def load_trainer(run_dir: Path, device: Union[str, torch.device] = "cuda"):
    """The trainer of a run directory, set up from its config.json and its latest checkpoint."""
    from neuradar_tpu_torch.configs.cli import apply_config_dict
    from neuradar_tpu_torch.configs.method_configs import get_method
    from neuradar_tpu_torch.engine.trainer import Trainer

    cfg_json = json.loads((run_dir / "config.json").read_text())
    config = get_method(cfg_json.get("method_name", "neuradar-synthetic"))
    apply_config_dict(config, cfg_json)
    config.output_dir = str(run_dir.parent.parent)
    config.experiment_name = run_dir.parent.name
    config.load_dir = str(run_dir / "checkpoints")
    trainer = Trainer(config, device=device)
    trainer.setup(prefetch=False)
    return trainer


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--load-config", type=Path, required=True,
                        help="run directory holding config.json and checkpoints/")
    parser.add_argument("--output-path", type=Path, default=Path("eval_output.json"))
    parser.add_argument("--radar-sampling-rounds", type=int, default=10)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    run_dir = args.load_config if args.load_config.is_dir() else args.load_config.parent
    trainer = load_trainer(run_dir, args.device)
    pipeline = trainer.pipeline
    trainer.model.eval()
    results, seconds = {}, {}
    for family, fn in (("image", pipeline.get_average_eval_image_metrics),
                       ("lidar", pipeline.get_average_eval_lidar_metrics),
                       ("radar", lambda: pipeline.get_average_eval_radar_metrics(args.radar_sampling_rounds))):
        t0 = time.perf_counter()
        results.update(fn())
        seconds[family] = time.perf_counter() - t0
    trainer.shutdown()
    out = {
        "experiment": trainer.config.experiment_name,
        "method": trainer.config.method_name,
        "checkpoint_step": trainer.step,
        "device": str(trainer.device),
        "results": results,
        "seconds": seconds,
    }
    args.output_path.parent.mkdir(parents=True, exist_ok=True)
    args.output_path.write_text(json.dumps(out, indent=2))
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
