"""Trainer: one explicit device, one seeded generator, the training loop with its eval cadences,
logging and checkpoints (port of the JAX package's engine/trainer.py with one step per dispatch).

A step draws a host batch, runs the training forward and losses, back-propagates, sets every
group's learning rate from its schedule and applies the per-group optimizers; the RGB CNN's
batch-norm statistics are updated in the forward. ``train`` runs steps until ``step`` reaches
``max_num_iterations`` (a resumed run trains to it, not for that many more steps). ``step`` counts
the completed steps; after the step of 0-based index i has run, a cadence c > 0 fires when
i >= c and i % c == 0, so the first eval-batch of cadence 2 follows the third step. Events are
logged at that index i.

A checkpoint (``checkpoints/step-<step>.pt``, ``torch.save``) holds the model state (parameters and
batch-norm buffers), every group's optimizer state, ``step`` and the state of the generator the
steps draw their randomness from (the JAX package folds the step into its key instead). As in the
JAX package, the host batch sampler starts again from its seed on resume.

The shifted-view FID evals run after each step of ``pipeline.calc_fid_steps`` (0-based indices, 0
left out as in the JAX package).

Not ported: the viewer, the profiler, multi-device training, several steps per dispatch, gradient
accumulation, ``change_patch_sampler`` and the radar figure of the single-image eval.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from neuradar_tpu_torch.engine.optimizers import GroupedOptimizer, OptimizerGroupConfig, default_optimizer_groups
from neuradar_tpu_torch.model_components import radar_utils
from neuradar_tpu_torch.pipelines.ad_neuradar_pipeline import ADNeuRadarPipeline, ADNeuRadarPipelineConfig
from neuradar_tpu_torch.utils import trace
from neuradar_tpu_torch.utils.writer import EventWriter


@dataclass
class MetricTrackerConfig:
    metric: str = "psnr"
    maximize: bool = True  # a maximized metric is negated: the tracker keeps lower-is-better
    margin: float = 0.05
    patience: int = 3


class MetricTracker:
    """Best value with a relative margin, and a count of degradations past it."""

    def __init__(self, config: MetricTrackerConfig):
        self.config = config
        self.best: Optional[float] = None
        self.num_degradations = 0

    def update(self, value: float) -> bool:
        """True when the value is worse than the best by more than the margin."""
        if self.best is None or value < self.best:
            self.best = value
            self.num_degradations = 0
            return False
        # the margin scales with |best|, so it also works for a negated metric
        if value > self.best + self.config.margin * max(abs(self.best), 1e-8):
            self.num_degradations += 1
        return self.num_degradations > 0

    @property
    def should_stop(self) -> bool:
        return self.num_degradations >= self.config.patience


@dataclass
class TrainerConfig:
    method_name: str = "neuradar"
    experiment_name: str = "synthetic"
    output_dir: str = "outputs"
    pipeline: ADNeuRadarPipelineConfig = field(default_factory=ADNeuRadarPipelineConfig)
    optimizers: Optional[Dict[str, OptimizerGroupConfig]] = None
    max_num_iterations: int = 20001
    steps_per_eval_batch: int = 500
    steps_per_eval_image: int = 2000
    steps_per_eval_all_images: int = 20000
    steps_per_eval_all_radars: int = 20000
    steps_per_save: int = 10000
    steps_per_log: int = 100
    seed: int = 42
    save_only_latest_checkpoint: bool = True
    save_final_checkpoint: bool = True
    load_dir: Optional[str] = None
    early_stopping: bool = False
    tracker: MetricTrackerConfig = field(default_factory=MetricTrackerConfig)
    dataparser: Any = None  # a dataparser config with setup(); set by the method presets


class Trainer:
    def __init__(self, config: TrainerConfig, dataparser_outputs=None, device: Union[str, torch.device] = "cuda"):
        self.config = config
        self.device = torch.device(device)
        if dataparser_outputs is None:
            if config.dataparser is None:
                raise ValueError("TrainerConfig.dataparser or explicit dataparser outputs are required")
            dataparser_outputs = config.dataparser.setup().get_dataparser_outputs()
        self.dataparser_outputs = dataparser_outputs
        self.step = 0
        self.writer: Optional[EventWriter] = None  # made by train(), so a trainer alone writes no files
        self.tracker = MetricTracker(config.tracker)

    @property
    def run_dir(self) -> Path:
        return Path(self.config.output_dir) / self.config.experiment_name / self.config.method_name

    def setup(self, prefetch: bool = True) -> None:
        """Seeded model and per-group optimizers on the device, the step's generator, the checkpoint
        of ``load_dir`` if one is named, and (optionally) the batch prefetch thread."""
        cfg = self.config
        self.pipeline = ADNeuRadarPipeline(cfg.pipeline, self.dataparser_outputs, self.device, seed=cfg.seed)
        self.model = self.pipeline.model
        groups = cfg.optimizers or default_optimizer_groups(cfg.max_num_iterations)
        self.optimizer = GroupedOptimizer(self.model, groups)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._loss_fn = self.pipeline.make_train_loss_fn()
        self._eval_loss_fn = self.pipeline.make_eval_loss_fn()
        if cfg.load_dir:
            self.load_checkpoint(cfg.load_dir)
        if prefetch:
            self.pipeline.datamanager.start_prefetch()

    def train_step(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """One optimization step; returns (loss terms with their 'total', metrics) as detached
        device scalars. The span ``train/step`` covers it."""
        with trace.span("train/step", unit=True):
            batch = self.pipeline.datamanager.next_train()
            self.model.train()
            self.optimizer.zero_grad()
            with trace.span("train/forward"):
                total, loss_dict, metrics = self._loss_fn(batch, self.generator)
            total.backward()
            with trace.span("train/optimizer"):
                self.optimizer.step(self.step)
            self.step += 1
        return {"total": total.detach(), **{k: v.detach() for k, v in loss_dict.items()}}, metrics

    def eval_loss(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(loss terms with their 'total', metrics) of one eval-split batch, in eval mode."""
        self.model.eval()
        total, loss_dict, metrics = self._eval_loss_fn(self.pipeline.datamanager.sample_eval_batch())
        return {"total": total, **loss_dict}, metrics

    def train(self) -> Dict[str, float]:
        """Train to ``max_num_iterations`` with the eval, log and save cadences; returns the last
        logged scalars and eval metrics, with ``total_train_time``."""
        cfg = self.config
        if self.writer is None:
            self.writer = EventWriter(log_dir=self.run_dir / "logs")
        n_iters = max(cfg.max_num_iterations - self.step, 0)
        rays_per_batch = self.pipeline.layout.total
        last_metrics: Dict[str, float] = {}
        t_train_start = t_last_log = time.perf_counter()
        steps_since_log = 0
        for local_i in range(n_iters):
            losses, metrics = self.train_step()
            step = self.step - 1  # the index of the step that just ran
            steps_since_log += 1
            if (step + 1) % cfg.steps_per_log == 0 or step == 0 or local_i == n_iters - 1:
                scalars = {k: float(v) for k, v in {**losses, **metrics}.items() if k != "total"}
                scalars["loss"] = float(losses["total"])  # one host sync per log
                now = time.perf_counter()
                window = max(now - t_last_log, 1e-9)
                t_last_log = now
                scalars["train_rays_per_sec"] = rays_per_batch * steps_since_log / window
                scalars["iter_train_time"] = window / steps_since_log
                steps_since_log = 0
                self.writer.put_scalars(step, scalars)
                last_metrics = scalars

            t_aux = time.perf_counter()  # eval and save time stay out of the next rays/s window
            if _fires(cfg.steps_per_eval_batch, step):
                _, emetrics = self.eval_loss()
                self.writer.put_scalars(step, {f"eval_{k}": float(v) for k, v in emetrics.items()})
            if _fires(cfg.steps_per_eval_image, step):
                self._eval_single_image_and_radar(step)
            if _fires(cfg.steps_per_save, step):
                self.save_checkpoint()
            if _fires(cfg.steps_per_eval_all_radars, step):
                self.model.eval()
                radar_metrics = self.pipeline.get_average_eval_radar_metrics()
                self.writer.put_scalars(step, radar_metrics)
                last_metrics.update(radar_metrics)
            if step > 0 and step in cfg.pipeline.calc_fid_steps:  # after the step of that 0-based index
                self.model.eval()
                fid = self.pipeline.compute_fid_metrics()
                self.writer.put_scalars(step, fid)
                last_metrics.update(fid)
            if _fires(cfg.steps_per_eval_all_images, step):
                self.model.eval()
                img_metrics = self.pipeline.get_average_eval_image_metrics()
                img_metrics.update(self.pipeline.get_average_eval_lidar_metrics())
                self.writer.put_scalars(step, img_metrics)
                last_metrics.update(img_metrics)
                tracked = last_metrics.get(cfg.tracker.metric)  # a metric missing from this round is skipped
                if tracked is not None:
                    tracked = -float(tracked) if cfg.tracker.maximize else float(tracked)
                    if cfg.early_stopping and self.tracker.update(tracked) and self.tracker.should_stop:
                        break
            t_last_log += time.perf_counter() - t_aux

        last_metrics["total_train_time"] = time.perf_counter() - t_train_start
        if cfg.save_final_checkpoint:
            self.save_checkpoint()
        self.pipeline.datamanager.stop()
        return last_metrics

    def _eval_single_image_and_radar(self, step: int) -> None:
        """Render one eval image (PSNR, and the image as an event) and one eval radar scan (chamfer
        distance of the deterministic sample to the ground truth)."""
        self.model.eval()
        pipeline = self.pipeline
        scalars = {}
        cam_ids = pipeline.datamanager.eval_camera_indices()
        if len(cam_ids):
            cam_idx = int(cam_ids[self.step // max(self.config.steps_per_eval_image, 1) % len(cam_ids)])
            rgb = pipeline.render_camera(cam_idx)["rgb"].cpu().numpy()
            h, w = rgb.shape[:2]
            gt = pipeline.outputs.images[cam_idx].astype(np.float32) / 255.0
            mse = float(np.mean((rgb - gt[:h, :w]) ** 2))
            scalars["eval_image_psnr"] = -10.0 * np.log10(max(mse, 1e-10))
            self.writer.put_image(step, "eval_rgb", rgb)
        radar_ids = pipeline.datamanager.eval_radar_indices()
        if len(radar_ids):
            scan_idx = int(radar_ids[0])
            ro = pipeline.render_radar(scan_idx)["radar_output"]
            pts, keep = radar_utils.sample_radar_points(
                ro, "euclidean", threshold=pipeline.config.model.existence_probability_threshold)
            pred = pts[keep].cpu().numpy()
            gt_pts = pipeline.outputs.radar_points[scan_idx][:, :3]
            if len(pred) and len(gt_pts):
                scalars["eval_radar_chamfer"] = radar_utils.chamfer_distance_np(pred, gt_pts)
        if scalars:
            self.writer.put_scalars(step, scalars)

    def save_checkpoint(self) -> Path:
        """checkpoints/step-<step>.pt; with ``save_only_latest_checkpoint`` every older one goes."""
        ckpt_dir = self.run_dir / "checkpoints"
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        path = ckpt_dir / f"step-{self.step:09d}.pt"
        state = {
            "step": self.step,
            "model": self.model.state_dict(),
            "optimizers": {g: opt.state_dict() for g, opt in self.optimizer.optimizers.items()},
            "generator": self.generator.get_state(),
        }
        tmp = path.with_suffix(".tmp")
        torch.save(state, tmp)
        tmp.replace(path)  # a run cut during the write leaves no partial checkpoint under the name
        if self.config.save_only_latest_checkpoint:
            for old in sorted(ckpt_dir.glob("step-*.pt"))[:-1]:
                old.unlink()
        return path

    def load_checkpoint(self, load_dir: str) -> None:
        """The latest checkpoint under ``load_dir``."""
        candidates = sorted(Path(load_dir).glob("step-*.pt"))
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {load_dir}")
        path = candidates[-1]
        # on the CPU first: optimizer step counts stay there (torch keeps them on the host), the rest
        # is copied onto the parameters' device
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(state["model"])
        if sorted(state["optimizers"]) != sorted(self.optimizer.optimizers):
            raise ValueError(f"{path}: optimizer groups {sorted(state['optimizers'])}, "
                             f"expected {sorted(self.optimizer.optimizers)}")
        for g, opt in self.optimizer.optimizers.items():
            opt.load_state_dict(state["optimizers"][g])
        self.generator.set_state(state["generator"])
        self.step = int(state["step"])

    def shutdown(self) -> None:
        self.pipeline.datamanager.stop()
        if self.writer is not None:
            self.writer.close()


def _fires(cadence: int, step: int) -> bool:
    """Does a cadence fire after the step of 0-based index ``step``?"""
    return bool(cadence) and step >= cadence and step % cadence == 0
