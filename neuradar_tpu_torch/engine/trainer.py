"""Trainer: one explicit device, one seeded generator, one train step at a time
(port of the part of the JAX package's engine/trainer.py that a train step
reads: ``TrainerConfig``, ``Trainer.setup`` and the step itself).

A step draws a host batch, runs the training forward and losses, back-
propagates, sets every group's learning rate from its schedule and applies
the per-group optimizers; the RGB CNN's batch-norm statistics are updated in
the forward. Not ported: the viewer, multi-device training, checkpoints,
several steps per dispatch and gradient accumulation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.profiler import record_function

from neuradar_tpu_torch.engine.optimizers import GroupedOptimizer, OptimizerGroupConfig, default_optimizer_groups
from neuradar_tpu_torch.pipelines.ad_neuradar_pipeline import ADNeuRadarPipeline, ADNeuRadarPipelineConfig


@dataclass
class TrainerConfig:
    pipeline: ADNeuRadarPipelineConfig = field(default_factory=ADNeuRadarPipelineConfig)
    optimizers: Optional[Dict[str, OptimizerGroupConfig]] = None
    max_num_iterations: int = 20001
    seed: int = 42
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

    def setup(self, prefetch: bool = True) -> None:
        """Seeded model and per-group optimizers on the device, the step's generator, and
        (optionally) the batch prefetch thread."""
        cfg = self.config
        self.pipeline = ADNeuRadarPipeline(cfg.pipeline, self.dataparser_outputs, self.device, seed=cfg.seed)
        self.model = self.pipeline.model
        groups = cfg.optimizers or default_optimizer_groups(cfg.max_num_iterations)
        self.optimizer = GroupedOptimizer(self.model, groups)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._loss_fn = self.pipeline.make_train_loss_fn()
        self._eval_loss_fn = self.pipeline.make_eval_loss_fn()
        if prefetch:
            self.pipeline.datamanager.start_prefetch()

    def train_step(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """One optimization step; returns (loss terms with their 'total', metrics) as detached
        device scalars."""
        batch = self.pipeline.datamanager.next_train()
        self.model.train()
        self.optimizer.zero_grad()
        with record_function("train/forward"):
            total, loss_dict, metrics = self._loss_fn(batch, self.generator)
        total.backward()
        with record_function("train/optimizer"):
            self.optimizer.step(self.step)
        self.step += 1
        return {"total": total.detach(), **{k: v.detach() for k, v in loss_dict.items()}}, metrics

    def eval_loss(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(loss terms with their 'total', metrics) of one eval-split batch, in eval mode."""
        self.model.eval()
        total, loss_dict, metrics = self._eval_loss_fn(self.pipeline.datamanager.sample_eval_batch())
        return {"total": total, **loss_dict}, metrics

    def shutdown(self) -> None:
        self.pipeline.datamanager.stop()
