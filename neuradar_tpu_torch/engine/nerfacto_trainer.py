"""Nerfacto's trainer (port of the JAX package's engine/nerfacto_trainer.py, the camera model).

A step draws ``num_rgb_patches`` patches of ``patch_size`` x ``patch_size`` pixels from the train
frames (``ADDataManager`` with one ray a pixel, no lidar rays, no radar scans; its sampler seeded by
``seed``), generates their rays on the device, and takes one Adam step (eps 1e-15, optax's) over
every parameter at a rate ramped linearly from 1e-8 over ``warmup_steps`` and then decayed
log-linearly from ``lr_init`` to ``lr_final`` at ``max_num_iterations``. The proposal weights'
anneal exponent follows the step. All of this is ``train_step``, the call that ``train`` loops over
and the benchmark times; its spans are ``train/step``, ``train/forward`` and ``train/optimizer``.

``train`` runs to ``max_num_iterations`` with the log and eval-batch cadences and saves
``checkpoints/nerfacto.pt`` (the step, the parameters, Adam's state and the generator; the JAX
trainer writes its parameters alone to ``nerfacto.npz``). The JAX trainer's batch sampler keeps the
datamanager's default seed 42, which is also the trainer's default ``seed``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field as dataclass_field
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from neuradar_tpu_torch.cameras.cameras import generate_camera_rays
from neuradar_tpu_torch.data.datamanager import ADDataManager, ADDataManagerConfig, batch_to_device, build_train_bundle
from neuradar_tpu_torch.engine.optimizers import AdamOptimizerConfig, GroupedOptimizer, OptimizerGroupConfig
from neuradar_tpu_torch.engine.schedulers import ExponentialDecaySchedulerConfig
from neuradar_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
from neuradar_tpu_torch.utils import trace
from neuradar_tpu_torch.utils.params import init_params
from neuradar_tpu_torch.utils.writer import EventWriter


@dataclass
class NerfactoTrainerConfig:
    method_name: str = "nerfacto"
    experiment_name: str = "synthetic"
    output_dir: str = "outputs"
    model: NerfactoModelConfig = dataclass_field(default_factory=NerfactoModelConfig)
    max_num_iterations: int = 30000
    steps_per_log: int = 100
    steps_per_eval_batch: int = 500
    steps_per_save: int = 2000
    """0 leaves out the checkpoint at the end of training."""
    seed: int = 42
    lr_init: float = 1e-2
    lr_final: float = 1e-4
    warmup_steps: int = 512
    num_rgb_patches: int = 16
    patch_size: int = 16
    dataparser: object = None

    def setup(self, dataparser_outputs=None, device: Union[str, torch.device] = "cuda",
              prefetch: bool = True) -> "NerfactoTrainer":
        """The trainer of this config on ``dataparser_outputs`` (the dataparser's when None), set up
        on ``device``, with the batch prefetch thread on unless ``prefetch`` is False."""
        trainer = NerfactoTrainer(self, dataparser_outputs, device)
        trainer.setup(prefetch=prefetch)
        return trainer


class NerfactoTrainer:
    def __init__(self, config: NerfactoTrainerConfig, dataparser_outputs=None,
                 device: Union[str, torch.device] = "cuda"):
        self.config = config
        self.device = torch.device(device)
        if dataparser_outputs is None:
            dataparser_outputs = config.dataparser.setup().get_dataparser_outputs()
        self.outputs = dataparser_outputs
        self.step = 0
        self.writer: Optional[EventWriter] = None  # made by train(), so a trainer alone writes no files

    @property
    def run_dir(self) -> Path:
        return Path(self.config.output_dir) / self.config.experiment_name / self.config.method_name

    def setup(self, prefetch: bool = True) -> None:
        """The batch sampler, the seeded model, Adam and the step's generator on the device."""
        c = self.config
        self.dm = ADDataManager(self.outputs, ADDataManagerConfig(
            num_rgb_patches=c.num_rgb_patches, patch_size=c.patch_size, num_lidar_rays=0, num_radar_scans=0,
            seed=c.seed), self.device, rgb_upsample_factor=1)
        self.layout = self.dm.layout
        with self.device:
            self.model = NerfactoModel(c.model, float(np.abs(self.outputs.scene_box.aabb).max()),
                                       num_embeds=max(self.dm.tables.num_cam_frames, 1))
        self.model.to(self.device)
        init_params(self.model, c.seed)
        sched = ExponentialDecaySchedulerConfig(lr_final=c.lr_final, warmup_steps=c.warmup_steps,
                                                max_steps=c.max_num_iterations, ramp="linear")
        self.optimizer = GroupedOptimizer(
            self.model, {"all": OptimizerGroupConfig(AdamOptimizerConfig(lr=c.lr_init, eps=1e-15), sched)},
            label=lambda path: "all")
        self.generator = torch.Generator(device=self.device).manual_seed(c.seed)
        if prefetch:
            self.dm.start_prefetch()

    def loss(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator], train: bool = True,
             step: Optional[int] = None):
        """(total, loss terms, metrics, outputs) of a device batch; the anneal follows ``step`` in
        training (None: the exponent of a finished anneal's end, 1, as in eval)."""
        bundle = build_train_bundle(self.dm.tables, batch, self.layout, 1)
        gt = {"rgb": batch["image"].float().reshape(-1, 3) / 255.0}
        anneal = self.model.anneal_for_step(step) if train and step is not None else None
        return self.model.loss_and_metrics(bundle, gt, train=train, generator=generator, anneal=anneal)

    def train_step(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """One optimization step; returns (loss terms with their 'total', metrics) as detached
        device scalars."""
        cuda = self.device.type == "cuda"
        with trace.span("train/step", device=cuda, unit=True):
            batch = batch_to_device(self.dm.next_train(), self.device)
            self.model.train()
            self.optimizer.zero_grad()
            with trace.span("train/forward", device=cuda):
                total, loss_dict, metrics, _ = self.loss(batch, self.generator, step=self.step)
            total.backward()
            with trace.span("train/optimizer", device=cuda):
                self.optimizer.step(self.step)
            self.step += 1
        return {"total": total.detach(), **{k: v.detach() for k, v in loss_dict.items()}}, metrics

    @torch.no_grad()
    def eval_loss(self) -> torch.Tensor:
        """The total loss of one eval-split batch in eval mode (no jitter, no pose refinement)."""
        self.model.eval()
        return self.loss(batch_to_device(self.dm.sample_eval_batch(), self.device), None, train=False)[0]

    def train(self, num_iterations: Optional[int] = None) -> Dict[str, float]:
        """Train to ``max_num_iterations`` (or ``num_iterations`` more steps) with the log and
        eval-batch cadences, then the eval PSNR and the checkpoint; stops the prefetch thread."""
        c = self.config
        if self.writer is None:
            self.writer = EventWriter(log_dir=self.run_dir / "logs")
        n = num_iterations if num_iterations is not None else max(c.max_num_iterations - self.step, 0)
        last: Dict[str, float] = {}
        end = self.step + n
        t0 = time.perf_counter()
        try:
            for _ in range(n):
                step = self.step
                losses, metrics = self.train_step()
                if step % c.steps_per_log == 0 or step == end - 1:
                    with trace.host_sync("nerfacto_log"):
                        last = {"loss": float(losses["total"]), **{k: float(v) for k, v in metrics.items()}}
                    self.writer.put_scalars(step, last)
                if c.steps_per_eval_batch and step and step % c.steps_per_eval_batch == 0:
                    with trace.host_sync("nerfacto_eval"):
                        self.writer.put_scalars(step, {"eval_loss": float(self.eval_loss())})
        finally:
            self.dm.stop()
        last["iters_per_sec"] = n / max(time.perf_counter() - t0, 1e-9)
        last.update(self.eval_psnr())
        if c.steps_per_save:
            self.save_checkpoint()
        self.writer.close()
        return last

    @torch.no_grad()
    def render_camera(self, cam_idx: int) -> np.ndarray:
        """The whole image of camera frame ``cam_idx``, one ray a pixel, rendered in chunks of
        ``eval_num_rays_per_chunk`` rays: rgb float32 [H, W, 3] on the host."""
        self.model.eval()
        H, W = self.outputs.image_size
        rr, cc = torch.meshgrid(torch.arange(H, device=self.device), torch.arange(W, device=self.device),
                                indexing="ij")
        coords = torch.stack([rr.reshape(-1), cc.reshape(-1)], dim=1)
        chunk = self.config.model.eval_num_rays_per_chunk
        outs = []
        for i in range(0, len(coords), chunk):
            part = coords[i:i + chunk]
            cam_ids = torch.full((len(part),), cam_idx, dtype=torch.long, device=self.device)
            outs.append(self.model(generate_camera_rays(self.dm.tables.cameras, cam_ids, part))["rgb"])
        with trace.host_sync("nerfacto_render"):
            return torch.cat(outs).reshape(H, W, 3).cpu().numpy()

    def eval_psnr(self) -> Dict[str, float]:
        """Mean PSNR of whole-image renders of the eval frames, clipped to [0, 1]."""
        psnrs = []
        for ci in self.outputs.camera_split.eval:
            pred = np.clip(self.render_camera(int(ci)), 0.0, 1.0)
            gt = self.outputs.images[int(ci)].astype(np.float32) / 255.0
            psnrs.append(-10.0 * np.log10(max(float(np.mean((pred - gt) ** 2)), 1e-10)))
        return {"eval_psnr": float(np.mean(psnrs)), "eval_num_images": float(len(psnrs))} if psnrs else {}

    def save_checkpoint(self, path: Optional[Path] = None) -> Path:
        """The step, the parameters, Adam's state and the generator's in ``checkpoints/nerfacto.pt``."""
        path = Path(path) if path is not None else self.run_dir / "checkpoints" / "nerfacto.pt"
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"step": self.step, "model": self.model.state_dict(),
                    "optimizers": {g: opt.state_dict() for g, opt in self.optimizer.optimizers.items()},
                    "generator": self.generator.get_state()}, path)
        return path

    def load_checkpoint(self, path: Optional[Path] = None) -> None:
        """Restore what ``save_checkpoint`` wrote (a file, or the directory holding ``nerfacto.pt``)."""
        path = Path(path) if path is not None else self.run_dir / "checkpoints" / "nerfacto.pt"
        if path.is_dir():
            path = path / "nerfacto.pt"
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(state["model"])
        for g, opt in self.optimizer.optimizers.items():
            opt.load_state_dict(state["optimizers"][g])
        self.generator.set_state(state["generator"])
        self.step = int(state["step"])

    def shutdown(self) -> None:
        self.dm.stop()
        if self.writer is not None:
            self.writer.close()
