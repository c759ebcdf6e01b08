"""Splatfacto's trainer: whole-image 3DGS optimization (port of the JAX package's
engine/splatfacto_trainer.py).

One training image a step, drawn by a numpy generator seeded with ``seed`` (the JAX trainer's draw),
from images kept on the device as nerfstudio's full-image datamanager keeps them; the loss of
``models/splatfacto.splat_loss``; Adam per parameter group (means, scales, quaternions, opacities,
the DC colours, and the SH rest bands at a twentieth of the colours' rate); the screen-space mean
gradient of the in-view gaussians accumulated for densification. After the step of index i, where
i > ``warmup_steps`` and i % ``refine_every`` == 0, the gaussians are refined (cull, clone, split
into free slots) and Adam's moments are reset for the slots written, the others keeping theirs;
every ``reset_alpha_every`` refines before ``stop_split_at`` the opacities are reset as well, and
the opacity group's Adam state with them. All of this is ``train_step``, the call that
``train`` loops over and the benchmark times.

The gaussians are seeded from the train lidar scans (up to 8 scans, 8192 returns each, world frame,
coloured by intensity), as the JAX trainer seeds them. ``train`` runs to ``max_num_iterations``
with the log and eval cadences, then saves ``gaussians.npz`` (the step, the parameters and the
state), which ``scripts/exporter.py gaussian-ply`` reads.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field as dataclass_field
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from neuradar_tpu_torch.engine.optimizers import AdamOptimizerConfig, GroupedOptimizer, OptimizerGroupConfig
from neuradar_tpu_torch.models import splatfacto as sf
from neuradar_tpu_torch.utils import trace
from neuradar_tpu_torch.utils.writer import EventWriter


@dataclass
class SplatfactoTrainerConfig:
    method_name: str = "splatfacto"
    experiment_name: str = "synthetic"
    output_dir: str = "outputs"
    model: sf.SplatfactoConfig = dataclass_field(default_factory=sf.SplatfactoConfig)
    max_num_iterations: int = 30000
    steps_per_log: int = 100
    steps_per_eval_all_images: int = 5000
    seed: int = 42
    # per-group learning rates (cf. the splatfacto method config)
    lr_means: float = 1.6e-4
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacity: float = 5e-2
    lr_rgb: float = 2.5e-2
    dataparser: object = None

    def setup(self, dataparser_outputs=None, device: Union[str, torch.device] = "cuda") -> "SplatfactoTrainer":
        """The trainer of this config on ``dataparser_outputs`` (the dataparser's when None), set up
        on ``device``."""
        trainer = SplatfactoTrainer(self, dataparser_outputs, device)
        trainer.setup()
        return trainer

    def learning_rates(self) -> Dict[str, float]:
        """Each parameter group's rate; the SH rest bands train 20x slower than the DC colours."""
        return {"means": self.lr_means, "log_scales": self.lr_scales, "quats": self.lr_quats,
                "opacity_logits": self.lr_opacity, "rgb_logits": self.lr_rgb, "sh_rest": self.lr_rgb / 20.0}


def _by_name(path: Tuple[str, ...]) -> str:
    return path[-1]


class SplatfactoTrainer:
    def __init__(self, config: SplatfactoTrainerConfig, dataparser_outputs=None,
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

    def setup(self) -> None:
        """The seeded gaussians, Adam per group, the images and cameras on the device, and the
        generators of the image draw and of the refine's noise."""
        cfg, out = self.config, self.outputs
        rng = np.random.RandomState(cfg.seed)
        pts, cols = [], []
        for si in out.lidar_split.train[:8]:
            p = out.lidar_points[si]
            p = p[np.linalg.norm(p[:, :3], axis=1) < 1e3]
            sel = rng.choice(len(p), min(len(p), 8192), replace=False)
            l2w = out.lidar_to_worlds[si]
            pts.append(p[sel, :3] @ l2w[:3, :3].T + l2w[:3, 3])
            cols.append(np.tile(p[sel, 3:4], (1, 3)))
        points = np.concatenate(pts) if pts else rng.randn(4096, 3).astype(np.float32) * 10
        colors = np.concatenate(cols) if cols else np.full((4096, 3), 0.5, np.float32)
        self.model = sf.init_gaussians(cfg.model, points, colors, self.device)
        self.optimizer = self._adam()

        H, W = out.image_size
        self.H, self.W = H // sf.TILE * sf.TILE, W // sf.TILE * sf.TILE  # whole tiles
        self.images = torch.as_tensor(np.ascontiguousarray(out.images[:, :self.H, :self.W])).to(self.device)
        self.w2cs = torch.as_tensor(np.stack([sf.world_to_camera(c) for c in out.camera_to_worlds])).to(self.device)
        self.intrinsics = [tuple(float(v) for v in row[:4]) for row in out.intrinsics]
        self.image_rng = np.random.RandomState(cfg.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def _adam(self) -> GroupedOptimizer:
        """Adam (optax's: eps 1e-8 outside the root) per parameter group, at constant rates."""
        lrs = self.config.learning_rates()
        groups = {name: OptimizerGroupConfig(AdamOptimizerConfig(lr=lrs[name], eps=1e-8)) for name in self.model.params}
        return GroupedOptimizer(self.model, groups, label=_by_name)

    def camera(self, idx: int) -> Dict:
        return sf.camera_dict(self.w2cs[idx], self.intrinsics[idx], self.H, self.W)

    def ground_truth(self, idx: int) -> torch.Tensor:
        return self.images[idx].float() / 255.0

    def next_image(self) -> int:
        """The next step's training image."""
        return int(self.image_rng.choice(self.outputs.camera_split.train))

    def train_step(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """One optimization step on one whole image, and the refine its index calls for; returns
        ({'total': loss}, {'rgb': the rendered image, 'tile_overflow_frac'}) on the device."""
        mc, params, state = self.config.model, self.model.params, self.model.state
        cuda = self.device.type == "cuda"
        with trace.span("train/step", device=cuda, unit=True):
            idx = self.next_image()
            self.optimizer.zero_grad()
            offset = torch.zeros(mc.max_gaussians, 2, device=self.device, requires_grad=True)
            with trace.span("train/forward", device=cuda):
                loss, out = sf.splat_loss(mc, params, state["alive"], self.camera(idx), self.ground_truth(idx),
                                          mean2d_offset=offset)
            loss.backward()
            # the screen-space mean gradient in half-image units, densify_grad_thresh's calibration
            g2d = torch.linalg.vector_norm(offset.grad, dim=-1) * (max(self.H, self.W) / 2.0)
            sf.accumulate_grad_stats(state, g2d, out["aux"][2])
            with trace.span("train/optimizer", device=cuda):
                self.optimizer.step(self.step)
            if self.step > mc.warmup_steps and self.step % mc.refine_every == 0:
                self.refine()
            self.step += 1
        return {"total": loss.detach()}, {"rgb": out["rgb"].detach(), "tile_overflow_frac": out["aux"][3]}

    def refine_noise(self) -> torch.Tensor:
        """The standard normal draws [G, 3] that move the split gaussians' copies."""
        return torch.randn(self.config.model.max_gaussians, 3, generator=self.generator, device=self.device)

    def refine(self) -> None:
        """Refine after the step of index ``step``: cull and densify, reset the written slots' Adam
        moments, and at the reset cadence clamp the opacities and restart their group's Adam."""
        mc = self.config.model
        params, state = self.model.params, self.model.state
        with trace.span("splat/refine", device=self.device.type == "cuda"):
            refreshed = sf.refine_gaussians(mc, params, state, self.refine_noise(), self.step)
            for opt in self.optimizer.optimizers.values():
                for p in opt.param_groups[0]["params"]:
                    for key in ("exp_avg", "exp_avg_sq"):
                        if key in opt.state[p]:
                            opt.state[p][key].masked_fill_(refreshed.view(-1, *([1] * (p.dim() - 1))), 0.0)
            reset = mc.refine_every * mc.reset_alpha_every
            if mc.reset_alpha_every and self.step % reset == 0 and self.step < mc.stop_split_at:
                sf.reset_opacities(mc, params)
                st = self.optimizer.optimizers["opacity_logits"].state[params["opacity_logits"]]
                for key in ("exp_avg", "exp_avg_sq", "step"):
                    if key in st:
                        st[key].zero_()
            with trace.host_sync("splat_alive"):
                alive = int(state["alive"].sum())
            trace.count("splat_alive", alive)

    def train(self, num_iterations: Optional[int] = None) -> Dict[str, float]:
        """Train to ``max_num_iterations`` (or ``num_iterations`` more steps) with the log and eval
        cadences; then the final eval and ``gaussians.npz``."""
        cfg = self.config
        if self.writer is None:
            self.writer = EventWriter(log_dir=self.run_dir / "logs")
        n = num_iterations if num_iterations is not None else max(cfg.max_num_iterations - self.step, 0)
        last: Dict[str, float] = {}
        t0 = time.perf_counter()
        for _ in range(n):
            step = self.step
            losses, metrics = self.train_step()
            if step % cfg.steps_per_log == 0:
                with trace.host_sync("splat_log"):
                    loss, alive = torch.stack([losses["total"], self.model.alive.sum().float()]).tolist()
                last = {"loss": loss, "num_gaussians": alive, "tile_overflow_frac": metrics["tile_overflow_frac"]}
                self.writer.put_scalars(step, last)
            if cfg.steps_per_eval_all_images and step > 0 and step % cfg.steps_per_eval_all_images == 0:
                ev = self.eval_psnr()
                self.writer.put_scalars(step, ev)
                last.update(ev)
        last["total_train_time"] = time.perf_counter() - t0
        last.update(self.eval_psnr())
        self.save_checkpoint()
        self.writer.close()
        return last

    @torch.no_grad()
    def eval_psnr(self) -> Dict[str, float]:
        """Mean PSNR and SSIM over the eval images, the renders clipped to [0, 1]."""
        mc = self.config.model
        pending = []
        for idx in self.outputs.camera_split.eval:
            rgb = sf.render_splats(mc, self.model.params, self.model.alive, self.camera(int(idx)))["rgb"]
            rgb, gt = torch.clamp(rgb, 0.0, 1.0), self.ground_truth(int(idx))
            pending.append(torch.stack([torch.mean((rgb - gt) ** 2), sf.ssim(rgb, gt)]))
        if not pending:
            return {"psnr": 0.0, "ssim": 0.0}
        with trace.host_sync("splat_eval"):
            values = torch.stack(pending).cpu().numpy()
        psnr = [-10 * np.log10(max(float(mse), 1e-10)) for mse in values[:, 0]]
        return {"psnr": float(np.mean(psnr)), "ssim": float(np.mean(values[:, 1]))}

    def save_checkpoint(self, path: Optional[Path] = None) -> Path:
        """The step, the gaussians and their state in one npz, the JAX trainer's layout."""
        path = Path(path) if path is not None else self.run_dir / "gaussians.npz"
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, step=self.step,
                 **{f"param_{k}": v.detach().cpu().numpy() for k, v in self.model.params.items()},
                 **{f"state_{k}": v.cpu().numpy() for k, v in self.model.state.items()})
        return path
