"""Nerfacto (port of the JAX package's models/nerfacto.py, the camera model; Tancik et al.,
"Nerfstudio", SIGGRAPH 2023).

One ray a pixel, no CNN: the train rays pose-refined by the SO3xR3 camera optimizer, the near and
far planes set (the near plane in training only, as nerfstudio's collider resets it for renders),
linear-then-disparity initial samples, two proposal rounds of ``HashMLPDensityField`` resampled by
their annealed weights, ``NerfactoField`` at the final samples, and the colour rendered over the
last sample's colour as background. The losses: the colour MSE, MipNeRF-360's interlevel and
distortion losses over every round, and the camera optimizer's regularizer.

Where the JAX package departs from nerfstudio, the port follows the JAX package: the proposal
networks are updated every step (nerfstudio updates them every 5th step past step 5,000), and the
anneal exponent is a function of the step (``anneal_for_step``), not a per-step callback. The
lidar variant (``predict_lidar``, the DS-NeRF and URF depth losses) is not ported.

Spans: ``proposal_sampling`` (both rounds: the initial sampler, the proposal networks, the pdf
sampling), ``field``, and in training ``nerfacto/interlevel_loss`` and ``nerfacto/distortion_loss``
(timed on the card). Counters, once a forward: ``nerfacto/proposal_samples`` (both rounds'
samples) and ``nerfacto/field_samples``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field as dataclass_field
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from neuradar_tpu_torch.cameras.camera_optimizers import CameraOptimizer, CameraOptimizerConfig
from neuradar_tpu_torch.cameras.rays import RayBundle
from neuradar_tpu_torch.fields.nerfacto_field import HashMLPDensityField, NerfactoField
from neuradar_tpu_torch.model_components.losses import distortion_loss, interlevel_loss
from neuradar_tpu_torch.model_components.ray_samplers import (
    draw_jitter,
    lin_disp_piecewise_sampler,
    proposal_network_sampler,
)
from neuradar_tpu_torch.model_components.renderers import render_depth_expected, render_rgb_last_sample
from neuradar_tpu_torch.utils import trace


@dataclass
class NerfactoModelConfig:
    near_plane: float = 0.05
    far_plane: float = 1000.0
    hidden_dim: int = 64
    hidden_dim_color: int = 64
    num_levels: int = 16
    base_res: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 19
    features_per_level: int = 2
    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96)
    num_nerf_samples_per_ray: int = 48
    proposal_net_args_list: Tuple[Dict[str, Any], ...] = (
        {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 128, "use_linear": False},
        {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 256, "use_linear": False},
    )
    """Each proposal round's ``HashMLPDensityField`` arguments (the last serves any further round)."""
    appearance_embedding_dim: int = 32
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.002
    use_single_jitter: bool = True
    camera_optimizer: CameraOptimizerConfig = dataclass_field(
        default_factory=lambda: CameraOptimizerConfig(mode="SO3xR3"))
    use_proposal_weight_anneal: bool = True
    """Anneal the proposal weights' exponent from 0 (uniform) to 1 (the plain PDF) over the first
    ``proposal_weights_anneal_max_num_iters`` steps."""
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 1000
    eval_num_rays_per_chunk: int = 1 << 14


class NerfactoModel(nn.Module):
    def __init__(self, config: NerfactoModelConfig, static_scale: float, num_embeds: int = 1):
        super().__init__()
        self.config = config
        self.field = NerfactoField(
            static_scale, num_embeds=num_embeds, hidden_dim=config.hidden_dim,
            hidden_dim_color=config.hidden_dim_color, num_levels=config.num_levels, base_res=config.base_res,
            max_res=config.max_res, log2_hashmap_size=config.log2_hashmap_size,
            features_per_level=config.features_per_level, appearance_embedding_dim=config.appearance_embedding_dim)
        args = config.proposal_net_args_list
        self.num_proposal_rounds = len(config.num_proposal_samples_per_ray)
        for i in range(self.num_proposal_rounds):
            self.add_module(f"proposal_{i}", HashMLPDensityField(static_scale, **args[min(i, len(args) - 1)]))
        self.camera_optimizer = CameraOptimizer(config.camera_optimizer, num_embeds)

    @property
    def proposal_fields(self) -> List[HashMLPDensityField]:
        return [getattr(self, f"proposal_{i}") for i in range(self.num_proposal_rounds)]

    def anneal_for_step(self, step: int) -> Optional[float]:
        """The proposal weights' exponent at ``step``: b x / ((b - 1) x + 1) of the share x of the
        anneal's steps done, b the slope; None without the anneal."""
        cfg = self.config
        if not cfg.use_proposal_weight_anneal:
            return None
        x = min(max(float(step) / cfg.proposal_weights_anneal_max_num_iters, 0.0), 1.0)
        b = cfg.proposal_weights_anneal_slope
        return b * x / ((b - 1) * x + 1)

    def forward(self, ray_bundle: RayBundle, train: bool = False, generator: Optional[torch.Generator] = None,
                anneal: Optional[float] = None) -> Dict[str, Any]:
        """rgb, accumulation and depth [R, *]; in training also every round's weights and samples
        (the final round last). ``generator`` draws the stratification jitter in training."""
        cfg = self.config
        near = cfg.near_plane if train else 0.0
        ray_bundle = dataclasses.replace(ray_bundle, nears=torch.full_like(ray_bundle.pixel_area, near),
                                         fars=torch.full_like(ray_bundle.pixel_area, cfg.far_plane))
        if train and cfg.camera_optimizer.mode != "off":
            ray_bundle = self.camera_optimizer.apply_to_raybundle(ray_bundle)
        R = ray_bundle.num_rays
        jitter = None
        if train:
            jitter = draw_jitter(generator, R, (*cfg.num_proposal_samples_per_ray, cfg.num_nerf_samples_per_ray),
                                 cfg.use_single_jitter, ray_bundle.origins.device)
        with trace.span("proposal_sampling"):
            ray_samples, weights_list, samples_list = proposal_network_sampler(
                ray_bundle, self.proposal_fields, cfg.num_proposal_samples_per_ray, cfg.num_nerf_samples_per_ray,
                initial_sampler=lin_disp_piecewise_sampler, jitter=jitter, anneal=anneal)
        trace.count("nerfacto/proposal_samples", R * sum(cfg.num_proposal_samples_per_ray))
        trace.count("nerfacto/field_samples", R * cfg.num_nerf_samples_per_ray)
        cam_idx = ray_bundle.camera_indices[..., 0] if ray_bundle.camera_indices is not None else None
        with trace.span("field"):
            field_out = self.field(ray_samples, cam_idx)
        weights = ray_samples.get_weights(field_out["density"])
        outputs = {
            "rgb": render_rgb_last_sample(field_out["rgb"], weights),
            "accumulation": torch.sum(weights, dim=-2),
            "depth": render_depth_expected(weights, ray_samples),
        }
        if train:
            outputs["weights_list"] = weights_list + [weights]
            outputs["ray_samples_list"] = samples_list + [ray_samples]
        return outputs

    def loss_and_metrics(self, ray_bundle: RayBundle, batch: Dict[str, torch.Tensor], train: bool = True,
                         generator: Optional[torch.Generator] = None, anneal: Optional[float] = None):
        """(total, loss terms, metrics, outputs); ``batch['rgb']`` [R, 3] in [0, 1]."""
        cfg = self.config
        outputs = self(ray_bundle, train=train, generator=generator, anneal=anneal)
        loss_dict: Dict[str, torch.Tensor] = {}
        metrics: Dict[str, torch.Tensor] = {}
        if "rgb" in batch:
            mse = torch.mean((batch["rgb"] - outputs["rgb"]) ** 2)
            loss_dict["rgb_loss"] = mse
            metrics["psnr"] = -10 * torch.log10(mse.detach())
        if train:
            cuda = ray_bundle.origins.is_cuda
            wl, rsl = outputs["weights_list"], outputs["ray_samples_list"]
            with trace.span("nerfacto/interlevel_loss", device=cuda):
                loss_dict["interlevel_loss"] = cfg.interlevel_loss_mult * interlevel_loss(wl, rsl)
            with trace.span("nerfacto/distortion_loss", device=cuda):
                loss_dict["distortion_loss"] = cfg.distortion_loss_mult * distortion_loss(wl, rsl)
            if cfg.camera_optimizer.mode != "off":
                loss_dict["camera_opt_regularizer"] = self.camera_optimizer.regularization_loss()
        total = sum(loss_dict.values())
        return total, loss_dict, metrics, outputs
