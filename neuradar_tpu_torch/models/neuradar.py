"""NeuRadar: joint camera + lidar + radar neural feature field (port of the
JAX package's models/neuradar.py, the eval forward: ``get_outputs``,
``get_nff_outputs`` and ``_nff_core`` with train=False).

One merged ray bundle with a static segment layout [camera | lidar | radar
scans]: proposal sampling -> field -> volume compositing (kernel K1) ->
appearance embedding -> the per-modality decoders (the radar encoder's
attention is kernel K2). Losses, the camera optimizer and the train-time
randomness (sampling jitter, actor flips, dropout) come with the train step.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field as dataclass_field
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from neuradar_tpu_torch.cameras.rays import RayBundle, RaySamples
from neuradar_tpu_torch.field_components.mlp import MLP
from neuradar_tpu_torch.fields.neurad_field import (
    NeuRADField,
    NeuRADFieldConfig,
    NeuRADProposalField,
    NeuRADProposalFieldConfig,
)
from neuradar_tpu_torch.model_components.cnns import RGBDecoder
from neuradar_tpu_torch.model_components.dynamic_actors import (
    ActorCandidates,
    ActorTrajectories,
    DynamicActors,
    DynamicActorsConfig,
)
from neuradar_tpu_torch.model_components.radar_decoder import RadarDecoder, spherical_to_cartesian
from neuradar_tpu_torch.model_components.ray_samplers import power_sampler, proposal_network_sampler
from neuradar_tpu_torch.model_components.renderers import render_depth_simple
from neuradar_tpu_torch.ops.volumetric import composite_sky_fwd

EPS = 1e-7


@dataclass
class SamplingSettings:
    proposal_field_1: NeuRADProposalFieldConfig = dataclass_field(default_factory=NeuRADProposalFieldConfig)
    proposal_field_2: NeuRADProposalFieldConfig = dataclass_field(default_factory=NeuRADProposalFieldConfig)
    num_proposal_samples: Tuple[int, ...] = (128, 64)
    num_nerf_samples: int = 32
    power_lambda: float = -1.0
    power_scaling: float = 0.1
    sky_distance: float = 20000.0


@dataclass
class NeuRadarModelConfig:
    sampling: SamplingSettings = dataclass_field(default_factory=SamplingSettings)
    field: NeuRADFieldConfig = dataclass_field(default_factory=NeuRADFieldConfig)
    dynamic_actors: DynamicActorsConfig = dataclass_field(default_factory=DynamicActorsConfig)
    appearance_dim: int = 16
    temporal_appearance_freq: float = 1.0
    rgb_upsample_factor: int = 3
    rgb_hidden_dim: int = 32
    eval_num_rays_per_chunk: int = 1 << 15


@dataclass(frozen=True)
class SegmentLayout:
    """Static partition of the merged ray bundle."""

    num_cam: int = 0
    num_lidar: int = 0
    num_radar_scans: int = 0
    rays_per_scan: int = 0
    patch_size: Tuple[int, int] = (1, 1)  # rendered (pre-upsample) patch

    @property
    def num_radar(self) -> int:
        return self.num_radar_scans * self.rays_per_scan

    @property
    def total(self) -> int:
        return self.num_cam + self.num_lidar + self.num_radar

    def cam(self, x):
        return x[: self.num_cam] if self.num_cam else None

    def lidar(self, x):
        return x[self.num_cam : self.num_cam + self.num_lidar] if self.num_lidar else None

    def radar(self, x):
        return x[self.num_cam + self.num_lidar :] if self.num_radar else None


@dataclass(frozen=True)
class SceneMeta:
    """Static scene constants the model needs at construction."""

    static_scale: float = 100.0
    duration: float = 10.0
    num_sensors: int = 1


class NeuRadarModel(nn.Module):
    """The joint model in float32 (the neuradar-synthetic preset; both kernels
    take float32); submodule names follow the flax parameter tree."""

    def __init__(self, config: NeuRadarModelConfig, scene: SceneMeta, trajectories: ActorTrajectories):
        super().__init__()
        self.config = config
        self.scene = scene
        n_actors = trajectories.n_actors
        self.n_actors = n_actors
        self.dynamic_actors = DynamicActors(trajectories, config.dynamic_actors)
        self.field = NeuRADField(config.field, scene.static_scale, n_actors)
        self.proposal_field_0 = NeuRADProposalField(config.sampling.proposal_field_1, scene.static_scale, n_actors)
        self.proposal_field_1 = NeuRADProposalField(config.sampling.proposal_field_2, scene.static_scale, n_actors)

        self.embeds_per_sensor = max(1, int(-(-scene.duration * config.temporal_appearance_freq // 1)))
        self.appearance_embedding = nn.Embedding(scene.num_sensors * self.embeds_per_sensor, config.appearance_dim)

        n_features = config.field.nff_out_dim + config.appearance_dim
        self.rgb_decoder = RGBDecoder(n_features, config.rgb_hidden_dim, config.rgb_upsample_factor)
        self.lidar_decoder = MLP(n_features, 2, num_layers=3, layer_width=32)
        self.radar_decoder = RadarDecoder(d_model=n_features)

    @property
    def proposal_fields(self):
        return (self.proposal_field_0, self.proposal_field_1)

    def get_outputs(self, ray_bundle: RayBundle, layout: SegmentLayout) -> Dict[str, torch.Tensor]:
        outputs = self.get_nff_outputs(ray_bundle, layout)
        features = outputs.pop("features")

        cam_feats = layout.cam(features)
        if cam_feats is not None:
            ph, pw = layout.patch_size
            outputs["rgb"] = self.rgb_decoder(cam_feats.reshape(-1, ph, pw, cam_feats.shape[-1]))

        lidar_feats = layout.lidar(features)
        if lidar_feats is not None:
            decoded = self.lidar_decoder(lidar_feats)
            outputs["intensity"] = torch.sigmoid(decoded[..., :1])
            outputs["ray_drop_logits"] = decoded[..., 1:2]

        radar_feats = layout.radar(features)
        if radar_feats is not None:
            ns, nr = layout.num_radar_scans, layout.rays_per_scan
            depth = layout.radar(outputs["depth"]).reshape(ns, nr, 1)
            spher = layout.radar(ray_bundle.metadata["directions_spher"]).reshape(ns, nr, 2)
            geometry = spherical_to_cartesian(depth, spher[..., 1:2], spher[..., 0:1])
            # all scans in one batch: attention never crosses scans
            outputs["radar_output"], outputs["radar_angles"] = self.radar_decoder(
                radar_feats.reshape(ns, nr, radar_feats.shape[-1]), geometry
            )
        return outputs

    def decode_camera_features(self, features: torch.Tensor, patch_size: Tuple[int, int]) -> torch.Tensor:
        """Rendered features [h*w, C] -> rgb [1, h*u, w*u, 3] through the upsampling CNN."""
        ph, pw = patch_size
        return self.rgb_decoder(features.reshape(-1, ph, pw, features.shape[-1]))

    def get_nff_outputs(self, ray_bundle: RayBundle, layout: SegmentLayout) -> Dict[str, torch.Tensor]:
        """Neural-feature-field forward: features [R, C + A], depth [R, 1], accumulation [R, 1]."""
        cfg = self.config
        ray_bundle = self._scale_pixel_area(ray_bundle, layout)
        sky = cfg.sampling.sky_distance
        fars = (torch.clamp(ray_bundle.fars, max=sky) if ray_bundle.fars is not None
                else torch.full_like(ray_bundle.pixel_area, sky))
        nears = ray_bundle.nears if ray_bundle.nears is not None else torch.zeros_like(fars)
        ray_bundle = dataclasses.replace(ray_bundle, nears=nears, fars=fars)

        candidates = None
        if self.n_actors > 0:
            times = (ray_bundle.times[..., 0] if ray_bundle.times is not None
                     else torch.zeros(layout.total, device=fars.device))
            candidates = self.dynamic_actors.get_ray_candidates(times, ray_bundle.origins, ray_bundle.directions)
        return self._nff_core(ray_bundle, candidates)

    def _nff_core(self, ray_bundle: RayBundle, candidates: Optional[ActorCandidates]) -> Dict[str, torch.Tensor]:
        cfg = self.config
        # round i is weighted by proposal field i
        density_fns = [(lambda rs, f=f: f(rs, candidates)) for f in self.proposal_fields]
        ray_samples, _, _ = proposal_network_sampler(
            ray_bundle,
            density_fns,
            cfg.sampling.num_proposal_samples,
            cfg.sampling.num_nerf_samples,
            initial_sampler=lambda rb, n: power_sampler(rb, n, cfg.sampling.power_lambda, cfg.sampling.power_scaling),
        )
        ray_samples = _apply_sky_sample(ray_samples, cfg.sampling.sky_distance)

        field_out = self.field(ray_samples, candidates)
        # K1: weights, sky redistribution and feature render in one pass
        weights_sky, features, accumulation = composite_sky_fwd(field_out["alpha"][..., 0].contiguous(),
                                                                field_out["feature"].contiguous())
        features = torch.cat([features, self._get_appearance_embedding(ray_bundle, features)], dim=-1)

        # the sky sample is left out of the depth
        depth = render_depth_simple(weights_sky[..., :-1, None], _drop_last_sample(ray_samples))
        return {"features": features, "depth": depth, "accumulation": accumulation}

    def _scale_pixel_area(self, ray_bundle: RayBundle, layout: SegmentLayout) -> RayBundle:
        """Camera rays render at 1/u resolution: their footprint grows by u^2."""
        if layout.num_cam == 0:
            return ray_bundle
        u2 = float(self.config.rgb_upsample_factor**2)
        pa = ray_bundle.pixel_area
        return dataclasses.replace(ray_bundle, pixel_area=torch.cat([pa[: layout.num_cam] * u2,
                                                                     pa[layout.num_cam :]], dim=0))

    def _get_appearance_embedding(self, ray_bundle: RayBundle, features: torch.Tensor) -> torch.Tensor:
        """Per-sensor appearance, linearly interpolated between the embeddings of neighbouring time bins."""
        sensor_idx = ray_bundle.metadata.get("sensor_idxs")
        if sensor_idx is None:
            sensor_idx = torch.zeros((features.shape[0], 1), dtype=torch.long, device=features.device)
        sensor_idx = sensor_idx[..., 0].long()
        eps_n = self.embeds_per_sensor
        times = ray_bundle.times[..., 0] if ray_bundle.times is not None else torch.zeros_like(features[..., 0])
        time_idx = times / self.scene.duration * eps_n
        before = torch.clamp(torch.floor(time_idx), 0, eps_n - 1)
        after = torch.clamp(before + 1, 0, eps_n - 1)
        ratio = (time_idx - before)[..., None]
        before_emb = self.appearance_embedding((before + sensor_idx * eps_n).long())
        after_emb = self.appearance_embedding((after + sensor_idx * eps_n).long())
        return before_emb * (1 - ratio) + after_emb * ratio


def _apply_sky_sample(ray_samples: RaySamples, sky_distance: float) -> RaySamples:
    """Stretch the last sample to the sky."""
    ends = ray_samples.frustums.ends.clone()
    deltas = ray_samples.deltas.clone()
    dist_to_sky = sky_distance - ends[..., -1, 0]
    ends[..., -1, 0] += dist_to_sky
    deltas[..., -1, 0] += dist_to_sky
    spacing_ends = ray_samples.spacing_ends
    if spacing_ends is not None:
        spacing_ends = spacing_ends.clone()
        spacing_ends[..., -1, 0] = 1 - EPS
    return dataclasses.replace(
        ray_samples,
        frustums=dataclasses.replace(ray_samples.frustums, ends=ends),
        deltas=deltas,
        spacing_ends=spacing_ends,
    )


def _drop_last_sample(ray_samples: RaySamples) -> RaySamples:
    f = ray_samples.frustums
    return dataclasses.replace(
        ray_samples,
        frustums=dataclasses.replace(f, starts=f.starts[..., :-1, :], ends=f.ends[..., :-1, :]),
        deltas=ray_samples.deltas[..., :-1, :],
        spacing_starts=None if ray_samples.spacing_starts is None else ray_samples.spacing_starts[..., :-1, :],
        spacing_ends=None if ray_samples.spacing_ends is None else ray_samples.spacing_ends[..., :-1, :],
    )
