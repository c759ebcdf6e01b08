"""NeuRadar: joint camera + lidar + radar neural feature field (port of the
JAX package's models/neuradar.py: ``get_outputs``, ``get_nff_outputs``,
``_nff_core`` and ``loss_and_metrics``, in eval and in training).

One merged ray bundle with a static segment layout [camera | lidar | radar
scans]: proposal sampling -> field -> volume compositing (kernel K1) ->
appearance embedding -> the per-modality decoders (the radar encoder's
attention is kernel K2) -> the loss terms. Training draws its randomness
(sampling jitter, actor flips, dropout) from one explicit generator. The
per-ray core runs in ``nff_chunks`` chunks; in training each chunk is
recomputed in the backward pass (``torch.utils.checkpoint``, the counterpart
of the JAX package's nff_remat), so only one chunk's activations live at a
time. The radar decoder is the per-ray encoder or, with ``radar_decoder_type``
"set", the DETR-style set decoder (its encoder's attention is K2 too), with
the multi-Bernoulli loss (NLL or euclidean) or DETR's set loss, the auction or
the host's Hungarian assignment, and the set decoder's deep supervision. The
radar scans are decoded in ``radar_decode_chunks`` groups, those of the per-ray
decoder recomputed in the backward pass when training; the dropout draws are
made for all scans first, so the grouping changes no result (apart from the
set decoder's broadcast attention masks, one per group as in the JAX package).

``compute_dtype`` "bfloat16" runs the hash grids, the field MLPs and the
radar transformer in bf16 (K2 at bf16); compositing (K1), the decoders' heads
and the losses stay float32, as in the JAX package. With
``hoist_table_cast`` the pipeline casts the hash tables once per request
(``cast_tables``) and hands them down through every chunk: autograd then
adds the chunks' table gradients in bf16 and casts the sum to float32 once,
as the JAX package's hoisted cast does. The VGG perceptual loss
(``loss.vgg_mult``) is ported, and so is the camera optimizer: in training it
pose-corrects every ray whose ``camera_indices`` are set (the frames of all
three sensors) and adds its regularizer to the losses. With
``use_temporal_appearance`` off each sensor has one appearance embedding.
``nff_remat_policy`` is not ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field as dataclass_field
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from neuradar_tpu_torch.cameras.camera_optimizers import CameraOptimizer, CameraOptimizerConfig
from neuradar_tpu_torch.cameras.rays import RayBundle, RaySamples
from neuradar_tpu_torch.field_components.encodings import cast_hash_tables
from neuradar_tpu_torch.field_components.mlp import MLP
from neuradar_tpu_torch.fields.neurad_field import (
    NeuRADField,
    NeuRADFieldConfig,
    NeuRADProposalField,
    NeuRADProposalFieldConfig,
    field_query_geometry,
)
from neuradar_tpu_torch.model_components.cnns import RGBDecoder
from neuradar_tpu_torch.model_components.dynamic_actors import (
    ActorCandidates,
    ActorEdits,
    ActorTrajectories,
    DynamicActors,
    DynamicActorsConfig,
)
from neuradar_tpu_torch.model_components import radar_utils
from neuradar_tpu_torch.model_components.losses import (
    binary_cross_entropy_with_logits,
    distortion_loss_sdist,
    masked_mean,
    ray_samples_to_sdist,
    zipnerf_interlevel_loss_sdist,
)
from neuradar_tpu_torch.model_components.radar_decoder import RadarDecoder, SetRadarDecoder, spherical_to_cartesian
from neuradar_tpu_torch.model_components.ray_samplers import draw_jitter, power_sampler, proposal_network_sampler
from neuradar_tpu_torch.model_components.renderers import render_depth_simple
from neuradar_tpu_torch.model_components.vgg import VGGPerceptualLossPix2Pix
from neuradar_tpu_torch.ops.volumetric import composite_sky
from neuradar_tpu_torch.utils import trace

EPS = 1e-7


@dataclass
class LossSettings:
    vgg_mult: float = 0.05
    rgb_mult: float = 5.0
    depth_mult: float = 0.01
    intensity_mult: float = 0.1
    carving_mult: float = 0.01
    carving_epsilon: float = 0.1
    quantile_threshold: float = 0.95
    interlevel_loss_mult: float = 0.001
    distortion_loss_mult: float = 0.002
    non_return_lidar_distance: float = 150.0
    non_return_loss_mult: float = 0.1
    ray_drop_loss_mult: float = 0.01
    prop_lidar_loss_mult: float = 0.1
    radar_mult: float = 0.02
    radar_loss_type: str = "nll"  # nll | euclidean
    radar_assignment: str = "auction"  # auction (on the device) | hungarian (scipy on the host)
    radar_set_loss: str = "mb"
    """The set decoder's loss: "mb" the multi-Bernoulli loss with one component per query, "detr"
    DETR's set criterion (``radar_utils.detr_set_loss``)."""


@dataclass
class SamplingSettings:
    single_jitter: bool = True
    proposal_field_1: NeuRADProposalFieldConfig = dataclass_field(default_factory=NeuRADProposalFieldConfig)
    proposal_field_2: NeuRADProposalFieldConfig = dataclass_field(default_factory=NeuRADProposalFieldConfig)
    num_proposal_samples: Tuple[int, ...] = (128, 64)
    num_nerf_samples: int = 32
    power_lambda: float = -1.0
    power_scaling: float = 0.1
    sky_distance: float = 20000.0


@dataclass
class NeuRadarModelConfig:
    loss: LossSettings = dataclass_field(default_factory=LossSettings)
    sampling: SamplingSettings = dataclass_field(default_factory=SamplingSettings)
    field: NeuRADFieldConfig = dataclass_field(default_factory=NeuRADFieldConfig)
    dynamic_actors: DynamicActorsConfig = dataclass_field(default_factory=DynamicActorsConfig)
    camera_optimizer: CameraOptimizerConfig = dataclass_field(default_factory=CameraOptimizerConfig)
    appearance_dim: int = 16
    use_temporal_appearance: bool = True
    """Interpolate each sensor's appearance between embeddings of neighbouring time bins (one bin
    per 1 / temporal_appearance_freq seconds); off, one embedding per sensor."""
    temporal_appearance_freq: float = 1.0
    rgb_upsample_factor: int = 3
    rgb_hidden_dim: int = 32
    existence_probability_threshold: float = 0.5  # radar components kept by the deterministic sampler
    eval_num_rays_per_chunk: int = 1 << 15
    compute_dtype: str = "float32"
    """With "bfloat16" the hash grids (tables and positions), the field MLPs and the radar
    transformer compute in bf16 with float32 parameters."""
    nff_chunks: int = 1
    """Sequential ray chunks of the per-ray core; must divide the bundle (else one chunk). In
    training each chunk is recomputed in the backward pass instead of keeping its activations."""
    radar_decode_chunks: int = 4
    """Radar scans are decoded in this many groups (the largest count up to it that divides the
    scans), each recomputed in the backward pass when training."""
    hoist_table_cast: bool = True
    """Under a compute_dtype other than float32: cast the hash tables once per request (the
    pipeline calls ``cast_tables``) instead of inside every chunk."""
    radar_transformer_dropout: float = 0.1
    radar_decoder_type: str = "encoder"
    """"encoder" (per-ray heads on the NeRF geometry) or "set" (DETR-style learnable queries)."""
    num_radar_queries: int = 300
    """The set decoder's query count."""
    radar_set_aux_loss: bool = True
    """The set decoder's deep supervision: in training every intermediate decoder layer's output
    pays the radar loss too (``radar_aux_loss``)."""

    @property
    def num_proposal_rounds(self) -> int:
        return len(self.sampling.num_proposal_samples)


def radar_decode_groups(num_scans: int, radar_decode_chunks: int) -> int:
    """The number of groups ``num_scans`` radar scans are decoded in: the largest count up to
    ``radar_decode_chunks`` that divides the scans."""
    n_groups = max(1, min(radar_decode_chunks, num_scans))
    while num_scans % n_groups:
        n_groups -= 1
    return n_groups


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
    num_train_frames: int = 1  # the camera optimizer's frames: every camera, lidar and radar frame


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """The modules' compute dtype for a config's name: None for float32 (no cast anywhere)."""
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {name!r}: the port runs float32 or bfloat16")
    return None if name == "float32" else torch.bfloat16


class NeuRadarModel(nn.Module):
    """The joint model, float32 parameters, computing in ``config.compute_dtype``; submodule
    names follow the flax parameter tree: ``vgg_loss`` exists when ``loss.vgg_mult`` > 0, and
    ``radar_decoder`` when ``decode_radar`` (its batches hold radar scans), as the flax module's
    parameters do; ``camera_optimizer`` holds ``pose_adjustment`` unless its mode is "off"."""

    def __init__(self, config: NeuRadarModelConfig, scene: SceneMeta, trajectories: ActorTrajectories,
                 decode_radar: bool = True):
        super().__init__()
        self.config = config
        self.scene = scene
        n_actors = trajectories.n_actors
        self.n_actors = n_actors
        cdt = compute_dtype(config.compute_dtype)
        self.dynamic_actors = DynamicActors(trajectories, config.dynamic_actors)
        self.camera_optimizer = CameraOptimizer(config.camera_optimizer, scene.num_train_frames)
        self.field = NeuRADField(config.field, scene.static_scale, n_actors, cdt)
        self.proposal_field_0 = NeuRADProposalField(config.sampling.proposal_field_1, scene.static_scale, n_actors, cdt)
        self.proposal_field_1 = NeuRADProposalField(config.sampling.proposal_field_2, scene.static_scale, n_actors, cdt)

        self.embeds_per_sensor = (max(1, int(-(-scene.duration * config.temporal_appearance_freq // 1)))
                                  if config.use_temporal_appearance else 1)
        self.appearance_embedding = nn.Embedding(scene.num_sensors * self.embeds_per_sensor, config.appearance_dim)

        n_features = config.field.nff_out_dim + config.appearance_dim
        self.rgb_decoder = RGBDecoder(n_features, config.rgb_hidden_dim, config.rgb_upsample_factor)
        self.lidar_decoder = MLP(n_features, 2, num_layers=3, layer_width=32)
        if config.radar_decoder_type not in ("encoder", "set"):
            raise ValueError(f"radar_decoder_type {config.radar_decoder_type!r}: 'encoder' or 'set'")
        if not decode_radar:
            self.radar_decoder = None
        elif config.radar_decoder_type == "set":
            self.radar_decoder = SetRadarDecoder(
                d_model=n_features, num_queries=config.num_radar_queries, position_scale=scene.static_scale,
                dropout=config.radar_transformer_dropout, aux_loss=config.radar_set_aux_loss, dtype=cdt)
        else:
            self.radar_decoder = RadarDecoder(d_model=n_features, dropout=config.radar_transformer_dropout, dtype=cdt)
        if config.loss.radar_set_loss not in ("mb", "detr"):
            raise ValueError(f"radar_set_loss {config.loss.radar_set_loss!r}: 'mb' or 'detr'")
        if config.loss.vgg_mult > 0.0:
            self.vgg_loss = VGGPerceptualLossPix2Pix()

    @property
    def proposal_fields(self):
        return (self.proposal_field_0, self.proposal_field_1)

    def cast_tables(self) -> Optional[Dict[nn.Module, torch.Tensor]]:
        """The hoisted table cast (``encodings.cast_hash_tables``) when the config asks for it, else
        None: make it once per request and pass it as ``tables`` to the entry points below."""
        cdt = compute_dtype(self.config.compute_dtype)
        if cdt is None or not self.config.hoist_table_cast:
            return None
        return cast_hash_tables(self, cdt)

    def get_outputs(self, ray_bundle: RayBundle, layout: SegmentLayout, train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    tables: Optional[Dict[nn.Module, torch.Tensor]] = None,
                    actor_edits: Optional[ActorEdits] = None) -> Dict[str, torch.Tensor]:
        """Decoded outputs of a merged bundle. ``train`` needs a generator: it jitters the
        samples, flips actors, applies dropout and puts the RGB CNN's batch norm in training.
        ``tables``: the hash tables cast once (``cast_tables``); ``actor_edits``: a render's."""
        if train and generator is None:
            raise ValueError("training draws its randomness from a generator")
        if train and self.config.camera_optimizer.mode != "off":
            with trace.span("camera_optimizer"):
                ray_bundle = self.camera_optimizer.apply_to_raybundle(ray_bundle)
        outputs = self.get_nff_outputs(ray_bundle, layout, train, generator, tables, actor_edits)
        features = outputs.pop("features")

        cam_feats = layout.cam(features)
        if cam_feats is not None:
            ph, pw = layout.patch_size
            self.rgb_decoder.train(train)
            with trace.span("rgb_decoder"):
                outputs["rgb"] = self.rgb_decoder(cam_feats.reshape(-1, ph, pw, cam_feats.shape[-1]))

        lidar_feats = layout.lidar(features)
        if lidar_feats is not None:
            decoded = self.lidar_decoder(lidar_feats)
            outputs["intensity"] = torch.sigmoid(decoded[..., :1])
            outputs["ray_drop_logits"] = decoded[..., 1:2]

        if layout.num_radar:
            radar_feats, geometry = self.radar_tokens(features, outputs["depth"], ray_bundle, layout)
            with trace.span("radar_decoder"):
                decoded = self.decode_radar(radar_feats, geometry, generator if train else None)
            outputs["radar_output"], outputs["radar_angles"] = decoded[:2]
            if len(decoded) == 3:  # the set decoder's intermediate layers, [D-1, ns, Q, 7]
                outputs["radar_aux_outputs"] = decoded[2]
        return outputs

    def radar_tokens(self, features: torch.Tensor, depth: torch.Tensor, ray_bundle: RayBundle,
                     layout: SegmentLayout) -> Tuple[torch.Tensor, torch.Tensor]:
        """The radar decoder's inputs from the field's per-ray ``features`` and ``depth`` of a merged
        bundle: the radar rays' features [ns, nr, C] and their points [ns, nr, 3] (the depth along each
        ray's azimuth and elevation)."""
        ns, nr = layout.num_radar_scans, layout.rays_per_scan
        feats = layout.radar(features)
        depth = layout.radar(depth).reshape(ns, nr, 1)
        spher = layout.radar(ray_bundle.metadata["directions_spher"]).reshape(ns, nr, 2)
        return feats.reshape(ns, nr, feats.shape[-1]), spherical_to_cartesian(depth, spher[..., 1:2], spher[..., 0:1])

    def decode_radar(self, feats: torch.Tensor, geometry: torch.Tensor, generator: Optional[torch.Generator] = None):
        """The radar decoder over [ns, nr] tokens in ``radar_decode_chunks`` groups of scans
        (attention never crosses scans). With gradients each group of the per-ray decoder is
        recomputed in the backward pass, as the JAX package remats it; the set decoder keeps its
        activations, as the JAX package does (its cross-attention weights are [g, Q, nr] a layer).
        The training draws are made for all scans first and sliced per group. Returns the outputs
        concatenated over the groups: scans on axis 0, the set decoder's intermediate layers on
        axis 1."""
        ns, nr = feats.shape[:2]
        decoder = self.radar_decoder
        if decoder is None:
            raise ValueError("this model decodes no radar: its batches hold no radar scans")
        n_groups = radar_decode_groups(ns, self.config.radar_decode_chunks)
        noise = decoder.draw_noise(ns, nr, generator, feats.device, n_groups) if generator is not None else None
        if n_groups == 1:
            return decoder.decode(feats, geometry, noise)
        g = ns // n_groups
        remat = torch.is_grad_enabled() and isinstance(decoder, RadarDecoder)
        outs = []
        for i in range(0, ns, g):
            args = (feats[i:i + g], geometry[i:i + g], decoder.slice_noise(noise, i, i + g) if noise else None)
            if remat:
                outs.append(checkpoint(decoder.decode, *args, use_reentrant=False, preserve_rng_state=False))
            else:
                outs.append(decoder.decode(*args))
        return tuple(torch.cat([o[j] for o in outs], dim=0 if j < 2 else 1) for j in range(len(outs[0])))

    def query_geometry(self, positions: torch.Tensor) -> torch.Tensor:
        """The field's raw SDF at world positions [..., 3] -> [..., 1] (fields/neurad_field.py
        ``field_query_geometry``)."""
        return field_query_geometry(self.field, positions)

    def decode_camera_features(self, features: torch.Tensor, patch_size: Tuple[int, int]) -> torch.Tensor:
        """Rendered features [h*w, C] -> rgb [1, h*u, w*u, 3] through the upsampling CNN."""
        ph, pw = patch_size
        self.rgb_decoder.eval()
        return self.rgb_decoder(features.reshape(-1, ph, pw, features.shape[-1]))

    def get_nff_outputs(self, ray_bundle: RayBundle, layout: SegmentLayout, train: bool = False,
                        generator: Optional[torch.Generator] = None,
                        tables: Optional[Dict[nn.Module, torch.Tensor]] = None,
                        actor_edits: Optional[ActorEdits] = None) -> Dict[str, torch.Tensor]:
        """Neural-feature-field forward: features [R, C + A], depth [R, 1], accumulation [R, 1];
        in training also the per-round weights and bin edges the losses need, and the lidar
        carving sums. ``tables`` (``cast_tables``) enter every chunk as they are; ``actor_edits``
        moves or removes the actors (renders only)."""
        cfg = self.config
        ray_bundle = self._scale_pixel_area(ray_bundle, layout)
        sky = cfg.sampling.sky_distance
        fars = (torch.clamp(ray_bundle.fars, max=sky) if ray_bundle.fars is not None
                else torch.full_like(ray_bundle.pixel_area, sky))
        nears = ray_bundle.nears if ray_bundle.nears is not None else torch.zeros_like(fars)
        ray_bundle = dataclasses.replace(ray_bundle, nears=nears, fars=fars)
        R = layout.total
        if train and layout.num_lidar > 0 and "is_lidar" not in ray_bundle.metadata:
            is_lidar = torch.zeros((R, 1), dtype=torch.bool, device=fars.device)
            is_lidar[layout.num_cam: layout.num_cam + layout.num_lidar] = True
            ray_bundle = dataclasses.replace(ray_bundle, metadata={**ray_bundle.metadata, "is_lidar": is_lidar})

        # the random draws come first and in the JAX package's order (flips, then jitter);
        # a recomputed chunk reuses them
        candidates = None
        if self.n_actors > 0:
            times = (ray_bundle.times[..., 0] if ray_bundle.times is not None
                     else torch.zeros(R, device=fars.device))
            flip_prob = cfg.field.grid.actor.flip_prob
            candidates = self.dynamic_actors.get_ray_candidates(
                times, ray_bundle.origins, ray_bundle.directions,
                flip_generator=generator if train and flip_prob > EPS else None, flip_prob=flip_prob,
                edits=actor_edits,
            )
        jitter = None
        if train:
            s = cfg.sampling
            jitter = draw_jitter(generator, R, (*s.num_proposal_samples, s.num_nerf_samples), s.single_jitter,
                                 fars.device)

        n_chunks = cfg.nff_chunks if cfg.nff_chunks > 1 and R % cfg.nff_chunks == 0 else 1
        if n_chunks == 1:
            return self._nff_core(ray_bundle, candidates, jitter, train, tables)
        size = R // n_chunks
        outs = []
        for c in range(n_chunks):
            sl = slice(c * size, (c + 1) * size)
            args = (_slice_bundle(ray_bundle, sl), candidates.chunk(sl) if candidates is not None else None,
                    [j[sl] for j in jitter] if jitter is not None else None, train, tables)
            if train and torch.is_grad_enabled():
                outs.append(checkpoint(self._nff_core, *args, use_reentrant=False, preserve_rng_state=False))
            else:
                outs.append(self._nff_core(*args))
        # per-chunk scalars (the carving sums) add up; per-ray tensors concatenate
        return {k: (sum(o[k] for o in outs) if outs[0][k].dim() == 0 else torch.cat([o[k] for o in outs]))
                for k in outs[0]}

    def _nff_core(self, ray_bundle: RayBundle, candidates: Optional[ActorCandidates],
                  jitter: Optional[List[torch.Tensor]] = None, train: bool = False,
                  tables: Optional[Dict[nn.Module, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Per-ray core: sampling -> fields -> K1 compositing -> depth; chunk-shape agnostic."""
        cfg = self.config
        # round i is weighted by proposal field i
        density_fns = [(lambda rs, f=f: f(rs, candidates, tables)) for f in self.proposal_fields]
        with trace.span("proposal_sampling"):
            ray_samples, weights_list, samples_list = proposal_network_sampler(
                ray_bundle,
                density_fns,
                cfg.sampling.num_proposal_samples,
                cfg.sampling.num_nerf_samples,
                initial_sampler=lambda rb, n, jitter=None: power_sampler(
                    rb, n, cfg.sampling.power_lambda, cfg.sampling.power_scaling, jitter),
                jitter=jitter,
            )
        ray_samples = _apply_sky_sample(ray_samples, cfg.sampling.sky_distance)

        with trace.span("field"):
            field_out = self.field(ray_samples, candidates, tables)
        # K1: weights, sky redistribution and feature render in one pass (and its backward)
        with trace.span("composite_sky"):
            weights_sky, features, accumulation = composite_sky(field_out["alpha"][..., 0], field_out["feature"])
        features = torch.cat([features, self._get_appearance_embedding(ray_bundle, features)], dim=-1)

        # the sky sample is left out of the depth and the losses
        weights_main = weights_sky[..., :-1]
        samples_main = _drop_last_sample(ray_samples)
        outputs = {"features": features, "depth": render_depth_simple(weights_main[..., None], samples_main),
                   "accumulation": accumulation}
        if not train:
            return outputs
        outputs["weights_final"] = weights_main
        outputs["sdist_final"] = ray_samples_to_sdist(samples_main)
        for i, (pw, prs) in enumerate(zip(weights_list, samples_list)):
            outputs[f"weights_prop_{i}"] = pw[..., 0]
            outputs[f"sdist_prop_{i}"] = ray_samples_to_sdist(prs)
            outputs[f"prop_depth_{i}"] = render_depth_simple(pw, prs)
        if "is_lidar" in ray_bundle.metadata:
            is_lidar = ray_bundle.metadata["is_lidar"]
            lidar_dist = ray_bundle.metadata["directions_norm"]
            did_return = ray_bundle.metadata.get("did_return", torch.ones_like(is_lidar))
            for i, (pw, prs) in enumerate(zip(weights_list, samples_list)):
                mask = self._not_close_to_lidar(prs, lidar_dist, did_return) & is_lidar
                outputs[f"prop_carving_sq_sum_{i}"] = torch.sum((pw[..., 0] * mask) ** 2)
            mask = self._not_close_to_lidar(samples_main, lidar_dist, did_return) & is_lidar
            outputs["carving_sq_sum"] = torch.sum((weights_main * mask) ** 2)
        return outputs

    def _not_close_to_lidar(self, ray_samples: RaySamples, lidar_dist: torch.Tensor,
                            did_return: torch.Tensor) -> torch.Tensor:
        """[r, S] mask of the samples away from the measured lidar return (or, for a ray
        without a return, beyond the non-return distance)."""
        conf = self.config.loss
        sample_dist = (ray_samples.frustums.starts[..., 0] + ray_samples.frustums.ends[..., 0]) * 0.5
        close_to_hit = torch.abs(lidar_dist - sample_dist) < conf.carving_epsilon
        in_range = sample_dist < conf.non_return_lidar_distance
        return ~torch.where(did_return, close_to_hit, in_range)

    def loss_and_metrics(self, ray_bundle: RayBundle, batch: Dict[str, torch.Tensor], layout: SegmentLayout,
                         train: bool = True, generator: Optional[torch.Generator] = None,
                         tables: Optional[Dict[nn.Module, torch.Tensor]] = None):
        """Forward and the loss terms of the JAX package's loss_and_metrics. Returns (total,
        loss_dict, metrics, outputs); the total is the sum of loss_dict in its insertion order."""
        outputs = self.get_outputs(ray_bundle, layout, train, generator, tables)
        with trace.span("losses"):
            return self._losses(outputs, ray_bundle, batch, layout, train)

    def _losses(self, outputs, ray_bundle, batch, layout, train):
        cfg = self.config
        conf = cfg.loss
        loss_dict: Dict[str, torch.Tensor] = {}
        metrics: Dict[str, torch.Tensor] = {}

        if "rgb" in outputs and "image" in batch:
            image = batch["image"]
            if image.dtype == torch.uint8:
                image = image.float() / 255.0
            rgb = outputs["rgb"]
            loss_dict["rgb_loss"] = torch.mean((image - rgb) ** 2) * conf.rgb_mult
            if conf.vgg_mult > 0.0:
                loss_dict["vgg_loss"] = self.vgg_loss(rgb, image) * conf.vgg_mult
            metrics["psnr"] = -10.0 * torch.log10(torch.mean((image - rgb.detach()) ** 2))

        if layout.num_lidar > 0 and "lidar_distance" in batch:
            did_return = batch["did_return"][..., 0]
            term_depth = batch["lidar_distance"]
            gt_intensity = batch["lidar_intensity"]
            pred_depth = layout.lidar(outputs["depth"])
            ray_drop_logits = outputs["ray_drop_logits"]
            pred_intensity = outputs["intensity"]
            with torch.no_grad():
                metrics["depth_median_l2"] = _masked_median((pred_depth - term_depth)[..., 0] ** 2, did_return)
                metrics["depth_mean_rel_l2"] = masked_mean(((pred_depth - term_depth) / term_depth)[..., 0] ** 2,
                                                           did_return)
                metrics["intensity_rmse"] = torch.sqrt(masked_mean((pred_intensity - gt_intensity)[..., 0] ** 2,
                                                                   did_return))
                metrics["ray_drop_accuracy"] = torch.mean(
                    ((torch.sigmoid(ray_drop_logits[..., 0]) > 0.5) == ~did_return).float())
            if train:
                nonret = conf.non_return_lidar_distance
                ur_loss = _depth_l1_with_nonreturns(pred_depth, term_depth, did_return, nonret,
                                                    conf.non_return_loss_mult)
                qmask = (ur_loss < torch.quantile(ur_loss.detach(), conf.quantile_threshold))[..., 0]
                depth_loss = masked_mean(ur_loss[..., 0], qmask)
                loss_dict["depth_loss"] = conf.depth_mult * depth_loss
                metrics["depth_loss"] = depth_loss.detach()
                loss_dict["intensity_loss"] = conf.intensity_mult * masked_mean(
                    (gt_intensity - pred_intensity)[..., 0] ** 2, qmask & did_return)
                loss_dict["ray_drop_loss"] = conf.ray_drop_loss_mult * torch.mean(
                    binary_cross_entropy_with_logits(ray_drop_logits[..., 0], (~did_return).float()))
                n_lidar = float(layout.num_lidar)
                loss_dict["carving_loss"] = conf.carving_mult * outputs["carving_sq_sum"] / n_lidar
                prop_d_mult = conf.prop_lidar_loss_mult * conf.depth_mult
                prop_c_mult = conf.prop_lidar_loss_mult * conf.carving_mult
                for i in range(cfg.num_proposal_rounds):
                    p_loss = _depth_l1_with_nonreturns(layout.lidar(outputs[f"prop_depth_{i}"]), term_depth,
                                                       did_return, nonret, conf.non_return_loss_mult)
                    loss_dict[f"depth_loss_{i}"] = prop_d_mult * torch.mean(p_loss)
                    loss_dict[f"carving_loss_{i}"] = prop_c_mult * outputs[f"prop_carving_sq_sum_{i}"] / n_lidar

        if "radar_output" in outputs and "radar_gt" in batch:
            gt, gt_mask = batch["radar_gt"], batch["radar_gt_mask"]
            if cfg.radar_decoder_type == "set" and conf.radar_set_loss == "detr":
                def radar_loss_fn(pred):
                    return radar_utils.detr_set_loss(gt, gt_mask, pred, assignment=conf.radar_assignment)
            else:
                def radar_loss_fn(pred):
                    return radar_utils.calculate_radar_loss(gt, gt_mask, pred, loss_type=conf.radar_loss_type,
                                                            training=train, assignment=conf.radar_assignment)

            radar_loss, _ = radar_loss_fn(outputs["radar_output"])
            metrics["radar_loss"] = radar_loss.detach()
            loss_dict["radar_loss"] = conf.radar_mult * radar_loss
            if train and "radar_aux_outputs" in outputs:
                # deep supervision: each intermediate set-decoder layer pays the same loss at full weight
                aux_total = 0.0
                for aux in outputs["radar_aux_outputs"]:
                    aux_total = aux_total + radar_loss_fn(aux)[0]
                loss_dict["radar_aux_loss"] = conf.radar_mult * aux_total

        if train:
            n = cfg.num_proposal_rounds
            sdist_list = [outputs[f"sdist_prop_{i}"] for i in range(n)] + [outputs["sdist_final"]]
            wl = [outputs[f"weights_prop_{i}"] for i in range(n)] + [outputs["weights_final"]]
            loss_dict["interlevel_loss"] = conf.interlevel_loss_mult * zipnerf_interlevel_loss_sdist(sdist_list, wl)
            dist = distortion_loss_sdist(sdist_list[-1], wl[-1])
            metrics["distortion"] = dist.detach()
            loss_dict["distortion_loss"] = conf.distortion_loss_mult * dist
            if cfg.camera_optimizer.mode != "off":
                loss_dict["camera_opt_regularizer"] = self.camera_optimizer.regularization_loss()
                metrics.update(self.camera_optimizer.metrics())

        total = torch.zeros((), device=ray_bundle.origins.device)
        for v in loss_dict.values():
            total = total + v
        return total, loss_dict, metrics, outputs

    def _scale_pixel_area(self, ray_bundle: RayBundle, layout: SegmentLayout) -> RayBundle:
        """Camera rays render at 1/u resolution: their footprint grows by u^2."""
        if layout.num_cam == 0:
            return ray_bundle
        u2 = float(self.config.rgb_upsample_factor**2)
        pa = ray_bundle.pixel_area
        return dataclasses.replace(ray_bundle, pixel_area=torch.cat([pa[: layout.num_cam] * u2,
                                                                     pa[layout.num_cam :]], dim=0))

    def _get_appearance_embedding(self, ray_bundle: RayBundle, features: torch.Tensor) -> torch.Tensor:
        """Per-sensor appearance, linearly interpolated between the embeddings of neighbouring time
        bins (or, without temporal appearance, the sensor's one embedding)."""
        sensor_idx = ray_bundle.metadata.get("sensor_idxs")
        if sensor_idx is None:
            sensor_idx = torch.zeros((features.shape[0], 1), dtype=torch.long, device=features.device)
        sensor_idx = sensor_idx[..., 0].long()
        if not self.config.use_temporal_appearance:
            return self.appearance_embedding(sensor_idx)
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


def _slice_bundle(rb: RayBundle, sl: slice) -> RayBundle:
    def cut(x):
        return None if x is None else x[sl]

    return RayBundle(origins=rb.origins[sl], directions=rb.directions[sl], pixel_area=rb.pixel_area[sl],
                     nears=cut(rb.nears), fars=cut(rb.fars), times=cut(rb.times),
                     camera_indices=cut(rb.camera_indices), metadata={k: v[sl] for k, v in rb.metadata.items()})


def _depth_l1_with_nonreturns(pred, target, did_return, nonret_dist: float, nonret_mult: float) -> torch.Tensor:
    """L1 depth loss; a ray without a return is pulled out to at least nonret_dist, at nonret_mult weight."""
    dr = did_return[..., None]
    tgt = torch.where(dr, target, torch.clamp(pred.detach(), min=nonret_dist))
    loss = torch.abs(tgt - pred)
    return torch.where(dr, loss, loss * nonret_mult)


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x over mask (the mean of the two middle values for an even count), 0 when empty."""
    vals = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf")))).values
    n = torch.sum(mask)
    last = x.shape[0] - 1
    with trace.host_sync("masked_median"):  # a 0-d index tensor is read on the host
        lo = vals[torch.clamp((n - 1) // 2, 0, last)]
    with trace.host_sync("masked_median"):
        hi = vals[torch.clamp(n // 2, 0, last)]
    return torch.where(n > 0, (lo + hi) / 2, torch.zeros_like(lo))
