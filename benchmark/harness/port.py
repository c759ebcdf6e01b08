"""The system under test: the port's objects built from a configuration file, and nothing else.

This is the one module of the harness that imports ``neuradar_tpu_torch``. It turns the benchmark's
scene into the port's ``DataparserOutputs``, takes the configuration's preset from the port's
registry, checks that the preset is what the configuration file states, and builds the trainer or
the pipeline on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from neuradar_tpu_torch.configs.method_configs import get_method
from neuradar_tpu_torch.data.dataparsers import base as port_base
from neuradar_tpu_torch.engine.trainer import Trainer
from neuradar_tpu_torch.pipelines.ad_neuradar_pipeline import ADNeuRadarPipeline


def port_outputs(outputs) -> port_base.DataparserOutputs:
    """The benchmark's scene as the port's container (the same arrays)."""
    fields = {f.name: getattr(outputs, f.name) for f in dataclasses.fields(outputs)}
    fields["scene_box"] = port_base.SceneBox(aabb=outputs.scene_box.aabb)
    for name in ("camera_split", "lidar_split", "radar_split"):
        split = fields[name]
        fields[name] = port_base.SensorSplit(train=split.train, eval=split.eval)
    return port_base.DataparserOutputs(**fields)


def _preset(config: Dict):
    """The registry's preset of the configuration, held to what the configuration file states."""
    cfg = get_method(config["preset"])
    m, dm, spec = cfg.pipeline.model, cfg.pipeline.datamanager, config["model"]
    stated = {
        "compute_dtype": m.compute_dtype, "nff_chunks": m.nff_chunks, "radar_decode_chunks": m.radar_decode_chunks,
        "vgg_mult": m.loss.vgg_mult, "radar_assignment": m.loss.radar_assignment,
        "camera_optimizer": m.camera_optimizer.mode, "eval_num_rays_per_chunk": m.eval_num_rays_per_chunk,
        "max_steps": cfg.max_num_iterations,
    }
    batch = {"num_rgb_patches": dm.num_rgb_patches, "patch_size": dm.patch_size, "num_lidar_rays": dm.num_lidar_rays,
             "num_radar_scans": dm.num_radar_scans, "max_radar_gt": dm.max_radar_gt}
    wrong = {k: (v, spec[k]) for k, v in stated.items() if spec[k] != v}
    wrong.update({k: (v, config["batch"][k]) for k, v in batch.items() if config["batch"][k] != v})
    if wrong:
        raise ValueError(f"preset {config['preset']!r} differs from its configuration file (preset, file): {wrong}")
    return cfg


def build_trainer(config: Dict, outputs, seed: int, device: torch.device) -> Trainer:
    """The preset's trainer on the scene, its batch sampler and step generator seeded by ``seed``,
    with the prefetch thread on."""
    cfg = _preset(config)
    cfg.seed = seed
    cfg.pipeline.datamanager.seed = seed
    trainer = Trainer(cfg, port_outputs(outputs), device)
    trainer.setup(prefetch=True)
    return trainer


def build_pipeline(config: Dict, outputs, seed: int, device: torch.device) -> ADNeuRadarPipeline:
    """The preset's pipeline on the scene (what the render commands and the closed-loop server
    load), in eval mode."""
    cfg = _preset(config)
    pipeline = ADNeuRadarPipeline(cfg.pipeline, port_outputs(outputs), device, seed=seed)
    pipeline.model.eval()
    return pipeline


def render_radar(pipeline: ADNeuRadarPipeline, scan_idx: int) -> np.ndarray:
    """One radar request: the scan's multi-Bernoulli output [rays, 7] on the host."""
    return pipeline.render_radar(int(scan_idx))["radar_output"].cpu().numpy()


def render_camera(pipeline: ADNeuRadarPipeline, c2w: np.ndarray, hw, time_s: float) -> np.ndarray:
    """One camera request: the closed-loop server's frame, a uint8 image [H, W, 3] on the host."""
    return pipeline.render_pose(c2w, hw=tuple(hw), time_s=float(time_s))
