"""AD NeuRadar pipeline: sensor tables + model + the render entry points
(port of the JAX package's pipelines/ad_neuradar_pipeline.py: the constructor,
``render_camera``, ``render_lidar`` and ``render_radar``).

Everything runs on one explicit ``device``; there is no fallback to another.
The render methods return tensors on that device (the JAX package returns
numpy arrays), apart from the host-side lidar ``points`` and ``num_valid``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence, Union

import numpy as np
import torch

from neuradar_tpu_torch.cameras.cameras import generate_camera_rays
from neuradar_tpu_torch.data.datamanager import build_sensor_tables, merge_modality_bundles
from neuradar_tpu_torch.data.dataparsers.base import DataparserOutputs
from neuradar_tpu_torch.model_components.dynamic_actors import trajectories_from_dicts
from neuradar_tpu_torch.models.neuradar import NeuRadarModel, NeuRadarModelConfig, SceneMeta, SegmentLayout
from neuradar_tpu_torch.utils.params import init_params


@dataclass
class ADNeuRadarPipelineConfig:
    model: NeuRadarModelConfig = field(default_factory=NeuRadarModelConfig)


class ADNeuRadarPipeline:
    """Owns the sensor tables and the model (eval mode, seeded weights)."""

    def __init__(self, config: ADNeuRadarPipelineConfig, outputs: DataparserOutputs,
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        self.config = config
        self.outputs = outputs
        self.device = torch.device(device)
        self.tables = build_sensor_tables(outputs, self.device)
        scene = SceneMeta(
            static_scale=float(np.abs(outputs.scene_box.aabb).max()),
            duration=float(outputs.duration),
            num_sensors=len(outputs.sensor_idx_to_name),
        )
        with self.device:
            self.model = NeuRadarModel(config.model, scene, trajectories_from_dicts(outputs.trajectories))
        self.model.to(self.device).eval()
        init_params(self.model, seed)

    @torch.inference_mode()
    def render_camera(self, cam_idx: int) -> Dict[str, torch.Tensor]:
        """Full-image render: one ray per u x u pixel block, chunked at
        eval_num_rays_per_chunk (the last chunk padded by repeating its last
        ray), then the upsampling CNN -> rgb [H, W, 3], depth and
        accumulation [H/u, W/u]."""
        m = self.config.model
        u = m.rgb_upsample_factor
        H, W = self.outputs.image_size
        h, w = H // u, W // u
        rows = torch.arange(h, device=self.device) * u + u // 2
        cols = torch.arange(w, device=self.device) * u + u // 2
        rr, cc = torch.meshgrid(rows, cols, indexing="ij")
        coords = torch.stack([rr.reshape(-1), cc.reshape(-1)], dim=1)
        n_rays = coords.shape[0]
        chunk = min(m.eval_num_rays_per_chunk, n_rays)
        n_pad = (-n_rays) % chunk
        if n_pad:
            coords = torch.cat([coords, coords[-1:].expand(n_pad, 2)])
        layout = SegmentLayout(num_cam=chunk, patch_size=(h, w))

        outs = []
        for i in range(0, coords.shape[0], chunk):
            cam_ids = torch.full((chunk,), cam_idx, dtype=torch.long, device=self.device)
            bundle = merge_modality_bundles(generate_camera_rays(self.tables.cameras, cam_ids, coords[i : i + chunk]),
                                            None, None)
            outs.append(self.model.get_nff_outputs(bundle, layout))
        features = torch.cat([o["features"] for o in outs])[:n_rays]
        depth = torch.cat([o["depth"] for o in outs])[:n_rays]
        acc = torch.cat([o["accumulation"] for o in outs])[:n_rays]
        rgb = self.model.decode_camera_features(features, (h, w))[0]
        return {"rgb": rgb, "depth": depth.reshape(h, w), "accumulation": acc.reshape(h, w)}

    @torch.inference_mode()
    def render_lidar(self, scan_idx: int, max_points: int = 16384) -> Dict[str, object]:
        """Render a lidar scan subsampled (seeded) or padded to max_points rays."""
        pts = self.outputs.lidar_points[scan_idx]
        num_valid = min(len(pts), max_points)
        if len(pts) > max_points:
            pts = pts[np.random.RandomState(0).choice(len(pts), max_points, replace=False)]
        elif len(pts) == 0:  # empty scan: all-padding bundle, num_valid = 0
            pts = np.zeros((max_points, 4), np.float32)
            pts[:, 0] = 1.0
        else:
            pts = np.concatenate([pts, np.repeat(pts[-1:], max_points - len(pts), axis=0)], axis=0)
        bundle = self.tables.lidars.generate_rays(
            torch.full((max_points,), scan_idx, dtype=torch.long, device=self.device),
            torch.as_tensor(pts, dtype=torch.float32, device=self.device),
        )
        outputs = self.model.get_outputs(merge_modality_bundles(None, bundle, None),
                                         SegmentLayout(num_lidar=max_points))
        return {
            "depth": outputs["depth"],
            "intensity": outputs["intensity"],
            "ray_drop_prob": torch.sigmoid(outputs["ray_drop_logits"]),
            "points": pts,
            "num_valid": num_valid,  # rows past it repeat the last point
        }

    @torch.inference_mode()
    def render_radar(self, scan_idx: Union[int, Sequence[int]]) -> Dict[str, torch.Tensor]:
        """Multi-Bernoulli radar output: [n_mb, 7] for one scan index, or
        [n_scans, n_mb, 7] for a sequence rendered as one batch."""
        single = isinstance(scan_idx, (int, np.integer))
        ids = torch.as_tensor([scan_idx] if single else list(scan_idx), dtype=torch.long, device=self.device)
        radars = self.tables.radars
        layout = SegmentLayout(num_radar_scans=len(ids), rays_per_scan=radars.rays_per_scan)
        outputs = self.model.get_outputs(merge_modality_bundles(None, None, radars.generate_rays(ids)), layout)
        radar_output = outputs["radar_output"]
        return {"radar_output": radar_output[0] if single else radar_output}
