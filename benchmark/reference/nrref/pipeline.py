"""The plain reference of the benchmark's cells: the model of a configuration file, its train loss,
its free-pose camera render and its radar render, on the reference's own modules (a frozen copy of
the port's plain paths: K1 and K2 as plain PyTorch, no hand-written kernel, no import of the port).

``ReferencePipeline`` takes the model's configuration (``model_config`` of a configuration file's
``model`` entry), the file's ``batch`` entry, the scene (``DataparserOutputs`` of this package) and a
device; ``train_loss`` is the differentiable loss of one host
batch, ``render_pose`` and ``render_radar`` the answers of the render requests.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from reference.nrref.cameras.camera_optimizers import CameraOptimizerConfig
from reference.nrref.cameras.cameras import Cameras, generate_camera_rays
from reference.nrref.data.datamanager import (
    ADDataManagerConfig,
    batch_to_device,
    build_sensor_tables,
    build_train_bundle,
    merge_modality_bundles,
)
from reference.nrref.data.dataparsers.base import DataparserOutputs
from reference.nrref.engine.optimizers import GroupedOptimizer, default_optimizer_groups
from reference.nrref.model_components.dynamic_actors import trajectories_from_dicts
from reference.nrref.models.neuradar import NeuRadarModel, NeuRadarModelConfig, SceneMeta, SegmentLayout


def model_config(spec: Dict) -> NeuRadarModelConfig:
    """The model of a configuration file's ``model`` entry; every other setting is the model's
    default, as in the paper's preset."""
    cfg = NeuRadarModelConfig()
    cfg.compute_dtype = spec["compute_dtype"]
    cfg.nff_chunks = spec["nff_chunks"]
    cfg.radar_decode_chunks = spec["radar_decode_chunks"]
    cfg.loss.vgg_mult = spec["vgg_mult"]
    cfg.loss.radar_assignment = spec["radar_assignment"]
    cfg.camera_optimizer = CameraOptimizerConfig(mode=spec["camera_optimizer"])
    cfg.eval_num_rays_per_chunk = spec["eval_num_rays_per_chunk"]
    return cfg


def datamanager_config(spec: Dict) -> ADDataManagerConfig:
    """The batch of a configuration file's ``batch`` entry."""
    return ADDataManagerConfig(num_rgb_patches=spec["num_rgb_patches"], patch_size=spec["patch_size"],
                               num_lidar_rays=spec["num_lidar_rays"], num_radar_scans=spec["num_radar_scans"],
                               max_radar_gt=spec["max_radar_gt"])


class ReferencePipeline:
    def __init__(self, config: NeuRadarModelConfig, batch_spec: Dict, outputs: DataparserOutputs, device):
        self.config = config
        self.outputs = outputs
        self.device = torch.device(device)
        self.tables = build_sensor_tables(outputs, self.device)
        dm = datamanager_config(batch_spec)
        self.layout = SegmentLayout(num_cam=dm.num_rgb_patches * dm.patch_size**2, num_lidar=dm.num_lidar_rays,
                                    num_radar_scans=dm.num_radar_scans,
                                    rays_per_scan=int(self.tables.radars.rays_per_scan),
                                    patch_size=(dm.patch_size, dm.patch_size))
        scene = SceneMeta(
            static_scale=float(np.abs(outputs.scene_box.aabb).max()),
            duration=float(outputs.duration),
            num_sensors=len(outputs.sensor_idx_to_name),
            num_train_frames=len(outputs.camera_to_worlds) + len(outputs.lidar_to_worlds)
            + len(outputs.radar_to_worlds),
        )
        with self.device:
            self.model = NeuRadarModel(self.config, scene, trajectories_from_dicts(outputs.trajectories),
                                       decode_radar=self.layout.num_radar_scans > 0)
        self.model.to(self.device).eval()

    def optimizer(self, max_steps: int) -> GroupedOptimizer:
        return GroupedOptimizer(self.model, default_optimizer_groups(max_steps))

    def train_loss(self, batch: Dict[str, np.ndarray], generator: torch.Generator):
        """(total, loss_dict): the training forward and losses of one host batch."""
        dev = batch_to_device(batch, self.device)
        bundle = build_train_bundle(self.tables, dev, self.layout, self.config.rgb_upsample_factor)
        total, loss_dict, _, _ = self.model.loss_and_metrics(bundle, dev, self.layout, True, generator,
                                                             self.model.cast_tables())
        return total, loss_dict

    def render_grid(self, cameras: Cameras, hw: Tuple[int, int]) -> torch.Tensor:
        """rgb [h*u, w*u, 3] of an h x w grid of rays of camera 0 of ``cameras``, chunked as the
        configuration's render chunks, then the upsampling CNN."""
        m = self.config
        u = m.rgb_upsample_factor
        h, w = hw
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
        tables = self.model.cast_tables()
        feats = []
        for i in range(0, coords.shape[0], chunk):
            cam_ids = torch.zeros((chunk,), dtype=torch.long, device=self.device)
            bundle = merge_modality_bundles(generate_camera_rays(cameras, cam_ids, coords[i:i + chunk]), None, None)
            feats.append(self.model.get_nff_outputs(bundle, layout, tables=tables)["features"])
        return self.model.decode_camera_features(torch.cat(feats)[:n_rays], (h, w))[0]

    @torch.inference_mode()
    def render_pose(self, c2w: np.ndarray, hw: Tuple[int, int], time_s: float) -> np.ndarray:
        """The uint8 image [H, W, 3] of a perspective camera at pose ``c2w`` [3, 4] and ``hw`` (cut to
        multiples of the upsample factor u), fx = fy the scene's first camera's focal length scaled
        to the width, the principal point at the centre, the actors at ``time_s``."""
        u = self.config.rgb_upsample_factor
        H, W = hw[0] // u * u, hw[1] // u * u
        fx = float(self.outputs.intrinsics[0, 0]) * W / float(self.outputs.image_size[1])

        def one(x, dtype=torch.float32):
            return torch.tensor([[x]], dtype=dtype, device=self.device)

        cameras = Cameras(
            camera_to_worlds=torch.as_tensor(np.asarray(c2w, np.float32)[:3, :4], device=self.device)[None],
            fx=one(fx), fy=one(fx), cx=one(W / 2), cy=one(H / 2),
            width=one(W, torch.int32), height=one(H, torch.int32), camera_type=one(1, torch.int32),
            times=one(time_s), metadata={"sensor_idxs": one(0, torch.int32)},
        )
        rgb = self.render_grid(cameras, (H // u, W // u))
        return (rgb.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()

    @torch.inference_mode()
    def render_radar(self, scan_idx: int) -> np.ndarray:
        """The multi-Bernoulli output [rays, 7] of one radar scan, on the host."""
        ids = torch.as_tensor([scan_idx], dtype=torch.long, device=self.device)
        radars = self.tables.radars
        layout = SegmentLayout(num_radar_scans=1, rays_per_scan=radars.rays_per_scan)
        outputs = self.model.get_outputs(merge_modality_bundles(None, None, radars.generate_rays(ids)), layout,
                                         tables=self.model.cast_tables())
        return outputs["radar_output"][0].float().cpu().numpy()
