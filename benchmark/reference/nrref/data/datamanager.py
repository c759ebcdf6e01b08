"""Device-side ray generation of a host batch: the sensor tables of a scene, the merged
[camera | lidar | radar] bundle of a batch's indices (the reference's copy of the port's
data/datamanager.py without its sampler; the benchmark hands the reference the batches the program
drew)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from reference.nrref.cameras.cameras import Cameras, generate_camera_rays
from reference.nrref.cameras.lidars import Lidars
from reference.nrref.cameras.radars import Radars, fov_grid
from reference.nrref.cameras.rays import RayBundle
from reference.nrref.data.dataparsers.base import DataparserOutputs
from reference.nrref.models.neuradar import SegmentLayout


@dataclass
class ADDataManagerConfig:
    """Batch composition: 40 patches of 32 x 32 camera rays + 16,384 lidar rays + 16 radar scans."""

    num_rgb_patches: int = 40
    patch_size: int = 32  # rendered rays per patch side
    num_lidar_rays: int = 16384
    num_radar_scans: int = 16
    max_radar_gt: int = 256
    prefetch_depth: int = 4
    seed: int = 42


@dataclass
class SensorTables:
    """Device-resident sensor tables."""

    cameras: Cameras
    lidars: Lidars
    radars: Radars
    num_cam_frames: int = 0
    num_lidar_frames: int = 0
    num_radar_frames: int = 0


def build_sensor_tables(out: DataparserOutputs, device: torch.device) -> SensorTables:
    """The device tables of a scene; the camera table carries the lens distortion and, where the
    scene has sensor velocities and readout offsets, rolling shutter."""
    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    nc = len(out.camera_to_worlds)
    cam_meta = {"sensor_idxs": t(out.camera_sensor_idxs[:, None], torch.int32)}
    if out.camera_velocities is not None and out.rolling_shutter_offsets is not None:
        cam_meta["velocities"] = t(out.camera_velocities)
        cam_meta["rolling_shutter_offsets"] = t(out.rolling_shutter_offsets)
        if out.rolling_shutter_horizontal is not None:
            cam_meta["rs_horizontal"] = t(out.rolling_shutter_horizontal, torch.bool)[:, None]
    cameras = Cameras(
        camera_to_worlds=t(out.camera_to_worlds),
        fx=t(out.intrinsics[:, 0:1]),
        fy=t(out.intrinsics[:, 1:2]),
        cx=t(out.intrinsics[:, 2:3]),
        cy=t(out.intrinsics[:, 3:4]),
        width=torch.full((nc, 1), out.image_size[1], dtype=torch.int32, device=device),
        height=torch.full((nc, 1), out.image_size[0], dtype=torch.int32, device=device),
        camera_type=t(out.camera_type[:, None], torch.int32),
        distortion_params=None if out.distortion_params is None else t(out.distortion_params),
        times=t(out.camera_times[:, None]),
        metadata=cam_meta,
    )
    lidar_meta = {"sensor_idxs": t(out.lidar_sensor_idxs[:, None], torch.int32)}
    if out.lidar_velocities is not None:
        lidar_meta["velocities"] = t(out.lidar_velocities)
    lidars = Lidars(
        lidar_to_worlds=t(out.lidar_to_worlds),
        lidar_type=torch.zeros((len(out.lidar_to_worlds), 1), dtype=torch.int32, device=device),
        times=t(out.lidar_times[:, None]),
        metadata=lidar_meta,
    )
    # camera-only datasets carry no radar FoV; any placeholder works since
    # num_radar_frames == 0 gates all use
    fov = out.radar_fov or {
        "min_azimuth": -0.5, "max_azimuth": 0.5, "min_elevation": -0.1,
        "max_elevation": 0.1, "azimuth_step": 0.1, "elevation_step": 0.1,
    }
    radars = Radars(
        radar_to_worlds=t(out.radar_to_worlds),
        radar_type=torch.zeros((len(out.radar_to_worlds), 1), dtype=torch.int32, device=device),
        fov_directions=t(fov_grid(fov["min_azimuth"], fov["max_azimuth"], fov["min_elevation"],
                                  fov["max_elevation"], fov["azimuth_step"], fov["elevation_step"])),
        times=t(out.radar_times[:, None]),
        metadata={"sensor_idxs": t(out.radar_sensor_idxs[:, None], torch.int32)},
        azimuth_ray_divergence=fov["azimuth_step"],
        elevation_ray_divergence=fov["elevation_step"],
    )
    return SensorTables(
        cameras=cameras,
        lidars=lidars,
        radars=radars,
        num_cam_frames=nc,
        num_lidar_frames=len(out.lidar_to_worlds),
        num_radar_frames=len(out.radar_to_worlds),
    )


def merge_modality_bundles(cam: Optional[RayBundle], lidar: Optional[RayBundle],
                           radar: Optional[RayBundle]) -> RayBundle:
    """Concatenate [cam | lidar | radar] bundles; metadata keys are the union,
    zero-filled where a modality lacks them (did_return defaults to True and
    directions_norm to 1)."""
    bundles = [b for b in (cam, lidar, radar) if b is not None]
    keys = set()
    donors = {}
    for b in bundles:
        keys |= set(b.metadata.keys())
        for k, v in b.metadata.items():
            donors.setdefault(k, v)
    for b in bundles:
        n = b.origins.shape[0]
        md = dict(b.metadata)
        if "did_return" not in md and "did_return" in keys:
            md["did_return"] = torch.ones((n, 1), dtype=torch.bool, device=b.origins.device)
        if "directions_norm" not in md:
            md["directions_norm"] = torch.ones((n, 1), dtype=b.origins.dtype, device=b.origins.device)
        for k in keys:
            if k not in md:
                donor = donors[k]
                md[k] = torch.zeros((n, *donor.shape[1:]), dtype=donor.dtype, device=donor.device)
        b.metadata = md

    def cat(name):
        vals = [getattr(b, name) for b in bundles]
        if all(v is None for v in vals):
            return None
        if name == "times":
            # zero-fill bundles without timestamps instead of dropping the
            # real per-point times other modalities carry
            vals = [v if v is not None else torch.zeros_like(b.origins[:, :1]) for v, b in zip(vals, bundles)]
        elif any(v is None for v in vals):
            return None
        return torch.cat(vals, dim=0)

    return RayBundle(
        origins=cat("origins"),
        directions=cat("directions"),
        pixel_area=cat("pixel_area"),
        nears=cat("nears"),
        fars=cat("fars"),
        times=cat("times"),
        camera_indices=cat("camera_indices"),
        metadata={k: torch.cat([b.metadata[k] for b in bundles], dim=0) for k in sorted(keys)},
    )


def build_train_bundle(tables: SensorTables, batch: Dict[str, torch.Tensor], layout: SegmentLayout,
                       rgb_upsample_factor: int = 3) -> RayBundle:
    """The merged [cam | lidar | radar] bundle of a batch already on the device. Camera
    patches shoot one ray at the centre of every u x u block of ground-truth pixels."""
    ps = layout.patch_size[0]
    u = rgb_upsample_factor
    cam_bundle = lidar_bundle = radar_bundle = None
    if layout.num_cam > 0:
        grid = torch.arange(ps, device=batch["patch_tl"].device) * u + u // 2
        rr, cc = torch.meshgrid(grid, grid, indexing="ij")
        offsets = torch.stack([rr.reshape(-1), cc.reshape(-1)], dim=-1)  # [ps*ps, 2]
        coords = batch["patch_tl"][:, None, :].long() + offsets[None]
        cam_idx = torch.repeat_interleave(batch["cam_frame_idx"].long(), ps * ps)
        with record_function("ray_generation"):
            cam_bundle = generate_camera_rays(tables.cameras, cam_idx, coords.reshape(-1, 2))
    if layout.num_lidar > 0:
        lidar_bundle = tables.lidars.generate_rays(batch["lidar_scan_idx"], batch["lidar_points"])
        # frame-index offsets, so the camera optimizer sees unique frame ids
        lidar_bundle.camera_indices = lidar_bundle.camera_indices + tables.num_cam_frames
    if layout.num_radar_scans > 0:
        radar_bundle = tables.radars.generate_rays(batch["radar_scan_idx"])
        radar_bundle.camera_indices = radar_bundle.camera_indices + tables.num_cam_frames + tables.num_lidar_frames
    return merge_modality_bundles(cam_bundle, lidar_bundle, radar_bundle)


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host batch -> device tensors (the image stays uint8 and is normalized in the loss)."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}
