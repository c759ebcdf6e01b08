"""Sensor tables on the device and modality merging (port of the JAX
package's data/datamanager.py: ``build_sensor_tables`` and
``merge_modality_bundles``; the training sampler comes with the train step)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from neuradar_tpu_torch.cameras.cameras import Cameras
from neuradar_tpu_torch.cameras.lidars import Lidars
from neuradar_tpu_torch.cameras.radars import Radars, fov_grid
from neuradar_tpu_torch.cameras.rays import RayBundle
from neuradar_tpu_torch.data.dataparsers.base import DataparserOutputs


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
    if out.distortion_params is not None:
        raise NotImplementedError("the port renders undistorted cameras only")
    if out.camera_velocities is not None and out.rolling_shutter_offsets is not None:
        raise NotImplementedError("the port does not compensate rolling shutter yet")

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    nc = len(out.camera_to_worlds)
    cameras = Cameras(
        camera_to_worlds=t(out.camera_to_worlds),
        fx=t(out.intrinsics[:, 0:1]),
        fy=t(out.intrinsics[:, 1:2]),
        cx=t(out.intrinsics[:, 2:3]),
        cy=t(out.intrinsics[:, 3:4]),
        width=torch.full((nc, 1), out.image_size[1], dtype=torch.int32, device=device),
        height=torch.full((nc, 1), out.image_size[0], dtype=torch.int32, device=device),
        camera_type=t(out.camera_type[:, None], torch.int32),
        times=t(out.camera_times[:, None]),
        metadata={"sensor_idxs": t(out.camera_sensor_idxs[:, None], torch.int32)},
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
