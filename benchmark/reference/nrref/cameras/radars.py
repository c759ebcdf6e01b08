"""Radar sensors: rays on a fixed azimuth x elevation FoV grid per scan
(port of the JAX package's cameras/radars.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from reference.nrref.cameras.rays import RayBundle
from reference.nrref.utils.poses import transform_points_pairwise

RADAR_AZIMUTH_RAY_DIVERGENCE = 0.015  # radians
RADAR_ELEVATION_RAY_DIVERGENCE = 0.015


def fov_grid(
    min_azimuth: float,
    max_azimuth: float,
    min_elevation: float,
    max_elevation: float,
    azimuth_step: float,
    elevation_step: float,
) -> np.ndarray:
    """Static (azimuth, elevation) grid for one radar FoV: [n_rays, 2], az-major.

    Counts follow torch.arange: size = ceil((stop - start) / step) in float64
    (ZOD's elevation span gives 33 rows, so 107 x 33 = 3,531 rays a scan)."""
    n_az = int(np.ceil((np.float64(max_azimuth) - np.float64(min_azimuth)) / np.float64(azimuth_step)))
    n_el = int(np.ceil((np.float64(max_elevation) - np.float64(min_elevation)) / np.float64(elevation_step)))
    azimuths = (min_azimuth + np.arange(n_az) * azimuth_step).astype(np.float32)
    elevations = (min_elevation + np.arange(n_el) * elevation_step).astype(np.float32)
    az, el = np.meshgrid(azimuths, elevations, indexing="ij")
    return np.stack([az.reshape(-1), el.reshape(-1)], axis=1)


@dataclass
class Radars:
    """Batched radar extrinsics ([N, ...] tensors) plus the shared FoV grid
    [rays_per_scan, 2] (azimuth, elevation)."""

    radar_to_worlds: torch.Tensor  # [N, 3, 4]
    radar_type: torch.Tensor  # [N, 1] int
    fov_directions: torch.Tensor  # [rays_per_scan, 2]
    times: Optional[torch.Tensor] = None  # [N, 1]
    metadata: Dict[str, torch.Tensor] = field(default_factory=dict)
    azimuth_ray_divergence: float = RADAR_AZIMUTH_RAY_DIVERGENCE
    elevation_ray_divergence: float = RADAR_ELEVATION_RAY_DIVERGENCE

    @property
    def rays_per_scan(self) -> int:
        return self.fov_directions.shape[0]

    def generate_rays(self, scan_indices: torch.Tensor) -> RayBundle:
        """Rays for whole scans, flattened [n_scans * rays_per_scan]."""
        scan_indices = scan_indices.long()
        n_scans = scan_indices.shape[0]
        nr = self.rays_per_scan

        ray_scan_idx = torch.repeat_interleave(scan_indices, nr)
        spher = self.fov_directions.repeat(n_scans, 1)

        r2w = self.radar_to_worlds[ray_scan_idx]
        az, el = spher[:, 0], spher[:, 1]
        dirs_local = torch.stack([torch.cos(el) * torch.cos(az), torch.cos(el) * torch.sin(az), torch.sin(el)], dim=-1)
        directions = transform_points_pairwise(dirs_local, r2w, with_translation=False)
        distance = torch.ones((directions.shape[0], 1), dtype=directions.dtype, device=directions.device)
        footprint = (self.azimuth_ray_divergence / 5.0) * (self.elevation_ray_divergence / 5.0)
        pixel_area = torch.full_like(distance, footprint)

        metadata = {k: v[ray_scan_idx] for k, v in self.metadata.items()}
        metadata["directions_norm"] = distance
        metadata["directions_spher"] = spher
        metadata["did_return"] = torch.ones_like(distance, dtype=torch.bool)
        metadata["is_radar"] = torch.ones_like(distance, dtype=torch.bool)
        return RayBundle(
            origins=r2w[..., :3, 3],
            directions=directions,
            pixel_area=pixel_area,
            camera_indices=ray_scan_idx[..., None].int(),
            times=self.times[ray_scan_idx] if self.times is not None else None,
            metadata=metadata,
            fars=torch.full_like(pixel_area, 1e6),
        )


# ZOD front radar FoV (cf. zod_dataparser.py:138-140)
ZOD_RADAR_FOV = dict(
    min_azimuth=-0.80, max_azimuth=0.80, min_elevation=-0.08, max_elevation=0.40,
    azimuth_step=0.015, elevation_step=0.015,
)
# VoD's 3+1D radar FoV: 100 azimuths x 44 elevations = 4,400 rays a scan
VOD_RADAR_FOV = dict(
    min_azimuth=-1.0, max_azimuth=1.0, min_elevation=-0.39, max_elevation=0.49,
    azimuth_step=0.02, elevation_step=0.02,
)
