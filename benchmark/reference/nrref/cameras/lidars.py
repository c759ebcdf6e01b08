"""Lidar sensors: rays from measured points (port of the JAX package's cameras/lidars.py).

Point format: x, y, z, intensity, time, channel (sensor frame).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from reference.nrref.cameras.rays import RayBundle
from reference.nrref.utils.math import normalize_with_norm
from reference.nrref.utils.poses import transform_points_pairwise

HORIZONTAL_BEAM_DIVERGENCE = 3.0e-3  # radians
VERTICAL_BEAM_DIVERGENCE = 1.5e-3  # radians
VALID_LIDAR_DISTANCE_THRESHOLD = 1e3  # meters


@dataclass
class Lidars:
    """Batched lidar extrinsics ([N, ...] tensors)."""

    lidar_to_worlds: torch.Tensor  # [N, 3, 4]
    lidar_type: torch.Tensor  # [N, 1] int
    times: Optional[torch.Tensor] = None  # [N, 1]
    metadata: Dict[str, torch.Tensor] = field(default_factory=dict)
    horizontal_beam_divergence: float = HORIZONTAL_BEAM_DIVERGENCE
    vertical_beam_divergence: float = VERTICAL_BEAM_DIVERGENCE
    valid_lidar_distance_threshold: float = VALID_LIDAR_DISTANCE_THRESHOLD

    def generate_rays(self, lidar_indices: torch.Tensor, points: torch.Tensor) -> RayBundle:
        """Rays from measured points: lidar_indices [R], points [R, >=3]."""
        idx = lidar_indices.long()
        l2w = self.lidar_to_worlds[idx]
        points_world = transform_points_pairwise(points[..., :3], l2w)
        origins = l2w[..., :3, 3]

        has_time = points.shape[-1] >= 5
        if has_time and "velocities" in self.metadata:
            # points are ego-motion compensated; the sensor moves along the sweep
            origins = origins + points[..., 4:5] * self.metadata["velocities"][idx]

        directions, distance = normalize_with_norm(points_world - origins)
        pixel_area = torch.full_like(distance, self.horizontal_beam_divergence * self.vertical_beam_divergence)

        metadata = {k: v[idx] for k, v in self.metadata.items() if k != "velocities"}
        metadata["directions_norm"] = distance
        metadata["is_lidar"] = torch.ones_like(distance, dtype=torch.bool)
        metadata["did_return"] = distance < self.valid_lidar_distance_threshold

        times = self.times[idx] if self.times is not None else torch.zeros_like(distance)
        if has_time:
            times = times + points[..., 4:5]
        return RayBundle(
            origins=origins,
            directions=directions,
            pixel_area=pixel_area,
            camera_indices=idx[..., None].int(),
            times=times,
            metadata=metadata,
            fars=torch.full_like(pixel_area, 1e6),
        )
