"""Cameras and batched ray generation (port of the JAX package's cameras/cameras.py).

Ported: the PERSPECTIVE model without distortion, which is what the
synthetic scene emits. Other camera types, lens distortion and rolling
shutter raise instead of rendering something else.

Convention: the camera looks down -z, x right, y up; unit-plane coords are
((col + 0.5 - cx) / fx, -(row + 0.5 - cy) / fy).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from neuradar_tpu_torch.cameras.rays import RayBundle
from neuradar_tpu_torch.utils.math import normalize_with_norm


class CameraType(enum.IntEnum):
    PERSPECTIVE = 1
    FISHEYE = 2
    EQUIRECTANGULAR = 3
    OMNIDIRECTIONALSTEREO_L = 4
    OMNIDIRECTIONALSTEREO_R = 5
    ORTHOPHOTO = 6
    FISHEYE624 = 7
    VR180_L = 8
    VR180_R = 9


@dataclass
class Cameras:
    """Batched intrinsics/extrinsics ([N, ...] tensors); metadata may carry
    'sensor_idxs' [N, 1]."""

    camera_to_worlds: torch.Tensor  # [N, 3, 4]
    fx: torch.Tensor  # [N, 1]
    fy: torch.Tensor  # [N, 1]
    cx: torch.Tensor  # [N, 1]
    cy: torch.Tensor  # [N, 1]
    width: torch.Tensor  # [N, 1] int
    height: torch.Tensor  # [N, 1] int
    camera_type: torch.Tensor  # [N, 1] int
    times: Optional[torch.Tensor] = None  # [N, 1]
    metadata: Dict[str, torch.Tensor] = field(default_factory=dict)

    def __post_init__(self):
        if bool((self.camera_type != CameraType.PERSPECTIVE).any()):
            raise NotImplementedError("the port generates rays for PERSPECTIVE cameras only")

    @property
    def num_cameras(self) -> int:
        return self.camera_to_worlds.shape[0]


def generate_camera_rays(cameras: Cameras, camera_indices: torch.Tensor, coords: torch.Tensor) -> RayBundle:
    """Rays for (camera, pixel) pairs: camera_indices [R], coords [R, 2] (row, col).

    pixel_area comes from the direction deltas to the +1-pixel neighbours in
    x and y, as in the JAX package."""
    idx = camera_indices.long()
    fx, fy = cameras.fx[idx], cameras.fy[idx]
    cx, cy = cameras.cx[idx], cameras.cy[idx]
    c2w = cameras.camera_to_worlds[idx]

    rows = coords[..., 0].to(fx.dtype)[..., None]
    cols = coords[..., 1].to(fx.dtype)[..., None]

    def dirs_for(r, c):
        u = (c + 0.5 - cx) / fx
        v_cv = (r + 0.5 - cy) / fy  # OpenCV frame (y down)
        return torch.cat([u, -v_cv, -torch.ones_like(u)], dim=-1)

    rot = c2w[..., :3, :3]

    def to_world(d):
        return torch.einsum("rij,rj->ri", rot, d)

    d0, n0 = normalize_with_norm(to_world(dirs_for(rows, cols)))
    d1, _ = normalize_with_norm(to_world(dirs_for(rows, cols + 1)))
    d2, _ = normalize_with_norm(to_world(dirs_for(rows + 1, cols)))
    dx = torch.linalg.vector_norm(d0 - d1, dim=-1)
    dy = torch.linalg.vector_norm(d0 - d2, dim=-1)
    pixel_area = (dx * dy)[..., None]

    metadata = {k: v[idx] for k, v in cameras.metadata.items()}
    metadata["directions_norm"] = n0
    return RayBundle(
        origins=c2w[..., :3, 3],
        directions=d0,
        pixel_area=pixel_area,
        camera_indices=idx[..., None].int(),
        times=cameras.times[idx] if cameras.times is not None else None,
        metadata=metadata,
        fars=torch.full_like(pixel_area, 1e6),
    )
