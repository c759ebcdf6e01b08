"""Pose algebra and trajectory interpolation (port of the JAX package's utils/poses.py,
the parts the render path uses)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def inverse(pose: torch.Tensor) -> torch.Tensor:
    """Invert [..., 3, 4] rigid poses."""
    R = pose[..., :3, :3]
    t = pose[..., :3, 3:]
    R_inv = R.transpose(-2, -1)
    return torch.cat([R_inv, -R_inv @ t], dim=-1)


def transform_points_pairwise(points: torch.Tensor, poses: torch.Tensor, with_translation: bool = True) -> torch.Tensor:
    """Apply [..., 3, 4] poses to matching [..., 3] points."""
    rotated = torch.einsum("...ij,...j->...i", poses[..., :3, :3], points)
    if with_translation:
        rotated = rotated + poses[..., :3, 3]
    return rotated


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation representation -> rotation matrix via Gram-Schmidt."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True).clamp(min=1e-12)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True).clamp(min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def interpolate_trajectories_6d(
    poses_9d: torch.Tensor,
    pose_times: torch.Tensor,
    query_times: torch.Tensor,
    pose_valid_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linearly interpolate [T, A, 9] (6D rot + pos) trajectories at [Q] times:
    returns [Q, A, 9] and the validity mask [Q, A]."""
    a1 = poses_9d[..., :3]
    a1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True).clamp(min=1e-12)
    a2 = poses_9d[..., 3:6]
    a2 = a2 - torch.sum(a1 * a2, dim=-1, keepdim=True) * a1
    a2 = a2 / torch.linalg.vector_norm(a2, dim=-1, keepdim=True).clamp(min=1e-12)
    poses = torch.cat([a1, a2, poses_9d[..., 6:9]], dim=-1)

    right_idx = torch.searchsorted(pose_times, query_times)  # side="left", as jnp.searchsorted
    left_idx = torch.clamp(right_idx - 1, min=0)
    right_idx = torch.clamp(right_idx, max=pose_times.shape[0] - 1)

    left_time = pose_times[left_idx]
    right_time = pose_times[right_idx]
    frac = torch.clamp((query_times - left_time) / (right_time - left_time + 1e-6), 0.0, 1.0)

    if pose_valid_mask is None:
        pose_valid_mask = torch.ones(poses.shape[:2], dtype=torch.bool, device=poses.device)
    valid = pose_valid_mask[left_idx] | pose_valid_mask[right_idx]

    poses_left = poses[left_idx]
    poses_right = poses[right_idx]
    return poses_left + (poses_right - poses_left) * frac[:, None, None], valid


def interpolate_poses_9d_to_matrices(poses_9d: torch.Tensor) -> torch.Tensor:
    """[..., 9] (6D rot + pos) -> [..., 3, 4] pose matrices."""
    rot = rotation_6d_to_matrix(poses_9d[..., :6])
    return torch.cat([rot, poses_9d[..., 6:9, None]], dim=-1)
