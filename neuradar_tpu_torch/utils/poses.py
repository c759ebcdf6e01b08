"""Pose algebra and trajectory interpolation (port of the JAX package's utils/poses.py,
the parts the render path and the camera optimizer use)."""

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


def skew_symmetric(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrices."""
    zero = torch.zeros_like(v[..., 0])
    rows = [
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


# below this squared rotation angle the exponential maps take their Taylor forms
_SMALL_ANGLE_SQ = 1e-8


def _so3_factors(log_rot: torch.Tensor, with_v: bool):
    """sin(t)/t, (1 - cos(t))/t^2 and, ``with_v``, (t - sin(t))/t^3 of t = |log_rot|, each by its
    Taylor form below _SMALL_ANGLE_SQ, as in the JAX package. The exact forms see a squared angle
    of 1 there (the guarded double ``where``), so neither branch's gradient is inf or NaN at a zero
    tangent, where the camera optimizer starts."""
    nrms = torch.sum(log_rot**2, dim=-1)
    small = nrms < _SMALL_ANGLE_SQ
    theta = torch.sqrt(torch.where(small, torch.ones_like(nrms), nrms))
    sin, cos = torch.sin(theta), torch.cos(theta)
    facs = [torch.where(small, 1.0 - nrms / 6.0, sin / theta),
            torch.where(small, 0.5 - nrms / 24.0, (1 - cos) / theta**2)]
    if with_v:
        facs.append(torch.where(small, 1.0 / 6.0 - nrms / 120.0, (theta - sin) / theta**3))
    return facs


def exp_map_SO3xR3(tangent: torch.Tensor) -> torch.Tensor:
    """SO(3) x R3 exponential map: [..., 6] (translation, log-rotation) -> [..., 3, 4]."""
    log_rot = tangent[..., 3:]
    fac1, fac2 = _so3_factors(log_rot, with_v=False)
    skews = skew_symmetric(log_rot)
    eye = torch.eye(3, dtype=tangent.dtype, device=tangent.device).expand(skews.shape)
    R = eye + fac1[..., None, None] * skews + fac2[..., None, None] * (skews @ skews)
    return torch.cat([R, tangent[..., :3, None]], dim=-1)


def exp_map_SE3(tangent: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map: [..., 6] (translation, log-rotation) -> [..., 3, 4]."""
    log_rot = tangent[..., 3:]
    fac1, fac2, fac3 = _so3_factors(log_rot, with_v=True)
    skews = skew_symmetric(log_rot)
    skews_sq = skews @ skews
    eye = torch.eye(3, dtype=tangent.dtype, device=tangent.device).expand(skews.shape)
    R = eye + fac1[..., None, None] * skews + fac2[..., None, None] * skews_sq
    V = eye + fac2[..., None, None] * skews + fac3[..., None, None] * skews_sq
    t = torch.einsum("...ij,...j->...i", V, tangent[..., :3])
    return torch.cat([R, t[..., None]], dim=-1)
