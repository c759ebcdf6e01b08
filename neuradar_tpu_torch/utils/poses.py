"""Pose algebra and trajectory interpolation (port of the JAX package's utils/poses.py,
the parts the render path, the camera optimizer and the render commands use)."""

from __future__ import annotations

import math
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


def to4x4(pose: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] poses -> homogeneous [..., 4, 4]."""
    bottom = torch.zeros_like(pose[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([pose, bottom], dim=-2)


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> unit quaternions [..., 4] (w, x, y, z): all four candidate
    quaternions of Shepperd's method, the one with the largest denominator picked per matrix."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    cand = torch.stack([
        torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], -1),
    ], dim=-2)  # [..., 4 candidates, 4]
    mags = torch.stack([qw2, qx2, qy2, qz2], -1)
    best = torch.argmax(mags, dim=-1, keepdim=True)  # the first of equal maxima, as jnp.argmax
    q = torch.take_along_dim(cand, best[..., None].expand(*best.shape, 4), dim=-2)[..., 0, :]
    q = q / (2.0 * torch.sqrt(torch.take_along_dim(mags, best, dim=-1).clamp(min=1e-12)))
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(min=1e-12)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternions [..., 4] (w, x, y, z), normalized first -> rotation matrices [..., 3, 3]."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def quaternion_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation of unit quaternions [..., 4] at ``t`` (a float, or [...]) along
    the short arc; a normalized linear interpolation where the two are nearly parallel."""
    q0 = q0 / torch.linalg.vector_norm(q0, dim=-1, keepdim=True).clamp(min=1e-12)
    q1 = q1 / torch.linalg.vector_norm(q1, dim=-1, keepdim=True).clamp(min=1e-12)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot).clamp(-1.0, 1.0)
    theta = torch.arccos(dot.clamp(max=1.0 - 1e-7))
    sin_theta = torch.sin(theta)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.dim() == q0.dim() - 1:
        t = t[..., None]
    w0 = torch.sin((1.0 - t) * theta) / sin_theta
    w1 = torch.sin(t * theta) / sin_theta
    out = torch.where(dot > 1.0 - 1e-6, (1.0 - t) * q0 + t * q1, w0 * q0 + w1 * q1)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp(min=1e-12)


def viewmatrix(lookat: torch.Tensor, up: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """[3, 4] pose with the columns (right, up, lookat, pos): the camera's look direction is its
    column 2 (get_spiral_path aims it at a -z target)."""

    def _norm(v):
        return v / torch.linalg.vector_norm(v).clamp(min=1e-12)

    vec2 = _norm(lookat)
    vec0 = _norm(torch.linalg.cross(_norm(up), vec2))
    vec1 = _norm(torch.linalg.cross(vec2, vec0))
    return torch.stack([vec0, vec1, vec2, pos], dim=1)


def get_spiral_path(c2w, steps: int = 30, radius: float = 0.1, rots: int = 2, zrate: float = 0.5,
                    focal: float = 100.0) -> torch.Tensor:
    """[steps, 3, 4] float32 poses on a spiral around the seed pose ``c2w`` [3, 4]: local centers
    (cos t, -sin t, -sin(t * zrate)) * radius, each looking at (0, 0, -focal), composed with the seed."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    up = c2w[:3, 2]
    target = torch.tensor([0.0, 0.0, -focal], device=c2w.device)
    thetas = torch.linspace(0.0, 2.0 * math.pi * rots, steps + 1, device=c2w.device)[:-1]
    g = to4x4(c2w)
    poses = []
    for theta in thetas:
        center = torch.stack([torch.cos(theta), -torch.sin(theta), -torch.sin(theta * zrate)]) * radius
        poses.append((g @ to4x4(viewmatrix(center - target, up, center)))[:3, :4])
    return torch.stack(poses)
