"""Dynamic actors: rigid trajectories of moving objects (port of the JAX
package's model_components/dynamic_actors.py, without actor edits). In
training each ray may mirror the actors it sees along their x axis (the
random x-flip augmentation), drawn from the caller's generator.

Each ray keeps a fixed set of K candidate actors (point-line distance from the
actor centre below its bounding radius, nearest first); per-sample in-box
tests then pick the first candidate whose box holds the sample.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from neuradar_tpu_torch.utils import poses as pose_utils
from neuradar_tpu_torch.utils import rng as rng_utils


@dataclass
class DynamicActorsConfig:
    actor_bbox_padding: Tuple[float, float, float] = (0.25, 0.25, 0.1)
    max_actors_per_ray: int = 8


@dataclass
class ActorTrajectories:
    """Static per-scene actor data (CPU tensors)."""

    unique_timestamps: torch.Tensor  # [T]
    poses_9d: torch.Tensor  # [T, A, 9] 6d rot + position
    present: torch.Tensor  # [T, A] bool
    sizes: torch.Tensor  # [A, 3]

    @property
    def n_actors(self) -> int:
        return self.poses_9d.shape[1]


def trajectories_from_dicts(trajectories: List[dict]) -> ActorTrajectories:
    """ActorTrajectories from dataparser dicts {timestamps [N], poses [N, 4, 4]
    or [N, 3, 4], dims [3]}; a missing timestamp takes
    the actor's nearest pose."""
    if not trajectories:
        return ActorTrajectories(
            unique_timestamps=torch.zeros(1),
            poses_9d=torch.zeros((1, 0, 9)),
            present=torch.zeros((1, 0), dtype=torch.bool),
            sizes=torch.zeros((0, 3)),
        )
    all_ts = sorted({float(t) for traj in trajectories for t in np.asarray(traj["timestamps"]).reshape(-1)})
    unique_ts = np.asarray(all_ts, np.float32)
    T, A = len(unique_ts), len(trajectories)
    poses_9d = np.zeros((T, A, 9), np.float32)
    present = np.zeros((T, A), bool)
    sizes = np.zeros((A, 3), np.float32)
    for a, traj in enumerate(trajectories):
        ts = np.asarray(traj["timestamps"], np.float32).reshape(-1)
        mats = np.asarray(traj["poses"], np.float32)
        sizes[a] = np.asarray(traj["dims"], np.float32).reshape(3)
        for ti, t in enumerate(unique_ts):
            diffs = np.abs(ts - t)
            j = int(diffs.argmin())
            poses_9d[ti, a, :6] = mats[j, :2, :3].reshape(6)
            poses_9d[ti, a, 6:] = mats[j, :3, 3]
            present[ti, a] = diffs[j] < 1e-4
    return ActorTrajectories(
        unique_timestamps=torch.from_numpy(unique_ts),
        poses_9d=torch.from_numpy(poses_9d),
        present=torch.from_numpy(present),
        sizes=torch.from_numpy(sizes),
    )


@dataclass
class ActorCandidates:
    """Per-ray top-K actor candidates; ``valid`` marks real ones."""

    w2b: torch.Tensor  # [R, K, 3, 4] world -> box
    center: torch.Tensor  # [R, K, 3]
    bounds: torch.Tensor  # [R, K, 3] half-size + padding
    radius: torch.Tensor  # [R, K]
    actor_id: torch.Tensor  # [R, K] long
    valid: torch.Tensor  # [R, K] bool
    flip: torch.Tensor  # [R] +1, or -1 for a ray whose actors are mirrored (train)

    def detach(self) -> "ActorCandidates":
        return ActorCandidates(*(t.detach() for t in (self.w2b, self.center, self.bounds, self.radius,
                                                      self.actor_id, self.valid, self.flip)))

    def chunk(self, sl: slice) -> "ActorCandidates":
        return ActorCandidates(*(t[sl] for t in (self.w2b, self.center, self.bounds, self.radius,
                                                 self.actor_id, self.valid, self.flip)))


class DynamicActors(nn.Module):
    """Actor trajectories: parameters actor_positions [T, A, 3] and
    actor_rotations_6d [T, A, 6], initialized from the dataparser."""

    def __init__(self, trajectories: ActorTrajectories, config: DynamicActorsConfig = None):
        super().__init__()
        self.config = config or DynamicActorsConfig()
        self.n_actors = trajectories.n_actors
        self.actor_positions = nn.Parameter(trajectories.poses_9d[..., 6:9].clone())
        self.actor_rotations_6d = nn.Parameter(trajectories.poses_9d[..., :6].clone())
        self.register_buffer("unique_timestamps", trajectories.unique_timestamps.clone())
        self.register_buffer("present", trajectories.present.clone())
        pad = torch.tensor(self.config.actor_bbox_padding, dtype=torch.float32, device=trajectories.sizes.device)
        self.register_buffer("bounds", trajectories.sizes / 2 + pad)  # [A, 3]
        self.register_buffer("actor_to_id", torch.arange(self.n_actors))

    def get_boxes2world(self, query_times: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Boxes-to-world at query times: ([Q, A, 3, 4], valid [Q, A])."""
        poses9 = torch.cat([self.actor_rotations_6d, self.actor_positions], dim=-1)
        poses9, valid = pose_utils.interpolate_trajectories_6d(poses9, self.unique_timestamps, query_times,
                                                               self.present)
        return pose_utils.interpolate_poses_9d_to_matrices(poses9), valid

    def get_ray_candidates(self, ray_times: torch.Tensor, line_points: torch.Tensor, line_dirs: torch.Tensor,
                           flip_generator: Optional[torch.Generator] = None,
                           flip_prob: float = 0.0) -> ActorCandidates:
        """The K nearest actors per ray whose bounding sphere the ray line passes through.

        ray_times [R], line_points [R, 3] (origins), line_dirs [R, 3] (unit). With a
        generator and flip_prob > 0, each ray is x-flipped with probability flip_prob."""
        K = min(self.config.max_actors_per_ray, max(self.n_actors, 1))
        b2w, valid = self.get_boxes2world(ray_times)  # [R, A, 3, 4], [R, A]
        centers = b2w[..., :3, 3]
        radii = torch.linalg.vector_norm(self.bounds, dim=-1)  # [A]
        cross = torch.linalg.cross(centers - line_points[:, None, :], line_dirs[:, None, :].expand_as(centers), dim=-1)
        dist = torch.linalg.vector_norm(cross, dim=-1)  # [R, A]
        close = (dist < radii[None, :]) & valid
        score = torch.where(close, dist, torch.full_like(dist, float("inf")))
        # a stable ascending sort breaks ties by the lower actor index, as lax.top_k does
        k_score, k_idx = torch.sort(score, dim=1, stable=True)
        k_score, k_idx = k_score[:, :K], k_idx[:, :K]

        b2w_k = torch.gather(b2w, 1, k_idx[..., None, None].expand(-1, -1, 3, 4))
        R = ray_times.shape[0]
        if flip_generator is not None and flip_prob > 0.0:
            flip = torch.where(rng_utils.uniform(flip_generator, (R,), line_points.device) < flip_prob, -1.0, 1.0)
        else:
            flip = torch.ones(R, device=line_points.device)
        return ActorCandidates(
            w2b=pose_utils.inverse(b2w_k),
            center=b2w_k[..., :3, 3],
            bounds=self.bounds[k_idx],
            radius=radii[k_idx],
            actor_id=self.actor_to_id[k_idx],
            valid=torch.isfinite(k_score),
            flip=flip.to(line_points.dtype),
        )


def assign_samples_to_actors(candidates: ActorCandidates,
                             sample_positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample actor among the ray's candidates: the first valid candidate
    whose bounding sphere and padded box hold the sample.

    sample_positions [R, S, 3] -> (sel [R, S] long, has_actor [R, S] bool)."""
    R, S = sample_positions.shape[:2]
    K = candidates.valid.shape[1]
    px, py, pz = sample_positions[..., 0], sample_positions[..., 1], sample_positions[..., 2]
    sel = torch.zeros((R, S), dtype=torch.long, device=sample_positions.device)
    has_actor = torch.zeros((R, S), dtype=torch.bool, device=sample_positions.device)
    for k in range(K):
        dx = px - candidates.center[:, k, 0:1]
        dy = py - candidates.center[:, k, 1:2]
        dz = pz - candidates.center[:, k, 2:3]
        inside = dx * dx + dy * dy + dz * dz < candidates.radius[:, k, None] ** 2
        w2b = candidates.w2b[:, k]  # [R, 3, 4]
        for i in range(3):
            pib = w2b[:, i, 0:1] * px + w2b[:, i, 1:2] * py + w2b[:, i, 2:3] * pz + w2b[:, i, 3:4]
            inside = inside & (torch.abs(pib) < candidates.bounds[:, k, i, None])
        ok = inside & candidates.valid[:, k, None]
        sel = torch.where(ok & ~has_actor, torch.full_like(sel, k), sel)
        has_actor = has_actor | ok
    return sel, has_actor


def gather_selected_w2b_components(candidates: ActorCandidates, sel: torch.Tensor) -> list:
    """World-to-box of each sample's selected candidate as a 3 x 4 list of [R, S] tensors."""
    return [[torch.gather(candidates.w2b[:, :, i, j], 1, sel) for j in range(4)] for i in range(3)]
