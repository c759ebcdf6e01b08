"""NeuRAD scene encoding: static world hash grid + 4-D actor hash grid
(port of the JAX package's field_components/neurad_encoding.py).

A sample inside an actor's padded box reads the actor grid at its box-frame
position, with the normalized actor index as the 4th coordinate; every other
sample reads the static grid. Grid features are down-weighted where the cell
is smaller than the sample blob. ``compute_dtype`` goes to both hash grids
(the JAX package's counterpart, ``neurad_encoding.py:104-130``), and
``tables`` (``encodings.cast_hash_tables``) hands them tables cast once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neuradar_tpu_torch.field_components.encodings import HashEncoding
from neuradar_tpu_torch.field_components.spatial_distortions import ScaledSceneContraction
from neuradar_tpu_torch.model_components.dynamic_actors import (
    ActorCandidates,
    assign_samples_to_actors,
    gather_selected_w2b_components,
)
from neuradar_tpu_torch.utils import trace
from neuradar_tpu_torch.utils.math import GaussiansStd

EPS = 1.0e-7


@dataclass
class StaticSettings:
    hashgrid_dim: int = 4
    num_levels: int = 8
    base_res: int = 32
    max_res: int = 8192
    log2_hashmap_size: int = 22


@dataclass
class ActorSettings:
    flip_prob: float = 0.5
    actor_scale: float = 10.0
    hashgrid_dim: int = 4
    num_levels: int = 4
    base_res: int = 64
    max_res: int = 1024
    log2_hashmap_size: int = 17


@dataclass
class NeuRADHashEncodingConfig:
    static: StaticSettings = field(default_factory=StaticSettings)
    actor: ActorSettings = field(default_factory=ActorSettings)
    require_actor_grad: bool = True
    """False: no gradient reaches the actor trajectories through this grid."""


def _rescale_grid_features(grid_feats: torch.Tensor, std: torch.Tensor, scalings: Sequence[float],
                           num_levels: int, features_per_level: int) -> torch.Tensor:
    """grid_feats [..., L*F] * 1 / max(scaling_l * 2 * std, 1) per level."""
    feats = grid_feats.reshape(*grid_feats.shape[:-1], num_levels, features_per_level)
    with trace.host_sync("feature_scalings"):
        scal = torch.tensor(scalings, dtype=std.dtype, device=std.device)
    weights = 1.0 / torch.clamp(scal * 2 * std, min=1.0)  # [..., L]
    return (feats * weights[..., None]).reshape(*grid_feats.shape[:-1], num_levels * features_per_level)


class NeuRADHashEncoding(nn.Module):
    def __init__(self, config: NeuRADHashEncodingConfig, static_scale: float, n_actors: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        self.n_actors = n_actors
        self.static_contraction = ScaledSceneContraction(scale=static_scale)
        self.actor_contraction = ScaledSceneContraction(scale=config.actor.actor_scale)
        s, a = config.static, config.actor
        self.static_grid = HashEncoding(
            num_levels=s.num_levels, min_res=s.base_res, max_res=s.max_res, log2_hashmap_size=s.log2_hashmap_size,
            features_per_level=s.hashgrid_dim, n_input_dims=3, compute_dtype=compute_dtype,
        )
        if self.has_actors:
            self.actor_grid = HashEncoding(
                num_levels=a.num_levels, min_res=a.base_res, max_res=a.max_res,
                log2_hashmap_size=a.log2_hashmap_size, features_per_level=a.hashgrid_dim, n_input_dims=4,
                compute_dtype=compute_dtype,
            )

    @property
    def has_actors(self) -> bool:
        return self.n_actors > 0

    def get_out_dim(self) -> int:
        return self.config.static.num_levels * self.config.static.hashgrid_dim

    def forward(self, gaussians: GaussiansStd, candidates: Optional[ActorCandidates],
                directions: Optional[torch.Tensor] = None,
                tables: Optional[Dict[nn.Module, torch.Tensor]] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """gaussians: mean [R, S, 3], std [R, S, 1]; directions [R, S, 3] or None.
        Returns features [R, S, L*F] and the directions (box frame for actor samples)."""
        cfg = self.config
        mean, std = gaussians.mean, gaussians.std
        static_pos = self.static_contraction(GaussiansStd(mean=mean, std=std))
        static_feats = _rescale_grid_features(
            self.static_grid(static_pos.mean, tables), static_pos.std,
            self.static_grid.scalings, cfg.static.num_levels, cfg.static.hashgrid_dim,
        )
        if not self.has_actors or candidates is None:
            return static_feats, directions

        if not cfg.require_actor_grad:
            candidates = candidates.detach()
        sel, has_actor = assign_samples_to_actors(candidates, mean)
        w2b = gather_selected_w2b_components(candidates, sel)  # 3 x 4 list of [R, S]
        actor_id = torch.gather(candidates.actor_id, 1, sel)
        flip = candidates.flip[:, None]

        px, py, pz = mean[..., 0], mean[..., 1], mean[..., 2]
        box_x = (w2b[0][0] * px + w2b[0][1] * py + w2b[0][2] * pz + w2b[0][3]) * flip
        box_y = w2b[1][0] * px + w2b[1][1] * py + w2b[1][2] * pz + w2b[1][3]
        box_z = w2b[2][0] * px + w2b[2][1] * py + w2b[2][2] * pz + w2b[2][3]
        pos_box = torch.stack([box_x, box_y, box_z], dim=-1)

        actor_pos = self.actor_contraction(GaussiansStd(mean=pos_box, std=std))
        id4 = (actor_id.to(pos_box.dtype) / self.n_actors)[..., None]
        actor_feats = _rescale_grid_features(
            self.actor_grid(torch.cat([actor_pos.mean, id4], dim=-1), tables), actor_pos.std,
            self.actor_grid.scalings, cfg.actor.num_levels, cfg.actor.hashgrid_dim,
        )
        pad = self.get_out_dim() - actor_feats.shape[-1]
        if pad > 0:
            actor_feats = F.pad(actor_feats, (0, pad))
        features = torch.where(has_actor[..., None], actor_feats, static_feats)

        if directions is not None:
            ux, uy, uz = directions[..., 0], directions[..., 1], directions[..., 2]
            bx = (w2b[0][0] * ux + w2b[0][1] * uy + w2b[0][2] * uz) * flip
            by = w2b[1][0] * ux + w2b[1][1] * uy + w2b[1][2] * uz
            bz = w2b[2][0] * ux + w2b[2][1] * uy + w2b[2][2] * uz
            norm = torch.sqrt(bx * bx + by * by + bz * bz) + EPS
            dirs_box = torch.stack([bx / norm, by / norm, bz / norm], dim=-1)
            directions = torch.where(has_actor[..., None], dirs_box, directions)
        return features, directions
