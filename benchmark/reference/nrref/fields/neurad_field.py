"""NeuRAD neural feature field and its proposal variant (port of the JAX
package's fields/neurad_field.py, forward only).

hash grid -> geometry MLP (1 + D outputs) -> SH direction encoding + residual
feature MLP; the SDF becomes alpha through a learnable-steepness sigmoid
(the SDF configuration is the only one ported). ``trunc_exp`` is exp with
the JAX package's clamped gradient. ``compute_dtype`` reaches the hash grids
and the MLPs (the JAX package's ``neurad_field.py:116-135,208-224``); the
field's outputs keep the float32 of its inputs. ``tables`` hands the grids
their tables cast once (``encodings.cast_hash_tables``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch import nn

from reference.nrref.cameras.rays import RaySamples
from reference.nrref.field_components.encodings import SHEncoding
from reference.nrref.field_components.mlp import MLP
from reference.nrref.field_components.neurad_encoding import (
    ActorSettings,
    NeuRADHashEncoding,
    NeuRADHashEncodingConfig,
    StaticSettings,
)
from reference.nrref.model_components.dynamic_actors import ActorCandidates
from reference.nrref.utils.math import GaussiansStd


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp whose gradient is exp(clip(x, -15, 15))."""
    return _TruncExp.apply(x)


class SigmoidDensity(nn.Module):
    """sdf -> alpha = sigmoid(-sdf * (|beta| + beta_min))."""

    def __init__(self, init_beta: float = 20.0, beta_min: float = 1e-4):
        super().__init__()
        self.init_beta = init_beta
        self.beta_min = beta_min
        self.beta = nn.Parameter(torch.full((1,), init_beta))

    def forward(self, sdf: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(-sdf * (torch.abs(self.beta) + self.beta_min))


@dataclass
class NeuRADFieldConfig:
    grid: NeuRADHashEncodingConfig = field(
        default_factory=lambda: NeuRADHashEncodingConfig(actor=ActorSettings(flip_prob=0.25))
    )
    geo_hidden_dim: int = 32
    geo_num_layers: int = 2
    nff_hidden_dim: int = 32
    nff_num_layers: int = 3
    nff_out_dim: int = 32
    sdf_beta: float = 20.0


@dataclass
class NeuRADProposalFieldConfig:
    grid: NeuRADHashEncodingConfig = field(
        default_factory=lambda: NeuRADHashEncodingConfig(
            static=StaticSettings(log2_hashmap_size=20, num_levels=6, max_res=4096, base_res=128, hashgrid_dim=1),
            actor=ActorSettings(log2_hashmap_size=15, num_levels=4, base_res=64, max_res=1024, hashgrid_dim=1),
            require_actor_grad=False,
        )
    )
    hidden_dim: int = 16


class NeuRADField(nn.Module):
    """Main neural feature field (one isotropic multisample per frustum)."""

    def __init__(self, config: NeuRADFieldConfig, static_scale: float, n_actors: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        self.hashgrid = NeuRADHashEncoding(config.grid, static_scale, n_actors, compute_dtype)
        grid_dim = self.hashgrid.get_out_dim()
        self.mlp_geo = MLP(grid_dim, config.nff_out_dim + 1, config.geo_num_layers, config.geo_hidden_dim,
                           compute_dtype=compute_dtype)
        self.direction_encoding = SHEncoding(levels=4)
        self.mlp_feature = MLP(config.nff_out_dim + self.direction_encoding.get_out_dim(), config.nff_out_dim,
                               config.nff_num_layers, config.nff_hidden_dim, compute_dtype=compute_dtype)
        self.sdf_to_density = SigmoidDensity(init_beta=config.sdf_beta)

    def forward(self, ray_samples: RaySamples, candidates: Optional[ActorCandidates],
                tables: Optional[Dict[nn.Module, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """[R, S] samples -> 'feature' [R, S, D], 'sdf' and 'alpha' [R, S, 1]."""
        gaussians = ray_samples.frustums.get_fast_isotropic_gaussian(1)
        g = GaussiansStd(mean=gaussians.mean[..., 0, :], std=gaussians.std[..., 0, :])
        dirs = ray_samples.frustums.directions[:, None, :].expand(g.mean.shape)
        features, dirs = self.hashgrid(g, candidates, dirs, tables)

        geo = self.mlp_geo(features)
        geo_out, geo_embed = geo[..., :1], geo[..., 1:]
        dir_embed = self.direction_encoding(dirs)
        feature = geo_embed + self.mlp_feature(torch.cat([geo_embed, dir_embed], dim=-1))
        return {"feature": feature, "sdf": geo_out, "alpha": self.sdf_to_density(geo_out)}


def field_query_geometry(field: NeuRADField, positions: torch.Tensor, std: float = 0.05) -> torch.Tensor:
    """The geometry MLP's raw output (the SDF) at world positions [..., 3] -> [..., 1]: the static
    grid alone (no actor candidates), each position a Gaussian of std ``std`` (the SDF exports)."""
    g = GaussiansStd(mean=positions, std=torch.full((*positions.shape[:-1], 1), std, dtype=positions.dtype,
                                                    device=positions.device))
    feats, _ = field.hashgrid(g, None, None)
    return field.mlp_geo(feats)[..., :1]


class NeuRADProposalField(nn.Module):
    """Density-only proposal field: hash grid -> 2-layer MLP -> exp."""

    def __init__(self, config: NeuRADProposalFieldConfig, static_scale: float, n_actors: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        self.hashgrid = NeuRADHashEncoding(config.grid, static_scale, n_actors, compute_dtype)
        self.density_decoder = MLP(self.hashgrid.get_out_dim(), 1, num_layers=2, layer_width=config.hidden_dim,
                                   compute_dtype=compute_dtype)

    def forward(self, ray_samples: RaySamples, candidates: Optional[ActorCandidates],
                tables: Optional[Dict[nn.Module, torch.Tensor]] = None) -> torch.Tensor:
        gaussians = ray_samples.frustums.get_fast_isotropic_gaussian(1)
        g = GaussiansStd(mean=gaussians.mean[..., 0, :], std=gaussians.std[..., 0, :])
        features, _ = self.hashgrid(g, candidates, None, tables)
        return trunc_exp(self.density_decoder(features))  # [R, S, 1]
