"""Ray containers as dataclasses of tensors (port of the JAX package's cameras/rays.py).

A RayBundle is a flat [R, ...] set of rays; RaySamples is [R, S, ...].
Ray-level quantities stay [R, ...] and broadcast against the samples axis.
``render_weights_from_alpha`` / ``render_weights_from_density`` are the plain
formulations that kernel K1 (ops/volumetric.py) is held against.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from neuradar_tpu_torch.utils.math import GaussiansStd

replace = dataclasses.replace


@dataclass
class Frustums:
    """origins/directions [R, 3]; starts/ends [R, S, 1]; pixel_area [R, 1]."""

    origins: torch.Tensor
    directions: torch.Tensor
    starts: torch.Tensor
    ends: torch.Tensor
    pixel_area: torch.Tensor

    def get_positions(self) -> torch.Tensor:
        """Centre of each frustum: [R, S, 3]."""
        return self.origins[..., None, :] + self.directions[..., None, :] * ((self.starts + self.ends) / 2.0)

    def get_fast_isotropic_gaussian(self, num_multisamples: int = 1) -> GaussiansStd:
        """Isotropic gaussian approximation of each conical frustum:
        mean [R, S, M, 3], std [R, S, M, 1]."""
        multisample_dist = (self.ends - self.starts) / (num_multisamples + 1)  # [R, S, 1]
        ts = torch.arange(1, num_multisamples + 1, dtype=self.ends.dtype, device=self.ends.device)
        t = self.starts + ts * multisample_dist  # [R, S, M]
        mean = self.origins[..., None, None, :] + self.directions[..., None, None, :] * t[..., None]
        area = self.pixel_area[..., None, None, :] * t[..., None] ** 2
        std = (area * multisample_dist[..., None, :]) ** (1.0 / 3.0)
        return GaussiansStd(mean=mean, std=std)


@dataclass
class RaySamples:
    """Samples along rays; spacing_* live in the normalized [0, 1] domain of
    the spacing function and ``spacing_to_euclidean_fn`` maps them back."""

    frustums: Frustums
    deltas: torch.Tensor  # [R, S, 1]
    spacing_starts: Optional[torch.Tensor] = None  # [R, S, 1]
    spacing_ends: Optional[torch.Tensor] = None  # [R, S, 1]
    times: Optional[torch.Tensor] = None  # [R, 1]
    metadata: Dict[str, torch.Tensor] = field(default_factory=dict)
    spacing_to_euclidean_fn: Optional[Callable] = None

    def get_weights(self, densities: torch.Tensor) -> torch.Tensor:
        """Volume rendering weights from densities [R, S, 1] -> [R, S, 1]."""
        delta_density = self.deltas * densities
        alphas = 1 - torch.exp(-delta_density)
        transmittance = torch.cumsum(delta_density[..., :-1, :], dim=-2)
        transmittance = torch.cat([torch.zeros_like(transmittance[..., :1, :]), transmittance], dim=-2)
        transmittance = torch.exp(-transmittance)
        return torch.nan_to_num(alphas * transmittance)


def render_weights_from_alpha(alphas: torch.Tensor) -> torch.Tensor:
    """Weights from alphas [..., S] via the exclusive cumprod of (1 - alpha + 1e-7)."""
    trans = torch.cumprod(1.0 - alphas + 1e-7, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    return alphas * trans


def render_weights_from_density(t_starts: torch.Tensor, t_ends: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
    """Weights from densities on [..., S] intervals."""
    delta_density = (t_ends - t_starts) * sigmas
    alphas = 1 - torch.exp(-delta_density)
    trans = torch.exp(-torch.cat(
        [torch.zeros_like(delta_density[..., :1]), torch.cumsum(delta_density[..., :-1], dim=-1)], dim=-1
    ))
    return alphas * trans


@dataclass
class RayBundle:
    """A flat bundle of rays."""

    origins: torch.Tensor  # [R, 3]
    directions: torch.Tensor  # [R, 3]
    pixel_area: torch.Tensor  # [R, 1]
    nears: Optional[torch.Tensor] = None  # [R, 1]
    fars: Optional[torch.Tensor] = None  # [R, 1]
    times: Optional[torch.Tensor] = None  # [R, 1]
    camera_indices: Optional[torch.Tensor] = None  # [R, 1]
    metadata: Dict[str, Any] = field(default_factory=dict)

    @property
    def num_rays(self) -> int:
        return self.origins.shape[0]

    def get_ray_samples(
        self,
        bin_starts: torch.Tensor,
        bin_ends: torch.Tensor,
        spacing_starts: Optional[torch.Tensor] = None,
        spacing_ends: Optional[torch.Tensor] = None,
        spacing_to_euclidean_fn: Optional[Callable] = None,
    ) -> RaySamples:
        frustums = Frustums(
            origins=self.origins,
            directions=self.directions,
            starts=bin_starts,
            ends=bin_ends,
            pixel_area=self.pixel_area,
        )
        return RaySamples(
            frustums=frustums,
            deltas=bin_ends - bin_starts,
            spacing_starts=spacing_starts,
            spacing_ends=spacing_ends,
            spacing_to_euclidean_fn=spacing_to_euclidean_fn,
            times=self.times,
            metadata=self.metadata,
        )
