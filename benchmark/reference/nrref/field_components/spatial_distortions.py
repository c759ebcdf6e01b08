"""Scene contraction (port of the JAX package's field_components/spatial_distortions.py).

The L-inf MipNeRF-360 contraction maps unbounded space to [-2, 2]^3 and then
linearly to [0, 1]^3; gaussian blobs get the ZipNeRF linearized std update.
"""

from __future__ import annotations

import torch

from reference.nrref.utils.math import GaussiansStd


def contract_gaussians(g: GaussiansStd) -> GaussiansStd:
    mag = torch.amax(torch.abs(g.mean), dim=-1, keepdim=True)
    mask = mag < 1
    clamped = torch.clamp(mag, min=1.0)
    mean = torch.where(mask, g.mean, (2 - 1 / clamped) * (g.mean / clamped))
    std_scaling = ((2 * clamped - 1) ** (1 / 3) / clamped) ** 2
    std = torch.where(mask, g.std, g.std * std_scaling)
    return GaussiansStd(mean=mean, std=std)


class ScaledSceneContraction:
    """Contraction of gaussians after dividing by ``scale``, normalized to [0, 1]^3."""

    def __init__(self, scale: float = 1.0):
        self.scale = scale

    def __call__(self, g: GaussiansStd) -> GaussiansStd:
        g = contract_gaussians(GaussiansStd(mean=g.mean / self.scale, std=g.std / self.scale))
        return GaussiansStd(mean=(g.mean + 2.0) / 4.0, std=g.std / 4.0)
