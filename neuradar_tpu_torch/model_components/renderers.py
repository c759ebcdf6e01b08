"""Weighted accumulation along rays (port of the JAX package's model_components/renderers.py: depth
and the colour over a background)."""

from __future__ import annotations

import torch

from neuradar_tpu_torch.cameras.rays import RaySamples


def render_depth_simple(weights: torch.Tensor, ray_samples: RaySamples) -> torch.Tensor:
    """Unnormalized expected depth: weights [R, S, 1] -> [R, 1]."""
    steps = (ray_samples.frustums.starts + ray_samples.frustums.ends) / 2.0
    return torch.sum(weights * steps, dim=-2)



def render_depth_expected(weights: torch.Tensor, ray_samples: RaySamples, eps: float = 1e-10) -> torch.Tensor:
    """Accumulation-normalized expected depth [R, 1], clipped to the samples' range."""
    steps = (ray_samples.frustums.starts + ray_samples.frustums.ends) / 2.0
    depth = torch.sum(weights * steps, dim=-2) / (torch.sum(weights, dim=-2) + eps)
    return torch.clamp(depth, torch.amin(steps, dim=-2), torch.amax(steps, dim=-2))


def render_rgb_last_sample(rgb: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted colour [R, 3] over the last sample's colour as background (nerfacto's background
    "last_sample"), clipped to [0, 1]."""
    comp = torch.sum(weights * rgb, dim=-2) + rgb[..., -1, :] * (1.0 - torch.sum(weights, dim=-2))
    return torch.clamp(comp, 0.0, 1.0)
