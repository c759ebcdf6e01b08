"""Weighted accumulation along rays (port of the JAX package's model_components/renderers.py)."""

from __future__ import annotations

import torch

from reference.nrref.cameras.rays import RaySamples


def render_depth_simple(weights: torch.Tensor, ray_samples: RaySamples) -> torch.Tensor:
    """Unnormalized expected depth: weights [R, S, 1] -> [R, 1]."""
    steps = (ray_samples.frustums.starts + ray_samples.frustums.ends) / 2.0
    return torch.sum(weights * steps, dim=-2)
