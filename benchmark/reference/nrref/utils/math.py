"""Math primitives (port of the JAX package's utils/math.py, the parts the render path uses)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass
class GaussiansStd:
    """Gaussian blobs with isotropic std: mean [..., M, 3], std [..., M, 1]."""

    mean: torch.Tensor
    std: torch.Tensor


def power_fn(x: torch.Tensor, lam: float = -1.5, max_bound: float = 1e10) -> torch.Tensor:
    """ZipNeRF power transformation (Eq. 4)."""
    if lam == 1:
        return x
    if lam == 0:
        return torch.log1p(x)
    if lam > max_bound:
        return torch.expm1(x)
    if lam < -max_bound:
        return -torch.expm1(-x)
    lam_1 = abs(lam - 1)
    return (lam_1 / lam) * ((x / lam_1 + 1) ** lam - 1)


def inv_power_fn(x: torch.Tensor, lam: float = -1.5, eps: float = 1e-10, max_bound: float = 1e10) -> torch.Tensor:
    """Inverse of :func:`power_fn`."""
    if lam == 1:
        return x
    if lam == 0:
        return torch.expm1(x)
    if lam > max_bound:
        return torch.log1p(x)
    if lam < -max_bound:
        return -torch.log(1 - x)
    lam_1 = abs(lam - 1)
    return (torch.clamp(x * lam / lam_1 + 1, min=eps) ** (1 / lam) - 1) * lam_1


def normalize_with_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize and also return the norm."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps), norm
