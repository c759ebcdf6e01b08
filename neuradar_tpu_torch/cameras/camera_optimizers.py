"""Camera (sensor pose) optimizer (port of the JAX package's cameras/camera_optimizers.py).

A learnable [num_frames, 6] tangent per sensor frame, zero at the start, exponentiated (SO3xR3 or
SE3) and applied to the origins and directions of every ray whose ``camera_indices`` name that
frame. The scaled variant weights each degree of freedom (the *-scaleopt presets).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from neuradar_tpu_torch.cameras.rays import RayBundle
from neuradar_tpu_torch.utils.poses import exp_map_SE3, exp_map_SO3xR3


def _safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm whose gradient at exactly zero is 0 by construction (the guarded double ``where``), as
    the JAX package's: an adjustment starts at zeros, and a NaN there would poison its first step."""
    sq = torch.sum(x * x, dim=dim)
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))), torch.zeros_like(sq))


@dataclass
class CameraOptimizerConfig:
    mode: str = "off"  # off | SO3xR3 | SE3
    trans_l2_penalty: Union[Tuple[float, float, float], float] = 1e-2
    rot_l2_penalty: float = 1e-3
    weights: Optional[Tuple[float, float, float, float, float, float]] = None
    """Per-degree-of-freedom weights of the tangent (the scaled optimizer)."""


@dataclass
class ScaledCameraOptimizerConfig(CameraOptimizerConfig):
    mode: str = "SO3xR3"
    weights: Optional[Tuple[float, ...]] = (1.0, 1.0, 0.01, 0.01, 0.01, 1.0)
    trans_l2_penalty: Union[Tuple[float, float, float], float] = (1e-2, 1e-2, 1e-3)


class CameraOptimizer(nn.Module):
    """Per-frame pose refinement; ``pose_adjustment`` exists unless the mode is "off"."""

    def __init__(self, config: CameraOptimizerConfig, num_cameras: int):
        super().__init__()
        if config.mode not in ("off", "SO3xR3", "SE3"):
            raise ValueError(f"camera optimizer mode {config.mode!r}: 'off', 'SO3xR3' or 'SE3'")
        self.config = config
        if config.mode != "off":
            self.pose_adjustment = nn.Parameter(torch.zeros((num_cameras, 6)))

    def _adjustment(self) -> torch.Tensor:
        adj = self.pose_adjustment
        if self.config.weights is not None:
            adj = adj * torch.as_tensor(self.config.weights, dtype=adj.dtype, device=adj.device)
        return adj

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        """Correction matrices [N, 3, 4] for the frame indices [N]."""
        if self.config.mode == "off":
            return torch.eye(3, 4, device=indices.device).expand(indices.shape[0], 3, 4)
        tangent = self._adjustment()[indices.long()]
        return exp_map_SO3xR3(tangent) if self.config.mode == "SO3xR3" else exp_map_SE3(tangent)

    def apply_to_raybundle(self, ray_bundle: RayBundle) -> RayBundle:
        """Pose-corrected origins and directions of every ray with camera indices."""
        if self.config.mode == "off" or ray_bundle.camera_indices is None:
            return ray_bundle
        corr = self(ray_bundle.camera_indices[..., 0])
        origins = ray_bundle.origins + corr[..., :3, 3]
        directions = torch.einsum("rij,rj->ri", corr[..., :3, :3], ray_bundle.directions)
        return dataclasses.replace(ray_bundle, origins=origins, directions=directions)

    def regularization_loss(self) -> torch.Tensor:
        """Translation and rotation penalties: L2 norms a frame (or, with a per-axis translation
        penalty, the absolute components), averaged over the frames."""
        if self.config.mode == "off":
            return torch.zeros(())
        adj = self._adjustment()
        penalty = self.config.trans_l2_penalty
        if isinstance(penalty, tuple):
            trans = adj[:, :3]
            # |x| with the gradient 1 at 0, as jnp.abs's (torch.abs's is 0 there): the adjustment starts at 0
            abs_trans = torch.where(trans >= 0, trans, -trans)
            trans_term = torch.mean(abs_trans * torch.as_tensor(penalty, dtype=adj.dtype, device=adj.device))
        else:
            trans_term = torch.mean(_safe_norm(adj[:, :3])) * penalty
        rot_term = torch.mean(_safe_norm(adj[:, 3:])) * self.config.rot_l2_penalty
        return trans_term + rot_term

    @torch.no_grad()
    def metrics(self) -> Dict[str, torch.Tensor]:
        if self.config.mode == "off":
            return {}
        adj = self._adjustment()
        return {"camera_opt_translation": torch.linalg.vector_norm(adj[:, :3]),
                "camera_opt_rotation": torch.linalg.vector_norm(adj[:, 3:])}
