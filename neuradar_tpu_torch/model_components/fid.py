"""LPIPS-style perceptual distance on the VGG-19 trunk (port of ``PerceptualDistance`` of the JAX
package's model_components/fid.py; its FID feature extractor and Frechet distance wait with the FID
evals, which the port's preset never schedules).

Without $NEURADAR_VGG19_WEIGHTS the trunk has seeded random filters and the distance is a surrogate:
consistent within a run, comparable neither with published LPIPS values nor with the JAX package's
surrogate (whose random filters come from another generator).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from neuradar_tpu_torch.model_components.vgg import Vgg19Features

Image = Union[np.ndarray, torch.Tensor]


class PerceptualDistance:
    """Unit-normalized feature differences, averaged over locations and then over the 5 slices."""

    def __init__(self, device: Union[str, torch.device] = "cpu"):
        self.device = torch.device(device)
        self.module = Vgg19Features().to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def __call__(self, pred: Image, target: Image) -> float:
        """pred, target: [H, W, 3] in [0, 1]."""
        both = torch.stack([torch.as_tensor(x, dtype=torch.float32, device=self.device) for x in (pred, target)])
        feats = self.module(both)
        total = 0.0
        for f in feats:
            f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-8)
            total = total + torch.mean(torch.sum((f[0] - f[1]) ** 2, dim=0))
        return float(total / len(feats))
