"""FID machinery and the LPIPS-style perceptual distance on the VGG-19 trunk (port of the JAX
package's model_components/fid.py: ``FeatureExtractor``, ``PerceptualDistance`` and
``frechet_distance``).

The reference computes FID with torchmetrics' InceptionV3; no pretrained Inception is at hand, so the
features come from the VGG-19 trunk of the perceptual loss, pooled over H and W. Without
$NEURADAR_VGG19_WEIGHTS the trunk has seeded random filters and both metrics are surrogates:
consistent within a run, comparable neither with published values nor with the JAX package's
surrogates (whose random filters come from another generator).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from neuradar_tpu_torch.model_components.vgg import Vgg19Features

Image = Union[np.ndarray, torch.Tensor]


class FeatureExtractor:
    """Pooled deep features for FID: the trunk's last map (relu5_1) averaged over H and W."""

    def __init__(self, device: Union[str, torch.device] = "cpu"):
        self.device = torch.device(device)
        self.module = Vgg19Features().to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def __call__(self, images: Image, batch: int = 8) -> np.ndarray:
        """images [N, H, W, 3] in [0, 1] -> [N, 512] float32 features, ``batch`` images a pass."""
        if len(images) == 0:
            raise ValueError("FeatureExtractor needs at least one image (empty eval split?)")
        feats = []
        for i in range(0, len(images), batch):
            chunk = torch.as_tensor(images[i : i + batch], dtype=torch.float32, device=self.device)
            feats.append(self.module(chunk)[-1].mean(dim=(2, 3)).cpu().numpy())
        return np.concatenate(feats)


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


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians fit to feature sets."""
    from scipy import linalg

    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    cov_a = np.cov(feats_a, rowvar=False) + eps * np.eye(feats_a.shape[1])
    cov_b = np.cov(feats_b, rowvar=False) + eps * np.eye(feats_b.shape[1])
    covmean = linalg.sqrtm(cov_a @ cov_b)  # the JAX package's disp=False, which SciPy 1.18 drops, gives the same
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    diff = mu_a - mu_b
    return float(diff @ diff + np.trace(cov_a) + np.trace(cov_b) - 2 * np.trace(covmean))
