"""VGG-19 feature trunk and the pix2pixHD perceptual loss (port of the JAX
package's model_components/vgg.py: ``Vgg19Features``, ``VGGPerceptualLossPix2Pix``
and ``has_pretrained_weights``).

The filters come from the .npz that $NEURADAR_VGG19_WEIGHTS points to (keys
conv{i}_kernel [kh, kw, cin, cout] and conv{i}_bias, as in the JAX package)
or, without it, from seeded random He-normal filters. Random filters come from
another generator than the JAX package's, so surrogate metrics of the two
packages are not comparable with each other.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# conv widths up to relu5_1 with 'M' for the 2 x 2 max pools (torchvision features[:30])
_VGG19_LAYOUT = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512]
# the pix2pix slices end after relu1_1, relu2_1, relu3_1, relu4_1 and relu5_1: 0-based conv 0, 2, 4, 8, 12
_SLICE_AFTER_CONV = (0, 2, 4, 8, 12)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
# flax's truncated-normal variance scaling divides by the std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _load_weights() -> Optional[dict]:
    path = os.environ.get("NEURADAR_VGG19_WEIGHTS", "")
    if path and os.path.exists(path):
        return dict(np.load(path))
    return None


def has_pretrained_weights() -> bool:
    """True when real VGG-19 weights are available; otherwise every consumer runs on random
    filters and marks its metric keys as surrogates."""
    return _load_weights() is not None


class Vgg19Features(nn.Module):
    """VGG-19 trunk: images [N, H, W, 3] in [0, 1] -> the 5 pix2pix feature maps, each [N, C, h, w]."""

    def __init__(self, seed: int = 0):
        super().__init__()
        self.convs: List[str] = []
        cin = 3
        for item in _VGG19_LAYOUT:
            if item != "M":
                name = f"conv{len(self.convs)}"
                setattr(self, name, nn.Conv2d(cin, item, 3, padding=1))
                self.convs.append(name)
                cin = item
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD).view(1, 3, 1, 1), persistent=False)
        self._init(seed)

    @torch.no_grad()
    def _init(self, seed: int) -> None:
        loaded = _load_weights()
        gen = torch.Generator().manual_seed(seed)  # on the CPU: the same filters on every device
        for name in self.convs:
            conv = getattr(self, name)
            if loaded is not None:
                conv.weight.copy_(torch.as_tensor(loaded[f"{name}_kernel"]).permute(3, 2, 0, 1))  # HWIO -> OIHW
                conv.bias.copy_(torch.as_tensor(loaded[f"{name}_bias"]))
            else:  # flax's he_normal: truncated normal, variance 2 / fan_in, drawn on the CPU
                std = math.sqrt(2.0 / conv.weight[0].numel()) / _TRUNC_STD
                w = torch.empty(conv.weight.shape, device="cpu")  # also under a `with torch.device(...)`
                nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=gen)
                conv.weight.copy_(w)
                nn.init.zeros_(conv.bias)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = (images.permute(0, 3, 1, 2) - self.mean) / self.std
        outs, i = [], 0
        for item in _VGG19_LAYOUT:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, self.convs[i])(x))
            if i in _SLICE_AFTER_CONV:
                outs.append(x)
            i += 1
        return outs


class VGGPerceptualLossPix2Pix(nn.Module):
    """Weighted L1 between the five feature maps of the prediction and of the (detached) target,
    weights 1/32, 1/16, 1/8, 1/4, 1. Gradients reach the prediction; the filters sit in the
    optimizer's "frozen" group (their path holds "vgg_loss"), as in the JAX package."""

    def __init__(self, weights: Sequence[float] = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0), seed: int = 0):
        super().__init__()
        self.weights = tuple(weights)
        self.vgg19 = Vgg19Features(seed)

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """pred, target: [B, H, W, 3] in [0, 1] -> the scalar loss."""
        feats = self.vgg19(torch.cat([pred, target.detach()], dim=0))
        loss = pred.new_zeros(())
        for w, f in zip(self.weights, feats):
            fx, fy = torch.chunk(f, 2, dim=0)
            loss = loss + w * torch.mean(torch.abs(fx - fy.detach()))
        return loss
