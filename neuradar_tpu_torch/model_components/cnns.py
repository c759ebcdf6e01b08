"""RGB upsampling decoder (port of the JAX package's model_components/cnns.py).

The public layout stays NHWC like the JAX package ([B, H, W, C] in,
[B, H*u, W*u, 3] out); the convolutions run in NCHW inside. Submodule names
follow the flax tree (conv_in, block1..4, up, conv_out).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.BatchNorm2d):
    """flax nn.BatchNorm on NCHW tensors. In training (``module.train()``) it normalizes with
    the batch statistics, the variance taken the fast way, E[x^2] - E[x]^2 clipped at 0 and
    biased, and updates the running statistics as flax does: r = 0.99 r + 0.01 batch (torch's
    momentum 0.01, but with the biased variance). In eval it uses the running statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.99):
        super().__init__(num_features, eps=eps)
        self.flax_momentum = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        mul = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class BasicBlock(nn.Module):
    """Residual block: 7x7 conv-bn-relu-conv-bn plus a 1x1 shortcut when the width changes."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        if in_dim != dim:
            self.res_conv = nn.Conv2d(in_dim, dim, 1)
        self.conv1 = nn.Conv2d(in_dim, dim, 7, padding=3)  # 7x7 "SAME"
        self.bn1 = BatchNorm(dim)
        self.conv2 = nn.Conv2d(dim, dim, 7, padding=3)
        self.bn2 = BatchNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.res_conv(x) if hasattr(self, "res_conv") else x
        h = torch.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return torch.relu(res + h)


class RGBDecoder(nn.Module):
    """1x1 conv -> 2 BasicBlocks(k7) -> transposed conv (x u) -> 2 BasicBlocks
    -> 1x1 conv -> sigmoid. Batch norm uses batch statistics in training, running ones in eval."""

    def __init__(self, in_dim: int, hidden_dim: int = 32, upsample_factor: int = 3):
        super().__init__()
        u = upsample_factor
        self.conv_in = nn.Conv2d(in_dim, hidden_dim, 1)
        self.block1 = BasicBlock(hidden_dim, hidden_dim)
        self.block2 = BasicBlock(hidden_dim, hidden_dim)
        # stride = kernel = u: every input pixel paints its own u x u output block
        self.up = nn.ConvTranspose2d(hidden_dim, hidden_dim, u, stride=u)
        self.block3 = BasicBlock(hidden_dim, hidden_dim)
        self.block4 = BasicBlock(hidden_dim, hidden_dim)
        self.conv_out = nn.Conv2d(hidden_dim, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.conv_in(x.permute(0, 3, 1, 2)))
        h = self.block2(self.block1(h))
        h = self.block4(self.block3(self.up(h)))
        return torch.sigmoid(self.conv_out(h)).permute(0, 2, 3, 1)
