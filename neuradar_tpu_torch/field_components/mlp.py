"""MLP (port of the JAX package's field_components/mlp.py).

``num_layers`` linear layers with relu between them, named ``hidden_{i}`` and
``output`` like the flax module, so parameter paths map one to one.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn


class MLP(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, num_layers: int = 2, layer_width: int = 32,
                 out_activation: Optional[Callable] = None):
        super().__init__()
        self.num_hidden = num_layers - 1
        width = in_dim
        for i in range(self.num_hidden):
            self.add_module(f"hidden_{i}", nn.Linear(width, layer_width))
            width = layer_width
        self.output = nn.Linear(width, out_dim)
        self.out_activation = out_activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_hidden):
            x = torch.relu(getattr(self, f"hidden_{i}")(x))
        x = self.output(x)
        if self.out_activation is not None:
            x = self.out_activation(x)
        return x
