"""MLP (port of the JAX package's field_components/mlp.py).

``num_layers`` linear layers with relu between them, named ``hidden_{i}`` and
``output`` like the flax module, so parameter paths map one to one.

``compute_dtype`` (e.g. bfloat16) runs the layers in that dtype with the
float32 parameters cast per call, and returns the input's dtype, as flax's
``Dense(dtype=...)`` chain does. Such a layer rounds twice, as flax's does:
the product, then the sum with the bias (``F.linear`` with its bias would
round once), so it matches the JAX package's layer bit for bit on the CPU
(tests/test_torch_bf16.py). On the card that costs one elementwise pass per
layer.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from reference.nrref.lowp import round_fp8


class MLP(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, num_layers: int = 2, layer_width: int = 32,
                 out_activation: Optional[Callable] = None, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_hidden = num_layers - 1
        width = in_dim
        for i in range(self.num_hidden):
            self.add_module(f"hidden_{i}", nn.Linear(width, layer_width))
            width = layer_width
        self.output = nn.Linear(width, out_dim)
        self.out_activation = out_activation
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig_dtype = x.dtype
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        for i in range(self.num_hidden):
            x = torch.relu(dense(getattr(self, f"hidden_{i}"), x))
        x = dense(self.output, x)
        if self.out_activation is not None:
            x = self.out_activation(x)
        return x.to(orig_dtype)


def dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """The layer in x's dtype, its parameters cast per call: nn.Linear itself for float32, else the
    product and then the bias added, each rounded to x's dtype (flax's Dense(dtype=...))."""
    if x.dtype == torch.float32:
        return F.linear(x, layer.weight, layer.bias)
    x = round_fp8(x)
    return F.linear(x, round_fp8(layer.weight.to(x.dtype))) + layer.bias.to(x.dtype)
