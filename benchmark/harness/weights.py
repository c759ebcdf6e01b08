"""The weights of a run, made on the device from the seed by the benchmark and written into the
port's model and the reference's alike.

Both models have the same parameter tree (the reference is a copy of the port's modules), and
``fill_weights`` walks it in ``state_dict`` order with one ``torch.Generator`` on the model's device:
each hash table and each leaf of a million elements or more is drawn in place by one call, the
small random leaves by one call together. The distributions are the port's (``utils/params.py``):
lecun-normal dense, convolution and transposed-convolution kernels (he-normal for the VGG trunk),
normal embeddings of std dim^-1/2 (untruncated here), zero biases, unit norm scales, running
statistics at (0, 1). The hash tables are U(-1, 1) times the configuration file's
``weights.hash_table_scale``: the port initializes them at 1e-3, where every render is one flat
colour; a trained scene's tables are larger, and so are the benchmark's. The actor trajectories and the density
steepness keep the values their modules were built with from the scene and the configuration.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn

_LARGE = 1 << 20
# leaves whose modules set them from the scene or the configuration
_KEPT = {"DynamicActors", "SigmoidDensity"}


def _rule(module: nn.Module, attr: str, path: str, t: torch.Tensor, table_scale: float) -> Tuple[str, float]:
    """("normal", std), ("uniform", half width), ("const", value) or ("keep", 0)."""
    kind = type(module).__name__
    if kind in _KEPT:
        return "keep", 0.0
    if kind == "HashEncoding" and attr == "hash_table":
        return "uniform", table_scale
    if attr == "bias" or attr in ("running_mean", "num_batches_tracked"):
        return "const", 0.0
    if kind in ("BatchNorm", "BatchNorm2d", "LayerNorm") or attr == "running_var":
        return "const", 1.0
    if kind == "Linear":
        return "normal", 1.0 / math.sqrt(module.in_features)
    if kind == "Conv2d":
        fan_in = t[0].numel()
        return "normal", math.sqrt((2.0 if "vgg" in path else 1.0) / fan_in)
    if kind == "ConvTranspose2d":
        return "normal", 1.0 / math.sqrt(t[:, 0].numel())
    if kind == "Embedding":
        return "normal", 1.0 / math.sqrt(t.shape[1])
    raise TypeError(f"{path}: no weight rule for {kind}.{attr}")


@torch.no_grad()
def fill_weights(model: nn.Module, seed: int, table_scale: float) -> List[str]:
    """Overwrite every random leaf of ``model`` from ``seed``, the hash tables U(-1, 1) *
    ``table_scale``; returns the leaf names in the order they were drawn (the same list on both
    sides, or the two models differ)."""
    modules = dict(model.named_modules())
    leaves = model.state_dict(keep_vars=True)
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(seed))
    small: List[Tuple[torch.Tensor, float]] = []
    order = []
    for path, t in leaves.items():
        owner, _, attr = path.rpartition(".")
        kind, scale = _rule(modules[owner], attr, path, t, table_scale)
        if kind == "keep":
            continue
        order.append(path)
        if kind == "const":
            t.data.fill_(scale)
        elif kind == "uniform":
            t.data.uniform_(-scale, scale, generator=gen)
        elif t.numel() >= _LARGE:
            t.data.normal_(0.0, scale, generator=gen)
        else:
            small.append((t, scale))
    if small:
        buf = torch.randn(sum(t.numel() for t, _ in small), generator=gen, device=device)
        at = 0
        for t, std in small:
            n = t.numel()
            t.data.copy_(buf[at:at + n].view_as(t) * std)
            at += n
    return order
