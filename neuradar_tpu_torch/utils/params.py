"""Parameters: the port's seeded initialization and the loader for flax trees.

``init_params`` draws every weight from the distribution the JAX package's
flax initializers use (lecun-normal kernels, zero biases, U(-1, 1) * 1e-3
hash tables, ...) with one ``torch.Generator`` on the model's device, so a
model can be built at full size without JAX.

``load_jax_params`` is the only bridge between the two packages: it takes
the flax ``params`` and ``batch_stats`` trees as nested dicts of numpy arrays
and copies them into the port's modules, whose names follow the flax tree.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from neuradar_tpu_torch.field_components.encodings import HashEncoding
from neuradar_tpu_torch.fields.neurad_field import SigmoidDensity
from neuradar_tpu_torch.model_components.radar_decoder import SetRadarDecoder
from neuradar_tpu_torch.model_components.vgg import Vgg19Features

# flax's truncated-normal variance scaling divides by the std of a standard
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=gen)


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> None:
    """Seeded initialization of every parameter and running statistic.

    DynamicActors keeps the trajectories it was built from, and a VGG-19 trunk its own filters
    (loaded or seeded, model_components/vgg.py)."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    own = {id(m) for v in model.modules() if isinstance(v, Vgg19Features) for m in v.modules()}
    for module in model.modules():
        if id(module) in own:
            continue
        if isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, module.in_features, gen)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.ConvTranspose2d):
            # flax kernel (kh, kw, in, out): fan_in = kh * kw * in
            _lecun_normal_(module.weight, module.weight[:, 0].numel(), gen)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.Conv2d):
            _lecun_normal_(module.weight, module.weight[0].numel(), gen)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.BatchNorm2d):
            module.reset_parameters()
        elif isinstance(module, nn.LayerNorm):
            module.reset_parameters()
        elif isinstance(module, nn.Embedding):
            nn.init.normal_(module.weight, std=1.0 / math.sqrt(module.embedding_dim), generator=gen)
        elif isinstance(module, HashEncoding):
            module.hash_table.uniform_(-1.0, 1.0, generator=gen).mul_(module.hash_init_scale)
        elif isinstance(module, SigmoidDensity):
            module.beta.fill_(module.init_beta)
        elif isinstance(module, SetRadarDecoder):
            module.query_embed.normal_(0.0, 1.0, generator=gen)  # flax's normal(1.0)


def _copy(dst: torch.Tensor, src: np.ndarray, where: str) -> None:
    src_t = torch.as_tensor(np.array(src), dtype=dst.dtype)
    if tuple(src_t.shape) != tuple(dst.shape):
        raise ValueError(f"{where}: flax shape {tuple(src_t.shape)} does not fit {tuple(dst.shape)}")
    dst.copy_(src_t)


def _load_layer(module: nn.Module, p: Mapping, stats: Optional[Mapping], where: str) -> None:
    if isinstance(module, nn.Linear):
        # Dense [in, out], and DenseGeneral [in, H, Dh] / [H, Dh, out] of multi-head attention (K2's
    # encoder attention and the set decoder's self- and cross-attention)
        kernel = np.asarray(p["kernel"]).reshape(module.in_features, module.out_features)
        _copy(module.weight, kernel.T, where + ".kernel")
        _copy(module.bias, np.asarray(p["bias"]).reshape(-1), where + ".bias")
    elif isinstance(module, nn.ConvTranspose2d):
        # flax ConvTranspose (transpose_kernel=False) applies the kernel unflipped; torch flips it
        _copy(module.weight, np.asarray(p["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1), where + ".kernel")
        _copy(module.bias, p["bias"], where + ".bias")
    elif isinstance(module, nn.Conv2d):
        _copy(module.weight, np.asarray(p["kernel"]).transpose(3, 2, 0, 1), where + ".kernel")  # HWIO -> OIHW
        _copy(module.bias, p["bias"], where + ".bias")
    elif isinstance(module, nn.BatchNorm2d):
        _copy(module.weight, p["scale"], where + ".scale")
        _copy(module.bias, p["bias"], where + ".bias")
        if stats is None:
            raise ValueError(f"{where}: batch norm without batch_stats")
        _copy(module.running_mean, stats["mean"], where + ".mean")
        _copy(module.running_var, stats["var"], where + ".var")
    elif isinstance(module, nn.LayerNorm):
        _copy(module.weight, p["scale"], where + ".scale")
        _copy(module.bias, p["bias"], where + ".bias")
    elif isinstance(module, nn.Embedding):
        _copy(module.weight, p["embedding"], where + ".embedding")
    else:
        raise TypeError(f"{where}: no flax mapping for {type(module).__name__}")


_LAYERS = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, nn.BatchNorm2d, nn.LayerNorm, nn.Embedding)


@torch.no_grad()
def load_jax_params(model: nn.Module, params: Mapping, batch_stats: Optional[Mapping] = None) -> None:
    """Copy flax trees (nested dicts of numpy arrays) into ``model``.

    Every leaf must land in a parameter of matching shape and every parameter
    of ``model`` must be covered, or it raises."""
    loaded = set()

    def walk(module: nn.Module, p: Mapping, stats: Optional[Mapping], where: str):
        for name, sub in p.items():
            path = f"{where}.{name}" if where else name
            if isinstance(sub, Mapping):
                child = getattr(module, name)
                child_stats = None if stats is None else stats.get(name)
                if isinstance(child, _LAYERS):
                    _load_layer(child, sub, child_stats, path)
                    loaded.update(id(t) for t in child.parameters(recurse=False))
                else:
                    walk(child, sub, child_stats, path)
            else:
                param = getattr(module, name)
                _copy(param, np.asarray(sub), path)
                loaded.add(id(param))

    walk(model, params, batch_stats, "")
    missing = [n for n, t in model.named_parameters() if id(t) not in loaded]
    if missing:
        raise ValueError(f"parameters without a flax leaf: {missing}")
