"""Radar decoder: a transformer encoder over a radar scan's rays, grounded in
the NeRF geometry by a sine embedding of the predicted points (port of the
JAX package's model_components/radar_decoder.py, the per-ray encoder variant).

The self-attention core is kernel K2 (ops/attention.self_attention). In
training (a generator is passed) the transformer applies dropout: inside K2
on the attention probabilities, seeded from the generator, and on the
residual and feed-forward branches (drop1, drop_ff, drop2) with masks drawn
from it. Projection and norm names follow the flax tree; LayerNorms use
flax's epsilon 1e-6.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from neuradar_tpu_torch.field_components.mlp import MLP
from neuradar_tpu_torch.ops.attention import self_attention
from neuradar_tpu_torch.utils import rng as rng_utils

_LN_EPS = 1e-6


def sine_position_embedding(xyz: torch.Tensor, num_channels: int, temperature: float = 10000.0) -> torch.Tensor:
    """Sine/cosine embedding of [N, nr, 3] coordinates -> [N, nr, num_channels]."""
    d_in = xyz.shape[-1]
    ndim = num_channels // d_in
    if ndim % 2 != 0:
        ndim -= 1
    rems = num_channels - ndim * d_in
    embeds = []
    for d in range(d_in):
        cdim = ndim
        if rems > 0:
            cdim += 2
            rems -= 2
        dim_t = torch.arange(cdim, dtype=xyz.dtype, device=xyz.device)
        dim_t = temperature ** (2 * torch.floor(dim_t / 2) / cdim)
        pos = (xyz[..., d] * (2 * math.pi))[..., None] / dim_t
        interleaved = torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])], dim=-1)
        embeds.append(interleaved.reshape(*pos.shape[:-1], -1))
    return torch.cat(embeds, dim=-1)


class FusedSelfAttention(nn.Module):
    """Multi-head self-attention whose core is kernel K2; q/k/v/out
    projections mirror flax MultiHeadDotProductAttention's DenseGenerals."""

    def __init__(self, num_heads: int = 1, qkv_features: int = 48, out_features: int = 48, in_features: int = 48):
        super().__init__()
        if qkv_features % num_heads:
            raise ValueError(f"qkv_features {qkv_features} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.query = nn.Linear(in_features, qkv_features)
        self.key = nn.Linear(in_features, qkv_features)
        self.value = nn.Linear(in_features, qkv_features)
        self.out = nn.Linear(qkv_features, out_features)

    def forward(self, inputs_q: torch.Tensor, inputs_k: torch.Tensor, inputs_v: torch.Tensor,
                dropout_rate: float = 0.0, seed: int = 0) -> torch.Tensor:
        B, S, _ = inputs_q.shape
        H = self.num_heads

        def fold(x):  # [B, S, H*Dh] -> [B*H, S, Dh]
            return x.reshape(B, S, H, -1).transpose(1, 2).reshape(B * H, S, -1).contiguous()

        out = self_attention(fold(self.query(inputs_q)), fold(self.key(inputs_k)), fold(self.value(inputs_v)),
                             seed, dropout_rate)
        return self.out(out.reshape(B, H, S, -1).transpose(1, 2).reshape(B, S, -1))


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - rate, scale kept entries by 1 / (1 - rate);
    the identity without a generator (eval) or at rate 0."""
    if generator is None or rate <= 0.0:
        return x
    keep = rng_utils.uniform(generator, x.shape, x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class TransformerEncoderLayer(nn.Module):
    """Pre-norm encoder layer; the positional embedding is added to q and k only."""

    def __init__(self, d_model: int = 48, nhead: int = 1, dim_feedforward: int = 64, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.norm1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.self_attn = FusedSelfAttention(nhead, d_model, d_model, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def forward(self, src: torch.Tensor, pos: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` turns training dropout on; draws come in flax's order (attention, drop1,
        drop_ff, drop2)."""
        rate = self.dropout if generator is not None else 0.0
        x = self.norm1(src)
        qk = x + pos
        seed = rng_utils.seed32(generator) if rate > 0.0 else 0
        src = src + dropout(self.self_attn(qk, qk, x, rate, seed), rate, generator)
        x = self.norm2(src)
        h = dropout(torch.relu(self.linear1(x)), rate, generator)
        return src + dropout(self.linear2(h), rate, generator)


class RadarTransformer(nn.Module):
    """Encoder stack with a final LayerNorm."""

    def __init__(self, d_model: int = 48, nhead: int = 1, num_layers: int = 1, dim_feedforward: int = 64,
                 dropout: float = 0.1):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout))
        self.final_norm = nn.LayerNorm(d_model, eps=_LN_EPS)

    def forward(self, src: torch.Tensor, pos: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            src = getattr(self, f"layer_{i}")(src, pos, generator)
        return self.final_norm(src)


class RadarDecoder(nn.Module):
    """Sine embedding + transformer + four heads. Output per ray:
    [existence prob, x, y, z, var_x, var_y, var_z] and the angles [2]."""

    def __init__(self, d_model: int = 48, offset_scale: float = 1.5, dropout: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.offset_scale = offset_scale
        self.transformer = RadarTransformer(d_model=d_model, dropout=dropout)
        self.offset_head = MLP(d_model, 3, num_layers=3, layer_width=16, out_activation=torch.tanh)
        self.existence_probability_head = MLP(d_model, 1, num_layers=3, layer_width=16, out_activation=torch.sigmoid)
        self.radar_uncertainty_head = MLP(d_model, 3, num_layers=3, layer_width=16, out_activation=F.softplus)
        self.radar_angle_head = MLP(d_model, 2, num_layers=3, layer_width=16, out_activation=torch.tanh)

    def forward(self, features: torch.Tensor, geometry_xyz: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """features [N, nr, C], geometry_xyz [N, nr, 3] (radar frame) ->
        radar_output [N, nr, 7], angles [N, nr, 2]. A generator means training (dropout on)."""
        pos = sine_position_embedding(geometry_xyz.detach(), self.d_model)
        decoded = self.transformer(features, pos, generator)
        xyz = geometry_xyz + self.offset_scale * self.offset_head(decoded)
        ep = self.existence_probability_head(decoded)
        unc = self.radar_uncertainty_head(decoded)
        return torch.cat([ep, xyz, unc], dim=-1), self.radar_angle_head(decoded)


def spherical_to_cartesian(depth: torch.Tensor, elevation: torch.Tensor, azimuth: torch.Tensor) -> torch.Tensor:
    """Radar-frame spherical -> cartesian."""
    x = depth * torch.cos(azimuth) * torch.cos(elevation)
    y = depth * torch.sin(azimuth) * torch.cos(elevation)
    z = depth * torch.sin(elevation)
    return torch.cat([x, y, z], dim=-1)
