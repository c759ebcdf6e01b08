"""Radar decoder: a transformer encoder over a radar scan's rays, grounded in
the NeRF geometry by a sine embedding of the predicted points (port of the
JAX package's model_components/radar_decoder.py, the per-ray encoder variant).

The self-attention core is kernel K2 (ops/attention.self_attention). In
training the transformer applies dropout: inside K2 on the attention
probabilities, seeded, and on the residual and feed-forward branches (drop1,
drop_ff, drop2). Its random draws are made for the whole batch of scans
first (``draw_noise``), so that decoding the scans in groups (``decode`` on a
``slice_noise``) drops what decoding them at once drops: K2's mask hashes
the global scan index. Projection and norm names follow the flax tree;
LayerNorms use flax's epsilon 1e-6.

``dtype`` (bfloat16) runs the transformer in that dtype, as the JAX
package's ``dtype`` does: its input and the positional embedding are cast,
the projections run in bf16 with the float32 parameters cast per call (so
K2 gets bf16 q, k, v), and each LayerNorm computes its statistics and
normalization in float32 and returns bf16 (flax's ``LayerNorm(dtype=bf16)``).
The heads and the outputs stay float32.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from neuradar_tpu_torch.field_components.mlp import MLP, dense
from neuradar_tpu_torch.ops.attention import batch_offset_seed, self_attention
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

        # the projections in the inputs' dtype (bf16 under the transformer's dtype), so K2 takes it
        q, k, v = (dense(self.query, inputs_q), dense(self.key, inputs_k), dense(self.value, inputs_v))
        out = self_attention(fold(q), fold(k), fold(v), seed, dropout_rate)
        return dense(self.out, out.reshape(B, H, S, -1).transpose(1, 2).reshape(B, S, -1))


def dropout(x: torch.Tensor, rate: float, uniforms: Optional[torch.Tensor]) -> torch.Tensor:
    """flax nn.Dropout: keep where the uniform draw is below 1 - rate, scale kept entries by
    1 / (1 - rate); the identity without draws (eval) or at rate 0."""
    if uniforms is None or rate <= 0.0:
        return x
    return torch.where(uniforms < 1.0 - rate, x / (1.0 - rate), torch.zeros_like(x))


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax's LayerNorm(dtype=x.dtype) with float32 parameters: statistics and normalization in
    float32, the result in x's dtype (for float32 x, nn.LayerNorm itself)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(x.dtype)


class TransformerEncoderLayer(nn.Module):
    """Pre-norm encoder layer; the positional embedding is added to q and k only."""

    def __init__(self, d_model: int = 48, nhead: int = 1, dim_feedforward: int = 64, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.dim_feedforward = dim_feedforward
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.self_attn = FusedSelfAttention(nhead, d_model, d_model, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def draw_noise(self, n_scans: int, n_rays: int, d_model: int, generator: torch.Generator, device) -> dict:
        """This layer's training draws for a batch of scans, in flax's order: K2's seed, then the
        uniforms of drop1, drop_ff and drop2 (none at rate 0)."""
        if self.dropout <= 0.0:
            return {"seed": 0}
        return {"seed": rng_utils.seed32(generator),
                "drop1": rng_utils.uniform(generator, (n_scans, n_rays, d_model), device),
                "drop_ff": rng_utils.uniform(generator, (n_scans, n_rays, self.dim_feedforward), device),
                "drop2": rng_utils.uniform(generator, (n_scans, n_rays, d_model), device)}

    def forward(self, src: torch.Tensor, pos: torch.Tensor, noise: Optional[dict] = None) -> torch.Tensor:
        """``noise`` (``draw_noise``) turns training dropout on."""
        if self.dtype is not None:
            src, pos = src.to(self.dtype), pos.to(self.dtype)
        rate = self.dropout if noise is not None else 0.0
        noise = noise or {}
        x = _layer_norm(self.norm1, src)
        qk = x + pos
        src = src + dropout(self.self_attn(qk, qk, x, rate, noise.get("seed", 0)), rate, noise.get("drop1"))
        x = _layer_norm(self.norm2, src)
        h = dropout(torch.relu(dense(self.linear1, x)), rate, noise.get("drop_ff"))
        return src + dropout(dense(self.linear2, h), rate, noise.get("drop2"))


class RadarTransformer(nn.Module):
    """Encoder stack with a final LayerNorm."""

    def __init__(self, d_model: int = 48, nhead: int = 1, num_layers: int = 1, dim_feedforward: int = 64,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = num_layers
        self.d_model = d_model
        self.nhead = nhead
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout, dtype))
        self.final_norm = nn.LayerNorm(d_model, eps=_LN_EPS)

    def draw_noise(self, n_scans: int, n_rays: int, generator: torch.Generator, device) -> List[dict]:
        return [getattr(self, f"layer_{i}").draw_noise(n_scans, n_rays, self.d_model, generator, device)
                for i in range(self.num_layers)]

    def forward(self, src: torch.Tensor, pos: torch.Tensor, noise: Optional[List[dict]] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            src = getattr(self, f"layer_{i}")(src, pos, noise[i] if noise is not None else None)
        return _layer_norm(self.final_norm, src)


class RadarDecoder(nn.Module):
    """Sine embedding + transformer + four heads. Output per ray:
    [existence prob, x, y, z, var_x, var_y, var_z] and the angles [2]."""

    def __init__(self, d_model: int = 48, offset_scale: float = 1.5, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_model = d_model
        self.offset_scale = offset_scale
        self.transformer = RadarTransformer(d_model=d_model, dropout=dropout, dtype=dtype)
        self.offset_head = MLP(d_model, 3, num_layers=3, layer_width=16, out_activation=torch.tanh)
        self.existence_probability_head = MLP(d_model, 1, num_layers=3, layer_width=16, out_activation=torch.sigmoid)
        self.radar_uncertainty_head = MLP(d_model, 3, num_layers=3, layer_width=16, out_activation=F.softplus)
        self.radar_angle_head = MLP(d_model, 2, num_layers=3, layer_width=16, out_activation=torch.tanh)

    def draw_noise(self, n_scans: int, n_rays: int, generator: torch.Generator, device) -> List[dict]:
        """The training draws of a batch of [n_scans, n_rays] tokens (``slice_noise`` cuts a group)."""
        return self.transformer.draw_noise(n_scans, n_rays, generator, device)

    def slice_noise(self, noise: List[dict], start: int, stop: int) -> List[dict]:
        """Scans start..stop of the batch's draws: K2's seed shifted so that its mask hashes the
        global scan index (heads fold into the batch index as scan * nhead + head)."""
        return [{"seed": batch_offset_seed(n["seed"], start * self.transformer.nhead),
                 **{k: v[start:stop] for k, v in n.items() if k != "seed"}} for n in noise]

    def forward(self, features: torch.Tensor, geometry_xyz: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """features [N, nr, C], geometry_xyz [N, nr, 3] (radar frame) ->
        radar_output [N, nr, 7], angles [N, nr, 2]. A generator means training (dropout on)."""
        noise = None
        if generator is not None:
            noise = self.draw_noise(features.shape[0], features.shape[1], generator, features.device)
        return self.decode(features, geometry_xyz, noise)

    def decode(self, features: torch.Tensor, geometry_xyz: torch.Tensor, noise: Optional[List[dict]] = None):
        """``forward`` with the training draws given (None: eval)."""
        pos = sine_position_embedding(geometry_xyz.detach(), self.d_model)
        decoded = self.transformer(features, pos, noise).float()  # the heads in float32
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
