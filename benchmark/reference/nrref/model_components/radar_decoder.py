"""Radar decoders: a transformer encoder over a radar scan's rays, grounded in the NeRF geometry
by a sine embedding of the predicted points, and either per-ray heads (``RadarDecoder``) or
DETR-style learnable queries that cross-attend to the encoded rays (``SetRadarDecoder``, the
paper's set-based alternative) (port of the JAX package's model_components/radar_decoder.py).

The encoder's self-attention core is kernel K2 (ops/attention.self_attention). The set decoder's
query self-attention and cross-attention are ``MultiHeadAttention``, plain PyTorch with flax
MultiHeadDotProductAttention's semantics, as the JAX package runs them through XLA. In training
the transformers apply dropout: inside K2 on the attention probabilities, seeded; in the set
decoder's attentions on the attention weights, one [q_len, k_len] mask per decode group and per
attention, broadcast over the scans and heads (flax's broadcast dropout, drawn once per call of
the JAX decoder, which runs once per group); and elementwise on the residual and feed-forward
branches. A decoder's random draws are made for the whole batch of scans first (``draw_noise``),
so that decoding the scans in groups (``decode`` on a ``slice_noise``) drops what decoding them
at once drops, apart from the broadcast masks, which are per group as in the JAX package: K2's
mask hashes the global scan index. Projection and norm names follow the flax tree; LayerNorms use
flax's epsilon 1e-6.

``dtype`` (bfloat16) runs the transformers in that dtype, as the JAX package's ``dtype`` does:
their inputs and the positional embeddings are cast, the projections run in bf16 with the float32
parameters cast per call (so K2 gets bf16 q, k, v), and each LayerNorm computes its statistics
and normalization in float32 and returns bf16 (flax's ``LayerNorm(dtype=bf16)``). The set
decoder's ``final_norm`` has no dtype in the JAX package, so flax promotes it to float32. The
heads and the outputs stay float32.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from reference.nrref.field_components.mlp import MLP, dense
from reference.nrref.ops.attention import batch_offset_seed, self_attention
from reference.nrref.utils import rng as rng_utils

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


def _slice_encoder_noise(noise: List[dict], start: int, stop: int, nhead: int) -> List[dict]:
    """Scans start..stop of an encoder's draws: K2's seed shifted so that its mask hashes the global
    scan index (heads fold into the batch index as scan * nhead + head)."""
    return [{"seed": batch_offset_seed(n["seed"], start * nhead),
             **{k: v[start:stop] for k, v in n.items() if k != "seed"}} for n in noise]


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

    def draw_noise(self, n_scans: int, n_rays: int, generator: torch.Generator, device,
                   n_groups: int = 1) -> List[dict]:
        """The training draws of a batch of [n_scans, n_rays] tokens (``slice_noise`` cuts a group);
        all are drawn per scan, so ``n_groups`` changes none."""
        return self.transformer.draw_noise(n_scans, n_rays, generator, device)

    def slice_noise(self, noise: List[dict], start: int, stop: int) -> List[dict]:
        """Scans start..stop of the batch's draws."""
        return _slice_encoder_noise(noise, start, stop, self.transformer.nhead)

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


class _Softmax(torch.autograd.Function):
    """jax.nn.softmax over the last axis, op by op in x's dtype, with its backward
    y * g - y * sum(y * g) (jax.nn.softmax's own derivative rule, which a bf16 gradient follows
    rounding for rounding, where autograd through exp, sum and division rounds elsewhere)."""

    @staticmethod
    def forward(ctx, x):
        e = torch.exp(x - x.amax(dim=-1, keepdim=True))
        y = e / e.sum(dim=-1, keepdim=True)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        yg = y * g
        return yg - y * yg.sum(dim=-1, keepdim=True)


class MultiHeadAttention(nn.Module):
    """flax MultiHeadDotProductAttention in plain PyTorch: DenseGeneral q/k/v/out projections (kept
    as nn.Linear, whose weights the flax [in, heads, head_dim] and [heads, head_dim, out] kernels
    fill), the query scaled by 1 / sqrt(head_dim) in the compute dtype, softmax, dropout on the
    attention weights with one [q_len, k_len] mask broadcast over the batch and the heads. It
    computes in the inputs' dtype, as flax's ``dtype`` does."""

    def __init__(self, num_heads: int = 1, qkv_features: int = 48, in_features: int = 48,
                 out_features: Optional[int] = None):
        super().__init__()
        if qkv_features % num_heads:
            raise ValueError(f"qkv_features {qkv_features} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.query = nn.Linear(in_features, qkv_features)
        self.key = nn.Linear(in_features, qkv_features)
        self.value = nn.Linear(in_features, qkv_features)
        self.out = nn.Linear(qkv_features, out_features or in_features)

    def forward(self, inputs_q: torch.Tensor, inputs_k: torch.Tensor, inputs_v: torch.Tensor,
                dropout_rate: float = 0.0, uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """inputs [B, Lq | Lk, in] -> [B, Lq, out]. ``uniforms`` [Lq, Lk] (or with leading ones) turn the
        weights' dropout on: a weight is kept where its draw is below 1 - dropout_rate."""
        B, Lq, _ = inputs_q.shape
        Lk, H = inputs_k.shape[1], self.num_heads
        q = dense(self.query, inputs_q).reshape(B, Lq, H, -1)
        k = dense(self.key, inputs_k).reshape(B, Lk, H, -1)
        v = dense(self.value, inputs_v).reshape(B, Lk, H, -1)
        dtype = q.dtype
        q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=dtype)
        weights = _Softmax.apply(torch.einsum("bqhd,bkhd->bhqk", q, k))
        if uniforms is not None and dropout_rate > 0.0:
            keep_prob = 1.0 - dropout_rate
            keep = (uniforms < keep_prob).reshape(Lq, Lk)
            weights = weights * (keep.to(dtype) / torch.tensor(keep_prob, dtype=dtype))
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return dense(self.out, out.reshape(B, Lq, -1))


class TransformerDecoderLayer(nn.Module):
    """Pre-norm DETR decoder layer: query self-attention, cross-attention to the ray memory, and
    the feed-forward block, each followed by dropout on its residual branch."""

    def __init__(self, d_model: int = 48, nhead: int = 1, dim_feedforward: int = 64, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_model = d_model
        self.dropout = dropout
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.self_attn = MultiHeadAttention(nhead, d_model, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.cross_attn = MultiHeadAttention(nhead, d_model, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def draw_noise(self, n_scans: int, n_queries: int, n_rays: int, n_groups: int, generator: torch.Generator,
                   device) -> dict:
        """This layer's training draws: the self- and cross-attention masks' uniforms, one
        [n_queries, n_queries] and one [n_queries, n_rays] per decode group, then the uniforms of
        drop1, drop2 and drop3 per scan (none at rate 0)."""
        if self.dropout <= 0.0:
            return {}
        return {"self_attn": rng_utils.uniform(generator, (n_groups, n_queries, n_queries), device),
                "cross_attn": rng_utils.uniform(generator, (n_groups, n_queries, n_rays), device),
                **{name: rng_utils.uniform(generator, (n_scans, n_queries, self.d_model), device)
                   for name in ("drop1", "drop2", "drop3")}}

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor, query_pos: torch.Tensor, mem_pos: torch.Tensor,
                noise: Optional[dict] = None) -> torch.Tensor:
        """tgt and query_pos [N, Q, d], memory and mem_pos [N, nr, d]; ``noise`` (one decode group's
        draws) turns training dropout on."""
        if self.dtype is not None:
            tgt, memory = tgt.to(self.dtype), memory.to(self.dtype)
            query_pos, mem_pos = query_pos.to(self.dtype), mem_pos.to(self.dtype)
        rate = self.dropout if noise is not None else 0.0
        noise = noise or {}
        x = _layer_norm(self.norm1, tgt)
        qk = x + query_pos
        sa = self.self_attn(qk, qk, x, rate, noise.get("self_attn"))
        tgt = tgt + dropout(sa, rate, noise.get("drop1"))
        x = _layer_norm(self.norm2, tgt)
        ca = self.cross_attn(x + query_pos, memory + mem_pos, memory, rate, noise.get("cross_attn"))
        tgt = tgt + dropout(ca, rate, noise.get("drop2"))
        x = _layer_norm(self.norm3, tgt)
        h = dense(self.linear2, torch.relu(dense(self.linear1, x)))
        return tgt + dropout(h, rate, noise.get("drop3"))


class SetRadarDecoder(nn.Module):
    """DETR-style set radar decoder: ``num_queries`` learnable queries cross-attend to the encoded
    rays of a scan, and each predicts one multi-Bernoulli component [ep, x, y, z, var_x, var_y,
    var_z] (and angles [2]) through heads shared by every decoder layer. Its encoder is
    ``RadarTransformer``, so K2 runs in it. With ``aux_loss`` the intermediate layers' predictions
    come out too, [D-1, N, Q, 7], for deep supervision."""

    def __init__(self, d_model: int = 48, num_queries: int = 300, num_decoder_layers: int = 2, nhead: int = 1,
                 dim_feedforward: int = 64, dropout: float = 0.1, position_scale: float = 100.0,
                 aux_loss: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_model = d_model
        self.num_queries = num_queries
        self.num_decoder_layers = num_decoder_layers
        self.position_scale = position_scale
        self.aux_loss = aux_loss
        self.encoder = RadarTransformer(d_model=d_model, nhead=nhead, dim_feedforward=dim_feedforward,
                                        dropout=dropout, dtype=dtype)
        self.query_embed = nn.Parameter(torch.empty(num_queries, d_model))
        nn.init.normal_(self.query_embed)
        for i in range(num_decoder_layers):
            self.add_module(f"layer_{i}", TransformerDecoderLayer(d_model, nhead, dim_feedforward, dropout, dtype))
        self.final_norm = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.point_head = MLP(d_model, 3, num_layers=3, layer_width=16, out_activation=torch.tanh)
        self.existence_probability_head = MLP(d_model, 1, num_layers=3, layer_width=16, out_activation=torch.sigmoid)
        self.radar_uncertainty_head = MLP(d_model, 3, num_layers=3, layer_width=16, out_activation=F.softplus)
        self.radar_angle_head = MLP(d_model, 2, num_layers=3, layer_width=16, out_activation=torch.tanh)

    def _layers(self) -> List[TransformerDecoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.num_decoder_layers)]

    def draw_noise(self, n_scans: int, n_rays: int, generator: torch.Generator, device,
                   n_groups: int = 1) -> dict:
        """The training draws of a batch of [n_scans, n_rays] tokens decoded in ``n_groups`` groups:
        the encoder's, then each decoder layer's (``TransformerDecoderLayer.draw_noise``)."""
        return {"encoder": self.encoder.draw_noise(n_scans, n_rays, generator, device),
                "group_scans": n_scans // n_groups,
                "layers": [layer.draw_noise(n_scans, self.num_queries, n_rays, n_groups, generator, device)
                           for layer in self._layers()]}

    def slice_noise(self, noise: dict, start: int, stop: int) -> dict:
        """Scans start..stop of the batch's draws, a whole decode group: its attention masks, and the
        per-scan draws of those scans."""
        g = noise["group_scans"]
        if stop - start != g or start % g:
            raise ValueError(f"scans {start}:{stop} are not one decode group of {g}")
        group = start // g
        layers = [{k: (v[group:group + 1] if k in ("self_attn", "cross_attn") else v[start:stop]) for k, v in n.items()}
                  for n in noise["layers"]]
        return {"encoder": _slice_encoder_noise(noise["encoder"], start, stop, self.encoder.nhead),
                "group_scans": g, "layers": layers}

    def forward(self, features: torch.Tensor, geometry_xyz: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """features [N, nr, C], geometry_xyz [N, nr, 3] (radar frame) -> radar_output [N, Q, 7],
        angles [N, Q, 2] (and with ``aux_loss`` the intermediate layers' outputs [D-1, N, Q, 7]).
        A generator means training (dropout on)."""
        noise = None
        if generator is not None:
            noise = self.draw_noise(features.shape[0], features.shape[1], generator, features.device)
        return self.decode(features, geometry_xyz, noise)

    def _predict(self, t: torch.Tensor):
        t = _layer_norm(self.final_norm, t.float())  # flax promotes the bf16 input to float32 here
        xyz = self.position_scale * self.point_head(t)
        out = torch.cat([self.existence_probability_head(t), xyz, self.radar_uncertainty_head(t)], dim=-1)
        return out, self.radar_angle_head(t)

    def decode(self, features: torch.Tensor, geometry_xyz: torch.Tensor, noise: Optional[dict] = None):
        """``forward`` with one decode group's training draws given (None: eval)."""
        N = features.shape[0]
        mem_pos = sine_position_embedding(geometry_xyz.detach(), self.d_model)
        memory = self.encoder(features, mem_pos, noise["encoder"] if noise is not None else None)
        query_pos = self.query_embed.expand(N, *self.query_embed.shape)
        tgt = torch.zeros_like(query_pos)
        intermediates = []
        for i, layer in enumerate(self._layers()):
            tgt = layer(tgt, memory, query_pos, mem_pos, noise["layers"][i] if noise is not None else None)
            intermediates.append(tgt)
        radar_output, angles = self._predict(intermediates[-1])
        if self.aux_loss and len(intermediates) > 1:
            return radar_output, angles, torch.stack([self._predict(t)[0] for t in intermediates[:-1]])
        return radar_output, angles


def spherical_to_cartesian(depth: torch.Tensor, elevation: torch.Tensor, azimuth: torch.Tensor) -> torch.Tensor:
    """Radar-frame spherical -> cartesian."""
    x = depth * torch.cos(azimuth) * torch.cos(elevation)
    y = depth * torch.sin(azimuth) * torch.cos(elevation)
    z = depth * torch.sin(elevation)
    return torch.cat([x, y, z], dim=-1)
