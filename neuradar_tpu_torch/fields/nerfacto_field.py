"""Nerfacto's field and its proposal density field (port of the JAX package's
fields/nerfacto_field.py, the camera model).

``NerfactoField``: the contracted sample centre -> hash grid -> density MLP (density and a
geometry feature) -> with the SH-encoded unit direction and the frame's appearance embedding,
the colour MLP -> rgb. ``HashMLPDensityField``: hash grid -> small MLP (or one linear layer) ->
density, the proposal rounds' field. Both take their grids in float32; on CUDA tensors the encode
is K4 (``field_components/encodings.HashEncoding``). Module names follow the flax tree.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from neuradar_tpu_torch.cameras.rays import RaySamples
from neuradar_tpu_torch.field_components.encodings import HashEncoding, SHEncoding
from neuradar_tpu_torch.field_components.mlp import MLP
from neuradar_tpu_torch.field_components.spatial_distortions import contract_points
from neuradar_tpu_torch.fields.neurad_field import trunc_exp


class NerfactoField(nn.Module):
    def __init__(self, static_scale: float, num_embeds: int = 1, num_layers: int = 2, hidden_dim: int = 64,
                 geo_feat_dim: int = 15, num_levels: int = 16, base_res: int = 16, max_res: int = 2048,
                 log2_hashmap_size: int = 19, features_per_level: int = 2, num_layers_color: int = 3,
                 hidden_dim_color: int = 64, appearance_embedding_dim: int = 32):
        super().__init__()
        self.static_scale = static_scale
        self.grid = HashEncoding(num_levels=num_levels, min_res=base_res, max_res=max_res,
                                 log2_hashmap_size=log2_hashmap_size, features_per_level=features_per_level)
        self.mlp_base = MLP(self.grid.get_out_dim(), 1 + geo_feat_dim, num_layers, hidden_dim)
        self.direction_encoding = SHEncoding(levels=4)
        self.appearance_embedding_dim = appearance_embedding_dim
        head_in = self.direction_encoding.get_out_dim() + geo_feat_dim + appearance_embedding_dim
        self.mlp_head = MLP(head_in, 3, num_layers_color, hidden_dim_color)
        if appearance_embedding_dim > 0:
            self.appearance = nn.Embedding(num_embeds, appearance_embedding_dim)

    def forward(self, ray_samples: RaySamples, camera_indices: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """{'density' [R, S, 1], 'rgb' [R, S, 3]}; ``camera_indices`` [R] or [R, 1] pick the
        appearance embedding (frame 0 when None)."""
        positions = ray_samples.frustums.get_positions()
        R, S = positions.shape[:2]
        h = self.mlp_base(self.grid(contract_points(positions, self.static_scale)))
        density = trunc_exp(h[..., :1])
        dirs = ray_samples.frustums.directions[:, None, :].expand(positions.shape)
        head_in = [self.direction_encoding(dirs), h[..., 1:]]  # raw unit directions, as neurad_field
        if self.appearance_embedding_dim > 0:
            idx = (camera_indices.reshape(R) if camera_indices is not None
                   else torch.zeros(R, dtype=torch.long, device=positions.device))
            emb = self.appearance(idx.long())
            head_in.append(emb[:, None, :].expand(R, S, emb.shape[-1]))
        out = self.mlp_head(torch.cat(head_in, dim=-1))
        return {"density": density, "rgb": torch.sigmoid(out[..., :3])}


class HashMLPDensityField(nn.Module):
    """A proposal round's density: trunc_exp of the decoded hash encoding, [R, S, 1]."""

    def __init__(self, static_scale: float, num_levels: int = 5, max_res: int = 256, base_res: int = 16,
                 log2_hashmap_size: int = 17, features_per_level: int = 2, hidden_dim: int = 16,
                 use_linear: bool = False):
        super().__init__()
        self.static_scale = static_scale
        self.grid = HashEncoding(num_levels=num_levels, min_res=base_res, max_res=max_res,
                                 log2_hashmap_size=log2_hashmap_size, features_per_level=features_per_level)
        self.decoder = (nn.Linear(self.grid.get_out_dim(), 1) if use_linear
                        else MLP(self.grid.get_out_dim(), 1, num_layers=2, layer_width=hidden_dim))

    def forward(self, ray_samples: RaySamples) -> torch.Tensor:
        return trunc_exp(self.decoder(self.grid(contract_points(ray_samples.frustums.get_positions(),
                                                                self.static_scale))))
