"""Hash-grid and spherical-harmonics encodings (port of the JAX package's
field_components/encodings.py: ``HashEncoding`` forward and ``SHEncoding``).

``hash_encode`` is the plain PyTorch formulation of the JAX package's
combined corner gather (``_gather_corner_features`` / ``_hash_encode_fwd``),
written as a loop over the 2^d cell corners so that no [N, 2^d * L * F]
index tensor is materialized. The JAX package runs it as XLA, not Pallas, so
it has no kernel in this port yet.

The hash matches the JAX package bit for bit: there the products are uint32
with wraparound; here they are int64, and masking with table_size - 1 keeps
only the low log2(table_size) bits, which are the same in both.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

# Instant-NGP / tcnn primes; the fourth hashes the actor index of the 4-D grid
_HASH_PRIMES = (1, 2654435761, 805459861, 3674653429)


def hash_encode(positions: torch.Tensor, table_flat: torch.Tensor, scalings: Sequence[float], table_size: int,
                num_levels: int, features_per_level: int) -> torch.Tensor:
    """Multiresolution hash encoding: positions [N, d] in [0, 1] -> [N, L * F]."""
    N, d = positions.shape
    L, F = num_levels, features_per_level
    scal = torch.tensor(scalings, dtype=positions.dtype, device=positions.device)
    scaled = positions[:, None, :] * scal[:, None]  # [N, L, d]
    floored = torch.floor(scaled)
    offset = scaled - floored
    base = floored.long()
    level_offsets = torch.arange(L, device=positions.device) * table_size
    table = table_flat.view(L * table_size, F)
    out = None
    for corner in range(2**d):
        bits = [(corner >> i) & 1 for i in range(d)]
        idx = (base[..., 0] + bits[0]) * _HASH_PRIMES[0]
        for i in range(1, d):
            idx = idx ^ ((base[..., i] + bits[i]) * _HASH_PRIMES[i])
        idx = (idx & (table_size - 1)) + level_offsets  # [N, L]
        w = None
        for i, bit in enumerate(bits):
            wi = offset[..., i] if bit else 1 - offset[..., i]
            w = wi if w is None else w * wi
        term = table[idx] * w[..., None]  # [N, L, F]
        out = term if out is None else out + term
    return out.reshape(N, L * F)


def grid_scalings(num_levels: int, min_res: int, max_res: int) -> tuple:
    """Per-level resolutions, floored in float32 exactly as the JAX package does
    (float64 would floor e.g. 63.99999 to 63 where float32 gives 64)."""
    growth = math.exp((math.log(max_res) - math.log(min_res)) / (num_levels - 1)) if num_levels > 1 else 1.0
    levels = np.arange(num_levels).astype(np.float32)
    return tuple(np.floor(np.float32(min_res) * np.power(np.float32(growth), levels)).astype(np.float32).tolist())


class HashEncoding(nn.Module):
    """Multiresolution hash grid (Instant-NGP) over 3-D or 4-D inputs; the
    table is one flat parameter [L * T * F] as in the JAX package."""

    def __init__(self, num_levels: int = 16, min_res: int = 16, max_res: int = 1024, log2_hashmap_size: int = 19,
                 features_per_level: int = 2, hash_init_scale: float = 0.001, n_input_dims: int = 3):
        super().__init__()
        self.num_levels = num_levels
        self.features_per_level = features_per_level
        self.n_input_dims = n_input_dims
        self.hash_init_scale = hash_init_scale
        self.scalings = grid_scalings(num_levels, min_res, max_res)
        self.table_size = 2**log2_hashmap_size
        n = self.table_size * num_levels * features_per_level
        self.hash_table = nn.Parameter(torch.empty(n))

    def get_out_dim(self) -> int:
        return self.num_levels * self.features_per_level

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        """[..., d] in [0, 1] -> [..., L * F]."""
        if positions.shape[-1] != self.n_input_dims:
            raise ValueError(f"expected {self.n_input_dims}-D input, got {tuple(positions.shape)}")
        batch_shape = positions.shape[:-1]
        with record_function("hash_encode"):
            out = hash_encode(positions.reshape(-1, self.n_input_dims), self.hash_table, self.scalings,
                              self.table_size, self.num_levels, self.features_per_level)
        return out.reshape(*batch_shape, self.get_out_dim())


class SHEncoding(nn.Module):
    """Spherical harmonics of unit directions, levels 1..4."""

    def __init__(self, levels: int = 4):
        super().__init__()
        self.levels = levels

    def get_out_dim(self) -> int:
        return self.levels**2

    def forward(self, directions: torch.Tensor) -> torch.Tensor:
        x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
        xx, yy, zz = x * x, y * y, z * z
        comps = [torch.full_like(x, 0.28209479177387814)]
        if self.levels > 1:
            comps += [0.4886025119029199 * y, 0.4886025119029199 * z, 0.4886025119029199 * x]
        if self.levels > 2:
            comps += [
                1.0925484305920792 * x * y,
                1.0925484305920792 * y * z,
                0.9461746957575601 * zz - 0.31539156525251999,
                1.0925484305920792 * x * z,
                0.5462742152960396 * (xx - yy),
            ]
        if self.levels > 3:
            comps += [
                0.5900435899266435 * y * (3 * xx - yy),
                2.890611442640554 * x * y * z,
                0.4570457994644658 * y * (5 * zz - 1),
                0.3731763325901154 * z * (5 * zz - 3),
                0.4570457994644658 * x * (5 * zz - 1),
                1.445305721320277 * z * (xx - yy),
                0.5900435899266435 * x * (xx - 3 * yy),
            ]
        return torch.stack(comps, dim=-1)
