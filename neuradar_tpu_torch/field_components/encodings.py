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

``compute_dtype`` (bfloat16) casts the table and the positions, as the JAX
package does: the level scalings take the positions' dtype, so the corner
indices and weights come from bf16 positions, each corner's weighted feature
is rounded to bf16, the 8 (16) corner terms are summed in float32 and the
sum rounded once (as XLA reduces them), and the output returns to the
positions' dtype. ``cast_hash_tables`` casts every table of a module tree
once (the hoisted cast); an encoder handed its cast table gathers from it,
and its own cast is then a no-op.

With gradients on and a table that needs one, each corner's ``table[idx]`` goes through
``_TableGather``, whose backward (the tables' gradient scatter) runs inside the span
``hash_encode/scatter``, timed on the card. It runs what autograd's own ``IndexBackward0`` runs:
a zero table, then the unchecked ``_index_put_impl_`` with ``accumulate``, so the kernels and the
gradients are the same. (``index_put_`` would check the indices' range with two host syncs.) The
sum of the corners' gradient tables, which autograd adds up afterwards, stays outside the span.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from neuradar_tpu_torch.utils import trace

# Instant-NGP / tcnn primes; the fourth hashes the actor index of the 4-D grid
_HASH_PRIMES = (1, 2654435761, 805459861, 3674653429)


class _TableGather(torch.autograd.Function):
    """``table[idx]`` with its backward inside the span ``hash_encode/scatter``."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        with trace.span("hash_encode/scatter", device=grad.is_cuda):
            grad_table = grad.new_zeros(ctx.table_shape)
            torch.ops.aten._index_put_impl_(grad_table, (idx,), grad, True, True)
        return grad_table, None


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and table.requires_grad:
        return _TableGather.apply(table, idx)
    return table[idx]


def hash_encode(positions: torch.Tensor, table_flat: torch.Tensor, scalings: Sequence[float], table_size: int,
                num_levels: int, features_per_level: int) -> torch.Tensor:
    """Multiresolution hash encoding: positions [N, d] in [0, 1] -> [N, L * F]."""
    N, d = positions.shape
    L, F = num_levels, features_per_level
    with trace.host_sync("hash_scalings"):
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
        term = (_gather(table, idx) * w[..., None]).float()  # [N, L, F]
        out = term if out is None else out + term
    return out.to(table_flat.dtype).reshape(N, L * F)


def grid_scalings(num_levels: int, min_res: int, max_res: int) -> tuple:
    """Per-level resolutions, floored in float32 exactly as the JAX package does
    (float64 would floor e.g. 63.99999 to 63 where float32 gives 64)."""
    growth = math.exp((math.log(max_res) - math.log(min_res)) / (num_levels - 1)) if num_levels > 1 else 1.0
    levels = np.arange(num_levels).astype(np.float32)
    return tuple(np.floor(np.float32(min_res) * np.power(np.float32(growth), levels)).astype(np.float32).tolist())


def cast_hash_tables(module: nn.Module, dtype: torch.dtype) -> Dict[nn.Module, torch.Tensor]:
    """Every ``HashEncoding`` of ``module``'s tree -> its table cast to ``dtype``, made once (e.g.
    once a training step, outside the recomputed chunks). Pass the mapping down to the encoders
    (``tables=``); the parameters themselves are left as they are. The cast is differentiable:
    the gradients of every use of a cast table add up in ``dtype`` and reach the float32 table
    once."""
    return {m: m.hash_table.to(dtype) for m in module.modules() if isinstance(m, HashEncoding)}


class HashEncoding(nn.Module):
    """Multiresolution hash grid (Instant-NGP) over 3-D or 4-D inputs; the
    table is one flat parameter [L * T * F] as in the JAX package."""

    def __init__(self, num_levels: int = 16, min_res: int = 16, max_res: int = 1024, log2_hashmap_size: int = 19,
                 features_per_level: int = 2, hash_init_scale: float = 0.001, n_input_dims: int = 3,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
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

    def forward(self, positions: torch.Tensor, tables: Optional[Dict[nn.Module, torch.Tensor]] = None) -> torch.Tensor:
        """[..., d] in [0, 1] -> [..., L * F] in the positions' dtype; ``tables`` may hold this
        encoder's table, cast once by ``cast_hash_tables``."""
        if positions.shape[-1] != self.n_input_dims:
            raise ValueError(f"expected {self.n_input_dims}-D input, got {tuple(positions.shape)}")
        batch_shape = positions.shape[:-1]
        table = tables.get(self, self.hash_table) if tables else self.hash_table
        pos_dtype = positions.dtype
        if self.compute_dtype is not None:
            table = table.to(self.compute_dtype)
            positions = positions.to(self.compute_dtype)
        with trace.span("hash_encode"):
            out = hash_encode(positions.reshape(-1, self.n_input_dims), table, self.scalings,
                              self.table_size, self.num_levels, self.features_per_level)
        return out.reshape(*batch_shape, self.get_out_dim()).to(pos_dtype)


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
