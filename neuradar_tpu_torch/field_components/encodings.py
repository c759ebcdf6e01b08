"""Hash-grid and spherical-harmonics encodings (port of the JAX package's
field_components/encodings.py: ``HashEncoding`` forward and ``SHEncoding``).

``hash_encode`` is the plain PyTorch formulation of the JAX package's
combined corner gather (``_gather_corner_features`` / ``_hash_encode_fwd``),
written as a loop over the 2^d cell corners so that no [N, 2^d * L * F]
index tensor is materialized. The JAX package runs it as XLA, not Pallas; in
this port it is the plain path, and the encode on the card is a kernel
(``ops/hash_encode.py``).

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

On CUDA tensors of a templated grid (d 3 or 4, F 1, 2 or 4, a float32 or bf16 table) an encode is
one hand-written op, ``ops/hash_encode.hash_encode`` (K4, ``csrc/hash_encode.cu``): one launch
forward, bit-equal to the formulation here, with the level scalings rounded to the compute type once on
the host (``HashEncoding.host_scalings``), so no encode copies them to the card; one launch a group of
levels backward, inside the span ``hash_encode/scatter``, which recomputes the corners from the
positions and adds the tables' gradient and, where needed, the positions'. The counters
``hash_encode_kernel`` and ``hash_encode_plain`` count the encodes that took the kernel and the plain
path. The kernel covers every preset's grid and refuses any other encode on the card (there is no
fallback there). Every encode on the CPU is the plain path below: with gradients on and a table that
needs one, the 2^d corners' ``table[idx]`` go through one ``_CornerGather`` an
encode, whose backward adds every corner's gradient into the table's as autograd would for separate
gathers (``ops/hash_scatter.hash_scatter_reference``, bit for bit), inside ``hash_encode/scatter``;
the corner weights, their float32 sum and the positions' gradient stay with autograd. Without
gradients each corner is a plain ``table[idx]``, its index freed before the next corner's is made.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from neuradar_tpu_torch.ops import hash_encode as hash_encode_op
from neuradar_tpu_torch.ops.hash_scatter import hash_scatter_reference
from neuradar_tpu_torch.utils import trace

# Instant-NGP / tcnn primes; the fourth hashes the actor index of the 4-D grid
_HASH_PRIMES = (1, 2654435761, 805459861, 3674653429)


class _CornerGather(torch.autograd.Function):
    """Each corner's ``table[idx]``; the backward scatters all their gradients into the table's
    inside the span ``hash_encode/scatter``."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, *idxs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        ctx.save_for_backward(*idxs)
        ctx.table_shape = table.shape
        return tuple(table[idx] for idx in idxs)

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        with trace.span("hash_encode/scatter", device=grads[0].is_cuda):
            grad_table = hash_scatter_reference(grads, ctx.saved_tensors, ctx.table_shape)
        return (grad_table, *(None for _ in grads))


def _gather_corners(table: torch.Tensor, idxs: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Every corner's ``table[idx]`` of one encode, through ``_CornerGather``."""
    return _CornerGather.apply(table, *idxs)


def _cells(positions: torch.Tensor, scalings: Sequence[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each point's cell at each level: its corner's integer coordinates [N, L, d] (int64) and its
    offsets in the positions' dtype."""
    with trace.host_sync("hash_scalings"):
        scal = torch.tensor(scalings, dtype=positions.dtype, device=positions.device)
    scaled = positions[:, None, :] * scal[:, None]  # [N, L, d]
    floored = torch.floor(scaled)
    offset = scaled - floored
    return floored.long(), offset


def _corner_index(base: torch.Tensor, corner: int, table_size: int, level_offsets: torch.Tensor) -> torch.Tensor:
    """The corner's row of the [L * T, F] table [N, L]."""
    idx = (base[..., 0] + (corner & 1)) * _HASH_PRIMES[0]
    for i in range(1, base.shape[-1]):
        idx = idx ^ ((base[..., i] + ((corner >> i) & 1)) * _HASH_PRIMES[i])
    return (idx & (table_size - 1)) + level_offsets


def _corner_weight(offset: torch.Tensor, corner: int) -> torch.Tensor:
    """The corner's trilinear (quadrilinear) weight [N, L]: its factors multiplied in axis order."""
    w = None
    for i in range(offset.shape[-1]):
        wi = offset[..., i] if (corner >> i) & 1 else 1 - offset[..., i]
        w = wi if w is None else w * wi
    return w


def corner_rows(positions: torch.Tensor, scalings: Sequence[float], table_size: int,
                num_levels: int) -> list:
    """Every corner's (rows [N, L], weights [N, L]) of the plain path, for positions [N, d] in the
    compute type: the corner gradients of the table are ``grad [N, L, F] * weight[..., None]`` in it."""
    base, offset = _cells(positions, scalings)
    level_offsets = torch.arange(num_levels, device=positions.device) * table_size
    return [(_corner_index(base, c, table_size, level_offsets), _corner_weight(offset, c))
            for c in range(2**positions.shape[1])]


def positions_grad_float64(positions: torch.Tensor, table_flat: torch.Tensor, scalings: Sequence[float],
                           table_size: int, num_levels: int, grad_out: torch.Tensor) -> torch.Tensor:
    """The positions' gradient [N, d] of the encode of ``positions`` [N, d] (in the compute type R) through
    ``table_flat`` (in R) for ``grad_out`` [N, L * F], evaluated in float64 from the cells and offsets as
    the plain path rounds them in R: per level and axis i, the level's scaling (rounded to R) times the sum
    over corners of (grad . row) * (+1 or -1) * the product of the other axes' factors (offset or
    1 - offset), summed over levels. The reference the kernel's and plain autograd's gradients are held to."""
    N, d = positions.shape
    L, T = num_levels, table_size
    base, offset = _cells(positions, scalings)
    o, r = offset.double(), (1 - offset).double()
    table = table_flat.double().view(L * T, -1)
    level_offsets = torch.arange(L, device=positions.device) * T
    g = grad_out.double().reshape(N, L, -1)
    q = torch.zeros((N, L, d), dtype=torch.float64, device=positions.device)
    for c in range(2**d):
        dot = (table[_corner_index(base, c, T, level_offsets)] * g).sum(-1)  # [N, L]
        for i in range(d):
            t = dot
            for j in range(d):
                if j != i:
                    t = t * (o[..., j] if (c >> j) & 1 else r[..., j])
            q[..., i] += t if (c >> i) & 1 else -t
    scal = torch.tensor(scalings, dtype=positions.dtype, device=positions.device).double()
    return (q * scal[:, None]).sum(1)


def hash_encode(positions: torch.Tensor, table_flat: torch.Tensor, scalings: Sequence[float], table_size: int,
                num_levels: int, features_per_level: int) -> torch.Tensor:
    """Multiresolution hash encoding, the plain formulation: positions [N, d] in [0, 1] -> [N, L * F]."""
    N, d = positions.shape
    L, F = num_levels, features_per_level
    base, offset = _cells(positions, scalings)
    level_offsets = torch.arange(L, device=positions.device) * table_size
    table = table_flat.view(L * table_size, F)

    corners = range(2**d)
    if torch.is_grad_enabled() and table.requires_grad:
        feats = list(_gather_corners(table, [_corner_index(base, c, table_size, level_offsets) for c in corners]))
    else:
        feats = None
    out = None
    for corner in corners:
        if feats is None:
            feat = table[_corner_index(base, corner, table_size, level_offsets)]
        else:
            feat, feats[corner] = feats[corner], None
        term = (feat * _corner_weight(offset, corner)[..., None]).float()  # [N, L, F]
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
        self._host_scalings: Dict[torch.dtype, Tuple[float, ...]] = {}

    def get_out_dim(self) -> int:
        return self.num_levels * self.features_per_level

    def host_scalings(self, dtype: torch.dtype) -> Tuple[float, ...]:
        """The level scalings rounded to ``dtype`` on the host, once a dtype: the kernel's launch
        arguments."""
        if dtype not in self._host_scalings:
            self._host_scalings[dtype] = hash_encode_op.host_scalings(self.scalings, dtype)
        return self._host_scalings[dtype]

    def forward(self, positions: torch.Tensor, tables: Optional[Dict[nn.Module, torch.Tensor]] = None) -> torch.Tensor:
        """[..., d] in [0, 1] -> [..., L * F] in the positions' dtype; ``tables`` may hold this
        encoder's table, cast once by ``cast_hash_tables``."""
        if positions.shape[-1] != self.n_input_dims:
            raise ValueError(f"expected {self.n_input_dims}-D input, got {tuple(positions.shape)}")
        batch_shape = positions.shape[:-1]
        table = tables.get(self, self.hash_table) if tables else self.hash_table
        pos_dtype = positions.dtype
        L, F = self.num_levels, self.features_per_level
        if self.compute_dtype is not None:
            table = table.to(self.compute_dtype)
        if positions.is_cuda:
            if self.compute_dtype is None and pos_dtype != table.dtype:
                # the kernel computes in the table's dtype; the plain path here would in the promoted one
                raise TypeError(f"without a compute dtype the encode needs positions in the table's dtype "
                                f"{table.dtype}, got {pos_dtype}")
            with trace.span("hash_encode"):
                trace.count("hash_encode_kernel")
                out = hash_encode_op.hash_encode(positions.reshape(-1, self.n_input_dims), table,
                                                 self.host_scalings(table.dtype), self.table_size, L, F)
            return out.reshape(*batch_shape, self.get_out_dim())
        if self.compute_dtype is not None:
            positions = positions.to(self.compute_dtype)
        with trace.span("hash_encode"):
            trace.count("hash_encode_plain")
            out = hash_encode(positions.reshape(-1, self.n_input_dims), table, self.scalings,
                              self.table_size, L, F)
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
