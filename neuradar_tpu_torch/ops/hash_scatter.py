"""The hash tables' gradient scatter (K4's backward), its plain version and its bound.

``hash_scatter_reference(grads, idxs, table_shape)`` takes the 2^d corners' gradients [N, L, F] (the
table's dtype) and indices [N, L] (int64 rows of the [L * T, F] table, level l's in [l * T, (l + 1) * T))
and returns the table's gradient [L * T, F]: what autograd's ``IndexBackward0`` does for each corner's
``table[idx]`` (a zero table and the unchecked, accumulating ``_index_put_impl_``), with the corner
tables summed in the order autograd's engine adds them, so that the gradients are those of plain
autograd bit for bit. The plain path of the encode (``field_components/encodings._CornerGather``) runs
it; on the card the encode's kernel (``ops/hash_encode.py``, ``csrc/hash_encode.cu``) adds the same
contributions in float32 and rounds once. ``float64_sum`` gives the exact sum and the bound that any
order of float32 adds and one rounding keep to, which the card's checks hold the kernel to.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def hash_scatter_reference(grads: Sequence[torch.Tensor], idxs: Sequence[torch.Tensor],
                           table_shape: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch: a zero table a corner, the accumulating index put into it, and the corner
    tables summed from the last corner to the first, as autograd sums 2^d gathers' gradients."""
    total = None
    for grad, idx in zip(reversed(grads), reversed(idxs)):
        table = grad.new_zeros(table_shape)
        torch.ops.aten._index_put_impl_(table, (idx,), grad, True, True)
        total = table if total is None else total + table
    return total


def float64_sum(grads: Sequence[torch.Tensor], idxs: Sequence[torch.Tensor],
                table_shape: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact sum of the contributions (float64) and, per element, the most any float32 sum of
    them can differ from it, in any order of adds, after one rounding to the gradients' dtype: an
    element of n contributions whose magnitudes sum to M errs by at most (n - 1) 2^-24 M in float32,
    plus 2^-125 an add, since the card's float32 atomics flush a subnormal input or result (under
    2^-126) to zero; a bf16 rounding of that sum errs by at most 2^-8 of it more."""
    rows, F = table_shape
    exact = torch.zeros((rows, F), dtype=torch.float64, device=grads[0].device)
    mags, counts = torch.zeros_like(exact), torch.zeros_like(exact)
    for grad, idx in zip(grads, idxs):
        flat, g64 = idx.reshape(-1), grad.double().reshape(-1, F)
        exact.index_add_(0, flat, g64)
        mags.index_add_(0, flat, g64.abs())
        counts.index_add_(0, flat, torch.ones_like(g64))
    bound = (counts - 1).clamp(min=0) * 2.0**-24 * mags + counts * 2.0**-125
    if grads[0].dtype != torch.float32:
        bound = bound + 2.0**-8 * (exact.abs() + bound)
    return exact, bound

