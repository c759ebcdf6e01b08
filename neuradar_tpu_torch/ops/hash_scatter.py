"""The hash tables' gradient scatter (K4's backward): every corner's gradient of one hash-grid
encode added into the table's gradient.

``hash_scatter(grads, idxs, table_shape)`` takes the 2^d corners' gradients [N, L, F] (the table's
dtype) and indices [N, L] (int64 rows of the [L * T, F] table, level l's in [l * T, (l + 1) * T))
and returns the table's gradient [L * T, F]. On CUDA tensors it launches the hand-written kernel in
``csrc/hash_scatter.cu``: one launch a group of levels covers every corner, adds in float32 and
writes the gradient once, in the table's dtype. A bf16 table's levels are grouped so that the float32
accumulator holds at most ``SCRATCH_FLOATS`` values (one level of the largest grid); a float32
table accumulates in its gradient directly, in one launch. On CPU tensors it runs the plain version,
``hash_scatter_reference``: what autograd's ``IndexBackward0`` does for each corner's ``table[idx]``
(a zero table and the unchecked, accumulating ``_index_put_impl_``), with the corner tables summed
in the order autograd's engine adds them, so that the gradients are those of plain autograd bit for
bit. ``float64_sum`` gives the exact sum and the bound that any order of float32 adds and one
rounding keep to, which the card's checks hold the kernel to.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from neuradar_tpu_torch.ops import build
from neuradar_tpu_torch.utils import trace

# the float32 accumulator of a bf16 table's gradient: at most 2^24 values (64 MiB), one level of a
# 2^22-row grid of 4 features; smaller tables fit in it whole
SCRATCH_FLOATS = 1 << 24
_DTYPES = (torch.float32, torch.bfloat16)


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


def levels_per_launch(T: int, F: int, L: int, dtype: torch.dtype) -> int:
    """The levels one launch covers: all of a float32 table's; as many of a bf16 table's as the
    float32 accumulator holds, at least one."""
    return L if dtype == torch.float32 else max(1, min(L, SCRATCH_FLOATS // (T * F)))


def _check(grads, idxs, table_shape) -> Tuple[int, int, int, int]:
    if not grads or len(grads) != len(idxs) or len(grads) > 16 or len(grads) & (len(grads) - 1):
        raise ValueError(f"hash_scatter takes 2^d corners (d <= 4), got {len(grads)} gradients, {len(idxs)} indices")
    device, dtype = grads[0].device, grads[0].dtype
    if device.type != "cuda" or any(t.device != device for t in (*grads, *idxs)):
        raise ValueError(f"hash_scatter: tensors on {sorted({str(t.device) for t in (*grads, *idxs)})}")
    if dtype not in _DTYPES or any(g.dtype != dtype for g in grads) or any(i.dtype != torch.int64 for i in idxs):
        raise TypeError(f"hash_scatter takes float32 or bf16 gradients and int64 indices, got "
                        f"{sorted({str(g.dtype) for g in grads})}, {sorted({str(i.dtype) for i in idxs})}")
    N, L = idxs[0].shape
    rows, F = table_shape
    if rows % L or any(tuple(i.shape) != (N, L) for i in idxs) or any(tuple(g.shape) != (N, L, F) for g in grads):
        raise ValueError(f"hash_scatter: gradients {[tuple(g.shape) for g in grads]}, indices "
                         f"{[tuple(i.shape) for i in idxs]}, table {tuple(table_shape)}")
    return N, L, F, rows // L


def hash_scatter(grads: Sequence[torch.Tensor], idxs: Sequence[torch.Tensor],
                 table_shape: Tuple[int, int]) -> torch.Tensor:
    """The table's gradient [L * T, F] from the corners' gradients [N, L, F] and indices [N, L]."""
    if all(t.device.type == "cpu" for t in (*grads, *idxs)):
        return hash_scatter_reference(grads, idxs, table_shape)
    N, L, F, T = _check(grads, idxs, table_shape)
    grads = [g.contiguous() for g in grads]
    idxs = [i.contiguous() for i in idxs]
    dtype, device = grads[0].dtype, grads[0].device
    out = torch.empty(table_shape, dtype=dtype, device=device)
    per = levels_per_launch(T, F, L, dtype)
    bf16 = dtype == torch.bfloat16
    acc = torch.empty(per * T * F, dtype=torch.float32, device=device) if bf16 else out
    C = len(grads)
    grad_ptrs = (ctypes.c_void_p * C)(*(g.data_ptr() for g in grads))
    idx_ptrs = (ctypes.c_void_p * C)(*(i.data_ptr() for i in idxs))
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = build.load()
    for l0 in range(0, L, per):
        l1 = min(L, l0 + per)
        # bf16: the accumulator from its start, rounded into the group's rows of out; float32: out's rows
        acc_ptr = acc.data_ptr() if bf16 else out.data_ptr() + l0 * T * F * 4
        out_ptr = out.data_ptr() + l0 * T * F * 2 if bf16 else None
        code = lib.hash_scatter(grad_ptrs, idx_ptrs, C, N, L, F, T, l0, l1, int(bf16), acc_ptr, out_ptr, stream)
        build.check(code, "hash_scatter")
        hash_scatter.launches += 1
        trace.count("hash_scatter_rows", C * N * (l1 - l0))
    return out


hash_scatter.launches = 0
