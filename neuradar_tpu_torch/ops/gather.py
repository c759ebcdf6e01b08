"""Row gather (kernel P1): out[i, :] = table[idx[i], :].

The JAX package's tools/probe_mosaic_gather.py asked which Pallas forms of
this gather lower on a TPU; the port keeps the function as a kernel and a
microbenchmark (``scripts/probe_gather.py``), since a hash-grid encode is one
such random row read per corner. On CUDA tensors ``row_gather`` launches the
hand-written kernel in ``csrc/gather.cu``; on CPU tensors it runs the plain
version ``row_gather_reference``. Out-of-range indices raise on both.
"""

from __future__ import annotations

import torch

from neuradar_tpu_torch.ops import build


def row_gather_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch P1."""
    return table[idx.long()]


def _check_bounds(idx: torch.Tensor, rows: int) -> None:
    if idx.numel() == 0:
        return
    lo, hi = torch.aminmax(idx)
    lo, hi = torch.stack([lo, hi]).tolist()  # one host sync on a card
    if lo < 0 or hi >= rows:
        raise IndexError(f"row_gather: indices span [{lo}, {hi}], the table has {rows} rows")


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [T, F] float32, idx [N] int32 -> [N, F]."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"row_gather: table {tuple(table.shape)}, idx {tuple(idx.shape)}")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"row_gather takes a float32 table and int32 indices, got {table.dtype}, {idx.dtype}")
    _check_bounds(idx, table.shape[0])
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return row_gather_reference(table, idx)
    return _launch(table, idx)


def _launch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel alone, on indices already checked."""
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError(f"row_gather: table on {table.device}, idx on {idx.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather takes contiguous tensors")
    N, F = idx.shape[0], table.shape[1]
    lib = build.load()
    out = torch.empty((N, F), dtype=table.dtype, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    build.check(lib.row_gather(table.data_ptr(), idx.data_ptr(), out.data_ptr(), N, F, stream), "row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0
