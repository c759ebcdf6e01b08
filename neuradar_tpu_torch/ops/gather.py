"""Row gather (kernel P1): out[i, :] = table[idx[i], :].

The JAX package's tools/probe_mosaic_gather.py asked which Pallas forms of
this gather lower on a TPU; the port keeps the function as a kernel and a
microbenchmark (``scripts/probe_gather.py``), since a hash-grid encode is one
such random row read per corner. On CUDA tensors ``row_gather`` launches the
hand-written kernel in ``csrc/gather.cu``; on CPU tensors it runs the plain
version ``row_gather_reference``. The kernel takes one of two paths, named by ``row_gather_path``
from the row width and the table's alignment alone. An out-of-range index raises ``IndexError``:
on the CPU at once; on the card at the next ``check_indices(device)``, since
the kernel checks the indices itself and flags a bad one in a device word
(its output row is zeros), so that a launch never waits on the host.
"""

from __future__ import annotations

import torch

from neuradar_tpu_torch.ops import build
from neuradar_tpu_torch.utils import trace

_flags = {}  # device -> int32 [1] flag word that the kernel sets on an index out of range


def row_gather_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch P1."""
    return table[idx.long()]


def row_gather_path(table: torch.Tensor) -> str:
    """The path csrc/gather.cu's ``row_gather`` takes for this table (it chooses it itself, from the
    same facts; the output the wrapper allocates is always 16-byte aligned): rows as float4s ("vec4")
    where F is a multiple of 4 and the table 16-byte aligned, else as floats ("scalar"). The indices
    are loaded one by one on either path, so their alignment does not matter."""
    return "vec4" if table.shape[1] % 4 == 0 and table.data_ptr() % 16 == 0 else "scalar"


def _flag(device: torch.device) -> torch.Tensor:
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _flags:
        _flags[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _flags[device]


def check_indices(device) -> None:
    """Raise ``IndexError`` if a gather on ``device`` met an index out of range since the last
    check, and clear the flag. Synchronises the host with the card."""
    flag = _flag(torch.device(device))
    with trace.host_sync("check_indices"):
        bad = bool(flag.item())
    flag.zero_()
    if bad:
        raise IndexError(f"row_gather: an index was out of range on {device} since the last check")


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [T, F] float32, idx [N] int32 -> [N, F]."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"row_gather: table {tuple(table.shape)}, idx {tuple(idx.shape)}")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"row_gather takes a float32 table and int32 indices, got {table.dtype}, {idx.dtype}")
    if table.device.type == "cpu" and idx.device.type == "cpu":
        if idx.numel():
            lo, hi = (int(x) for x in torch.aminmax(idx))
            if lo < 0 or hi >= table.shape[0]:
                raise IndexError(f"row_gather: indices span [{lo}, {hi}], the table has {table.shape[0]} rows")
        return row_gather_reference(table, idx)
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError(f"row_gather: table on {table.device}, idx on {idx.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather takes contiguous tensors")
    (T, F), N = table.shape, idx.shape[0]
    out = torch.empty((N, F), dtype=table.dtype, device=table.device)
    if N and F:
        stream = torch.cuda.current_stream(table.device).cuda_stream
        code = build.load().row_gather(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                       _flag(table.device).data_ptr(), T, N, F, stream)
        build.check(code, "row_gather")
    return out
