"""K4: the hash-grid encode of one grid as one CUDA op (``csrc/hash_encode.cu``).

``hash_encode(positions, table, scalings, table_size, num_levels, features_per_level)`` is a
``torch.autograd.Function``: positions [N, d] (float32), the flat table [L * T * F] in the compute type
R (float32 or bf16) and the level scalings rounded to R on the host -> [N, L * F] (float32). Its forward
is one launch (``hash_encode_fwd``), bit-equal to the plain path (``field_components/encodings.hash_encode``
with the positions cast to R and the output cast back). Its backward (``hash_encode_bwd``, inside the span
``hash_encode/scatter``, timed on the card) saves nothing but the positions and the table: it recomputes
each corner's row and weight, adds every corner's gradient into the table's (float32 atomics, rounded once
to R), one launch a group of levels (``levels_per_launch``: a bf16 table's float32 accumulator holds at
most ``SCRATCH_FLOATS`` values), and where ``ctx.needs_input_grad`` asks for it computes the positions'
gradient in float64 and rounds it once. A run of a warp's consecutive points in one cell of a level adds
its corners' sum with one atomic; inside ``trace.recording()`` (not under a profiler alone), the launches
count the table gradient's nonzero contributions and their atomics on the card
(``hash_encode/bwd_contributions``, ``hash_encode/bwd_atomics``). The kernel is templated on d in {3, 4},
F in {1, 2, 4} and R, which covers every preset's grid; ``check`` refuses any other encode (an untemplated
grid or dtype, CUDA tensors on two devices, a table not aligned to its rows): there is no fallback on the
card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from neuradar_tpu_torch.ops import build
from neuradar_tpu_torch.utils import trace

MAX_LEVELS = 32  # csrc/hash_encode.cu's kMaxLevels: the scalings go to the kernel by value
DIMS = (3, 4)
FEATURES = (1, 2, 4)
DTYPES = (torch.float32, torch.bfloat16)
# the float32 accumulator of a bf16 table's gradient: at most 2^24 values (64 MiB), one level of a
# 2^22-row grid of 4 features; smaller tables fit in it whole
SCRATCH_FLOATS = 1 << 24


def templated(dims: int, features_per_level: int, num_levels: int, table_dtype: torch.dtype,
              pos_dtype: torch.dtype) -> bool:
    """Whether the kernel has a template for this grid and these dtypes (float32 positions: the model's)."""
    return (dims in DIMS and features_per_level in FEATURES and 1 <= num_levels <= MAX_LEVELS
            and table_dtype in DTYPES and pos_dtype == torch.float32)


def check(positions: torch.Tensor, table: torch.Tensor, num_levels: int, features_per_level: int) -> None:
    """Raise unless the kernel runs the encode of ``positions`` [N, d] through ``table`` (flat, in R): CUDA
    tensors on one device, a templated grid, the table contiguous and aligned to its rows."""
    L, F = num_levels, features_per_level
    if not (positions.is_cuda and table.device == positions.device and positions.dim() == 2):
        raise ValueError(f"K4 takes [N, d] positions and a table on one CUDA device: got positions "
                         f"{tuple(positions.shape)} on {positions.device}, the table on {table.device}")
    if not templated(positions.shape[1], F, L, table.dtype, positions.dtype):
        raise TypeError(f"K4 has no template for d {positions.shape[1]}, F {F}, L {L}, a {table.dtype} table "
                        f"and {positions.dtype} positions")
    if not table.is_contiguous() or table.data_ptr() % (F * table.element_size()):
        raise ValueError("K4 reads the table's rows as aligned vectors: the table must be contiguous and "
                         "aligned to its rows")


def host_scalings(scalings: Sequence[float], dtype: torch.dtype) -> Tuple[float, ...]:
    """The level scalings rounded to ``dtype`` as ``torch.tensor(scalings, dtype=dtype)`` rounds them,
    on the host."""
    return tuple(torch.tensor(scalings, dtype=dtype).float().tolist())


def levels_per_launch(T: int, F: int, L: int, dtype: torch.dtype) -> int:
    """The levels one backward launch covers: all of a float32 table's; as many of a bf16 table's as the
    float32 accumulator holds, at least one."""
    return L if dtype == torch.float32 else max(1, min(L, SCRATCH_FLOATS // (T * F)))


def _floats(values: Sequence[float]):
    return (ctypes.c_float * len(values))(*values)


def _ptr(t: Optional[torch.Tensor], offset_bytes: int = 0):
    return None if t is None else t.data_ptr() + offset_bytes


def hash_encode_fwd(positions: torch.Tensor, table: torch.Tensor, scalings: Sequence[float], table_size: int,
                    num_levels: int, features_per_level: int) -> torch.Tensor:
    """One launch: positions [N, d] (float32, contiguous) -> [N, L * F] (float32)."""
    N, d = positions.shape
    L, F = num_levels, features_per_level
    out = torch.empty((N, L * F), dtype=torch.float32, device=positions.device)
    stream = torch.cuda.current_stream(positions.device).cuda_stream
    code = build.load().hash_encode_fwd(positions.data_ptr(), table.data_ptr(), int(table.dtype == torch.bfloat16),
                                        out.data_ptr(), _floats(scalings), N, d, L, F, table_size, stream)
    build.check(code, "hash_encode_fwd")
    return out


def hash_encode_bwd(grad_out: torch.Tensor, positions: torch.Tensor, table: torch.Tensor, scalings: Sequence[float],
                    table_size: int, num_levels: int, features_per_level: int, pos_grad: bool,
                    table_grad: bool) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The gradients of the positions [N, d] (if ``pos_grad``) and of the table [L * T * F] (if
    ``table_grad``) from ``grad_out`` [N, L * F] (float32, contiguous); one launch a group of
    levels, all levels at once where only the positions need a gradient."""
    N, d = positions.shape
    L, F, T = num_levels, features_per_level, table_size
    device, dtype = positions.device, table.dtype
    bf16 = dtype == torch.bfloat16
    per = levels_per_launch(T, F, L, dtype) if table_grad else L
    groups = math.ceil(L / per)
    gt = torch.empty(L * T * F, dtype=dtype, device=device) if table_grad else None
    acc = torch.empty(per * T * F, dtype=torch.float32, device=device) if table_grad and bf16 else gt
    gp = torch.empty_like(positions) if pos_grad else None
    pos_acc = torch.empty((N, d), dtype=torch.float64, device=device) if pos_grad and groups > 1 else None
    # the two counts the launches add on the card, read when the window's snapshot is taken
    stats = torch.zeros(2, dtype=torch.int64, device=device) if table_grad and trace.counting_device() else None
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = build.load()
    scal = _floats(scalings)
    for g, l0 in enumerate(range(0, L, per)):
        l1 = min(L, l0 + per)
        # bf16: the accumulator from its start, rounded into the group's rows of gt; float32: gt's rows
        acc_ptr = _ptr(acc) if bf16 else _ptr(acc, l0 * T * F * 4)
        out_ptr = _ptr(gt, l0 * T * F * 2) if bf16 else None
        code = lib.hash_encode_bwd(positions.data_ptr(), table.data_ptr(), int(bf16), grad_out.data_ptr(), scal, N, d,
                                   L, F, T, l0, l1, acc_ptr, out_ptr, _ptr(pos_acc), _ptr(gp), int(g == 0),
                                   int(g == groups - 1), _ptr(stats), stream)
        build.check(code, "hash_encode_bwd")
        if table_grad:
            trace.count("hash_scatter_rows", 2**d * N * (l1 - l0))
    if stats is not None:
        trace.count_device("hash_encode/bwd_contributions", stats[0])
        trace.count_device("hash_encode/bwd_atomics", stats[1])
    return gp, gt


class HashEncode(torch.autograd.Function):
    """The encode's forward launch; the backward recomputes the corners from the saved positions."""

    @staticmethod
    def forward(ctx, positions, table, scalings, table_size, num_levels, features_per_level):
        ctx.save_for_backward(positions, table)
        ctx.grid = (tuple(scalings), table_size, num_levels, features_per_level)
        return hash_encode_fwd(positions, table, scalings, table_size, num_levels, features_per_level)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        positions, table = ctx.saved_tensors
        with trace.span("hash_encode/scatter", device=True):
            gp, gt = hash_encode_bwd(grad_out.contiguous(), positions, table, *ctx.grid,
                                     ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return gp, gt, None, None, None, None


def hash_encode(positions: torch.Tensor, table: torch.Tensor, scalings: Sequence[float], table_size: int,
                num_levels: int, features_per_level: int) -> torch.Tensor:
    """positions [N, d] -> [N, L * F], through the kernel (``check`` raises for what it does not run);
    ``scalings`` rounded to the table's dtype (``host_scalings``)."""
    positions, table = positions.contiguous(), table.contiguous()
    check(positions, table, num_levels, features_per_level)
    return HashEncode.apply(positions, table, scalings, table_size, num_levels, features_per_level)
