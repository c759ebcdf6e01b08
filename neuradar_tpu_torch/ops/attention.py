"""Fused self-attention for the radar encoder (kernel K2, forward and backward).

``self_attention_fwd`` computes softmax(q k^T * D^-1/2) v over q, k, v
[B, S, D] (heads folded into B), with optional dropout on the probabilities,
and ``self_attention_bwd`` its gradients. On CUDA tensors they launch the
hand-written kernels in ``csrc/attention.cu``, which never write the [S, S]
scores out; on CPU tensors they run the plain versions: ``attention_reference``
(the formulation of ``reference_attention`` in the JAX package's
ops/attention.py, plus the dropout mask) and autograd through it.
``self_attention`` is the differentiable entry point.

The dropout keep mask is a pure function of (seed, batch index, query row,
key column), computed by ``keep_mask`` with int64 arithmetic masked to 32
bits; the kernels compute the same bits in uint32, so the card and the CPU
drop the same entries, and the forward and backward agree by construction.
``batch_offset_seed`` gives the seed whose mask at batch index b is another
seed's at b0 + b, so a batch cut in groups draws the masks of the whole.

Inputs are float32 or bfloat16, one dtype for all. On the card a bfloat16
call launches the kernels of ``csrc/attention_bf16.cu`` (warpgroup MMAs on bf16
tiles that the TMA copies, every sum in float32, as the JAX package's kernel
computes at bf16) through ``self_attention_bf16_fwd`` / ``_bwd``; a float32 call
the float32 kernels. The plain versions compute in float32 and return the input
dtype. The backward takes the forward's output in float32 (for bf16, the output
before its rounding: ``return_out32``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from neuradar_tpu_torch.ops import build

_HEAD_DIMS = (16, 32, 48, 64)
_DTYPES = (torch.float32, torch.bfloat16)
_M32 = 0xFFFFFFFF
_STREAM_MUL = 0x27D4EB2F


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer (the constants of the JAX package's keep mask)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_threshold(rate: float) -> int:
    """An entry is kept when its 32-bit hash is >= this threshold; 0 means no dropout."""
    return min(int(rate * 4294967296.0), 4294967295) if rate > 0.0 else 0


def keep_mask(seed: int, B: int, S: int, rate: float, device=None) -> torch.Tensor:
    """Boolean keep mask [B, S, S] of (seed, b, query, key); independent of any tiling."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    streams = _fmix32((seed + _mul32(torch.arange(B, dtype=torch.int64, device=dev), _STREAM_MUL)) & _M32)
    idx = torch.arange(S, dtype=torch.int64, device=dev)
    qk = (_mul32(idx, 0x9E3779B9)[:, None] + _mul32(idx, 0x85EBCA6B)[None, :]) & _M32  # [S, S]
    thresh = dropout_threshold(rate)
    # one scan at a time bounds the int64 temporaries to [S, S]
    return torch.stack([_fmix32((qk + stream) & _M32) >= thresh for stream in streams])


def batch_offset_seed(seed: int, b0: int) -> int:
    """The seed whose keep mask at batch index b is ``seed``'s at b0 + b (the stream hash adds
    b * _STREAM_MUL to the seed)."""
    return (seed + b0 * _STREAM_MUL) & _M32


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: int = 0,
                        dropout_rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch K2: scores (scaled by D^-1/2) materialized, softmax, dropout, weighted sum
    in float32 (float64 stays float64), returned in q's dtype."""
    return _attend(q, k, v, seed, dropout_rate).to(q.dtype)


def _attend(q, k, v, seed, dropout_rate):
    p = torch.softmax(_scores(q, k), dim=-1)
    if dropout_rate > 0.0:
        p = p * keep_mask(seed, q.shape[0], q.shape[1], dropout_rate, q.device) / (1.0 - dropout_rate)
    return torch.einsum("bqk,bkd->bqd", p, v.to(p.dtype))


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    dtype = torch.promote_types(q.dtype, torch.float32)
    return torch.einsum("bqd,bkd->bqk", q.to(dtype) * q.shape[-1] ** -0.5, k.to(dtype))


def attention_bwd_reference(q, k, v, dout, seed: int = 0, dropout_rate: float = 0.0):
    """Plain PyTorch K2 backward: autograd through ``attention_reference``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_reference(*leaves, seed=seed, dropout_rate=dropout_rate)
        return torch.autograd.grad(out, leaves, dout)


def _check(name: str, tensors, shape) -> torch.dtype:
    """Device, one dtype (float32 or bfloat16), shape, head width and alignment; returns the dtype."""
    device = tensors[0].device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}")
    dtype = tensors[0].dtype
    if dtype not in _DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{name} takes float32 or bfloat16, one for all, got {[t.dtype for t in tensors]}")
    if len(shape) != 3 or any(tuple(t.shape) != tuple(shape) for t in tensors):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]}")
    if shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name} is built for head widths {_HEAD_DIMS}, got {shape[-1]}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError(f"{name} takes contiguous, 16-byte aligned tensors")
    return dtype


def _check_f32(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, expected float32 {tuple(shape)}")


def _dropout_args(seed: int, rate: float):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    thresh = dropout_threshold(rate)
    return seed & _M32, thresh, (1.0 / (1.0 - rate)) if thresh else 1.0


def launch_fwd(lib, q, k, v, dropout_rate: float, seed: int, return_lse: bool):
    """The forward kernel of ``lib`` (the port's library, or another build of csrc/attention.cu's C
    interface) on checked CUDA tensors: (out, lse or None)."""
    B, S, D = q.shape
    seed32, thresh, inv_keep = _dropout_args(seed, dropout_rate)
    out = torch.empty_like(q)
    lse = torch.empty((B, S), dtype=q.dtype, device=q.device) if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.self_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                  lse.data_ptr() if lse is not None else None, B, S, D, D**-0.5,
                                  seed32, thresh, inv_keep, stream)
    build.check(code, "self_attention_fwd")
    return out, lse


def self_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dropout_rate: float = 0.0,
                       seed: int = 0, return_lse: bool = False, return_out32: bool = False):
    """K2 forward: [B, S, D] -> [B, S, D] (and the row log-sum-exp [B, S] with ``return_lse``, and
    the output in float32 before its rounding, what the backward takes, with ``return_out32``)."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        out32 = _attend(q, k, v, seed, dropout_rate)
        lse = torch.logsumexp(_scores(q, k), dim=-1) if return_lse else None
        return _results(out32.to(q.dtype), lse, out32, return_out32)
    if _check("self_attention_fwd", (q, k, v), q.shape) == torch.bfloat16:
        return self_attention_bf16_fwd(q, k, v, dropout_rate, seed, return_lse, return_out32)
    out, lse = launch_fwd(build.load(), q, k, v, dropout_rate, seed, return_lse)
    return _results(out, lse, out, return_out32)


def _results(out, lse, out32, return_out32: bool):
    """out, then lse where it was asked for (not None), then the float32 output where asked for."""
    extra = ((lse,) if lse is not None else ()) + ((out32,) if return_out32 else ())
    return (out, *extra) if extra else out


def launch_bwd(lib, q, k, v, out, dout, lse, dropout_rate: float, seed: int):
    """The backward kernels of ``lib`` (as ``launch_fwd``) on checked CUDA tensors: (dq, dk, dv)."""
    B, S, D = q.shape
    seed32, thresh, inv_keep = _dropout_args(seed, dropout_rate)
    delta = torch.empty((B, S), dtype=q.dtype, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.self_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                  B, S, D, D**-0.5, seed32, thresh, inv_keep, stream)
    build.check(code, "self_attention_bwd")
    return dq, dk, dv


def self_attention_bwd(q, k, v, out, dout, lse, dropout_rate: float = 0.0,
                       seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 backward: (dq, dk, dv) in q's dtype, recomputing P from q, k and the forward's lse; ``out``
    is the forward's output in float32 (``return_out32``)."""
    if all(t.device.type == "cpu" for t in (q, k, v, dout)):
        return attention_bwd_reference(q, k, v, dout, seed, dropout_rate)
    if _check("self_attention_bwd", (q, k, v, dout), q.shape) == torch.bfloat16:
        return self_attention_bf16_bwd(q, k, v, out, dout, lse, dropout_rate, seed)
    _check("self_attention_bwd", (q, k, v, out, dout), q.shape)
    B, S, _ = q.shape
    _check_f32("self_attention_bwd: lse", lse, (B, S), q.device)
    return launch_bwd(build.load(), q, k, v, out, dout, lse, dropout_rate, seed)


def launch_bf16_fwd(lib, q, k, v, dropout_rate: float, seed: int, return_lse: bool, return_out32: bool):
    """The bf16 forward kernel of ``lib`` (the port's library, or another build of
    csrc/attention_bf16.cu's C interface) on checked CUDA tensors: (out, lse or None, out32 or None)."""
    B, S, D = q.shape
    seed32, thresh, inv_keep = _dropout_args(seed, dropout_rate)
    out = torch.empty_like(q)
    lse = torch.empty((B, S), dtype=torch.float32, device=q.device) if return_lse else None
    out32 = torch.empty((B, S, D), dtype=torch.float32, device=q.device) if return_out32 else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.self_attention_bf16_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), out32.data_ptr() if out32 is not None else None,
        lse.data_ptr() if lse is not None else None, B, S, D, D**-0.5, seed32, thresh, inv_keep, stream)
    build.check(code, "self_attention_bf16_fwd")
    return out, lse, out32


def self_attention_bf16_fwd(q, k, v, dropout_rate: float = 0.0, seed: int = 0, return_lse: bool = False,
                            return_out32: bool = False):
    """K2 forward at bfloat16 on the card (``csrc/attention_bf16.cu``); as ``self_attention_fwd``."""
    _check("self_attention_bf16_fwd", (q, k, v), q.shape)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"self_attention_bf16_fwd takes bfloat16, got {q.dtype}")
    out, lse, out32 = launch_bf16_fwd(build.load(), q, k, v, dropout_rate, seed, return_lse, return_out32)
    return _results(out, lse, out32, return_out32)


def launch_bf16_bwd(lib, q, k, v, out32, dout, lse, dropout_rate: float, seed: int):
    """The bf16 backward kernels of ``lib`` (as ``launch_bf16_fwd``) on checked CUDA tensors:
    (dq, dk, dv). Their float32 scratch (lse in log2 units and delta, per padded row) is sized by
    the port's library, which holds for an earlier build of the source too (it took [B, S])."""
    B, S, D = q.shape
    seed32, thresh, inv_keep = _dropout_args(seed, dropout_rate)
    scratch = torch.empty(build.load().self_attention_bf16_bwd_scratch(B, S), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.self_attention_bf16_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out32.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, D, D**-0.5, seed32, thresh,
        inv_keep, stream)
    build.check(code, "self_attention_bf16_bwd")
    return dq, dk, dv


def self_attention_bf16_bwd(q, k, v, out32, dout, lse, dropout_rate: float = 0.0, seed: int = 0):
    """K2 backward at bfloat16 on the card: (dq, dk, dv) in bf16; delta = rowsum(dO o O) from the
    forward's float32 output ``out32``."""
    _check("self_attention_bf16_bwd", (q, k, v, dout), q.shape)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"self_attention_bf16_bwd takes bfloat16, got {q.dtype}")
    B, S, D = q.shape
    _check_f32("self_attention_bf16_bwd: out32", out32, (B, S, D), q.device)
    _check_f32("self_attention_bf16_bwd: lse", lse, (B, S), q.device)
    return launch_bf16_bwd(build.load(), q, k, v, out32, dout, lse, dropout_rate, seed)


class _SelfAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed: int, dropout_rate: float):
        out, lse, out32 = self_attention_fwd(q, k, v, dropout_rate, seed, return_lse=True, return_out32=True)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.seed, ctx.dropout_rate = seed, dropout_rate
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out32, lse = ctx.saved_tensors
        dq, dk, dv = self_attention_bwd(q, k, v, out32, dout.contiguous(), lse, ctx.dropout_rate, ctx.seed)
        return dq, dk, dv, None, None


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: int = 0,
                   dropout_rate: float = 0.0) -> torch.Tensor:
    """Differentiable K2; ``seed`` and ``dropout_rate`` are not differentiated."""
    if not torch.is_grad_enabled() or not any(t.requires_grad for t in (q, k, v)):
        return self_attention_fwd(q, k, v, dropout_rate, seed)
    return _SelfAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), seed, dropout_rate)
