"""Fused self-attention for the radar encoder (kernel K2, forward).

``self_attention_fwd`` computes softmax(q k^T * D^-1/2) v over q, k, v
[B, S, D] (heads folded into B). On a CUDA tensor it launches the
hand-written kernel in ``csrc/attention.cu``, which never writes the [S, S]
scores out; on a CPU tensor it runs ``attention_reference``, the plain
formulation of ``reference_attention`` in the JAX package's ops/attention.py.
Only dropout rate 0 (the eval path) is implemented on the card.
"""

from __future__ import annotations

import torch

from neuradar_tpu_torch.ops import build

_HEAD_DIMS = (16, 32, 48, 64)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: scores (scaled by D^-1/2) materialized, softmax, weighted sum in float32."""
    s = torch.einsum("bqd,bkd->bqk", q.float() * q.shape[-1] ** -0.5, k.float())
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def self_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dropout_rate: float = 0.0) -> torch.Tensor:
    """K2 forward: [B, S, D] -> [B, S, D], scores scaled by D^-1/2."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        if dropout_rate > 0.0:
            raise NotImplementedError("attention dropout comes with the backward kernel")
        return attention_reference(q, k, v)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"self_attention_fwd: tensors on {q.device}, {k.device}, {v.device}")
    if dropout_rate > 0.0:
        raise NotImplementedError("self_attention_fwd runs at dropout rate 0 only")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError(f"self_attention_fwd takes float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"self_attention_fwd: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"self_attention_fwd is built for head widths {_HEAD_DIMS}, got {D}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("self_attention_fwd takes contiguous, 16-byte aligned tensors")
    lib = build.load()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.self_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, D, D**-0.5,
                                  stream)
    build.check(code, "self_attention_fwd")
    self_attention_fwd.launches += 1
    return out


self_attention_fwd.launches = 0
