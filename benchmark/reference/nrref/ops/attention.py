"""Self-attention of the radar encoder (kernel K2), plain PyTorch only.

softmax(q k^T * D^-1/2) v over q, k, v [B, S, D] with the scores materialized, dropout on the
probabilities by the keep mask of (seed, batch index, query row, key column) that the port's kernels
hash, the sums in float32 and the result in q's dtype; the backward is autograd through it.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_STREAM_MUL = 0x27D4EB2F


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_threshold(rate: float) -> int:
    """An entry is kept when its 32-bit hash is >= this threshold; 0 means no dropout."""
    return min(int(rate * 4294967296.0), 4294967295) if rate > 0.0 else 0


def keep_mask(seed: int, B: int, S: int, rate: float, device=None) -> torch.Tensor:
    """Boolean keep mask [B, S, S] of (seed, b, query, key)."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    streams = _fmix32((seed + _mul32(torch.arange(B, dtype=torch.int64, device=dev), _STREAM_MUL)) & _M32)
    idx = torch.arange(S, dtype=torch.int64, device=dev)
    qk = (_mul32(idx, 0x9E3779B9)[:, None] + _mul32(idx, 0x85EBCA6B)[None, :]) & _M32  # [S, S]
    thresh = dropout_threshold(rate)
    return torch.stack([_fmix32((qk + stream) & _M32) >= thresh for stream in streams])


def batch_offset_seed(seed: int, b0: int) -> int:
    """The seed whose keep mask at batch index b is ``seed``'s at b0 + b."""
    return (seed + b0 * _STREAM_MUL) & _M32


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: int = 0,
                   dropout_rate: float = 0.0) -> torch.Tensor:
    """[B, S, D] -> [B, S, D]: scores in float32, softmax, dropout, weighted sum, q's dtype."""
    dtype = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bqd,bkd->bqk", q.to(dtype) * q.shape[-1] ** -0.5, k.to(dtype))
    p = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        p = p * keep_mask(seed, q.shape[0], q.shape[1], dropout_rate, q.device) / (1.0 - dropout_rate)
    return torch.einsum("bqk,bkd->bqd", p, v.to(p.dtype)).to(q.dtype)
