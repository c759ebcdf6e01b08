"""The precision control of the benchmark's correctness check: the model one precision below
what its configuration states.

Inside ``float8_weights()`` every hash table and every dense layer's weight and input that the model
casts to bfloat16 is also rounded to float8 (e4m3, scaled per tensor by its largest magnitude, as fp8
weights and activations are stored), with the gradient passed straight through, and the RGB
decoder's float32 convolutions run in bfloat16 (``lower_float32``). Outside it ``round_fp8`` is the
identity, ``lower_float32`` does nothing, and the model computes as its configuration states.
"""

from __future__ import annotations

import contextlib

import torch

_E4M3_MAX = 448.0
_state = {"fp8": False}


@contextlib.contextmanager
def float8_weights():
    """The model's bf16 casts round through float8 e4m3 while the block runs."""
    _state["fp8"] = True
    try:
        yield
    finally:
        _state["fp8"] = False


def lower_float32(device_type: str):
    """Inside ``float8_weights()``: autocast to bfloat16 on ``device_type``; else no change."""
    if not _state["fp8"]:
        return contextlib.nullcontext()
    return torch.autocast(device_type, dtype=torch.bfloat16)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through scaled float8 e4m3 inside ``float8_weights()`` (else x itself)."""
    if not _state["fp8"] or x.dtype == torch.float32:
        return x
    scale = (x.detach().abs().amax().float() / _E4M3_MAX).clamp(min=1e-30)
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x.detach())
