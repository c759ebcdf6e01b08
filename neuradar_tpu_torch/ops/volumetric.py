"""Volume compositing with sky redistribution (kernel K1, forward).

``composite_sky_fwd`` takes per-sample alphas [R, S] and features [R, S, C]
and returns, per ray, the weights with the leftover mass moved onto the last
(sky) sample ``w_sky`` [R, S], the rendered features [R, C] and the
accumulation before redistribution [R, 1]. On a CUDA tensor it launches the
hand-written kernel in ``csrc/composite_sky.cu``; on a CPU tensor it runs
``composite_sky_reference``, the plain formulation of the JAX package's
models/neuradar.py (the non-Pallas branch of ``_nff_core``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from neuradar_tpu_torch.cameras.rays import render_weights_from_alpha
from neuradar_tpu_torch.ops import build


def composite_sky_reference(alpha: torch.Tensor, feats: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch K1: cumprod weights, sky redistribution, feature sum."""
    weights = render_weights_from_alpha(alpha)
    accum = weights.sum(dim=-1, keepdim=True)
    w_sky = torch.cat([weights[..., :-1], weights[..., -1:] + 1 - accum], dim=-1)
    features = (w_sky[..., None] * feats).sum(dim=-2)
    return w_sky, features, accum


def composite_sky_fwd(alpha: torch.Tensor, feats: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """K1 forward: (w_sky [R, S], features [R, C], accum [R, 1])."""
    if alpha.device.type == "cpu" and feats.device.type == "cpu":
        return composite_sky_reference(alpha, feats)
    if alpha.device.type != "cuda" or feats.device != alpha.device:
        raise ValueError(f"composite_sky_fwd: tensors on {alpha.device} and {feats.device}")
    if alpha.dtype != torch.float32 or feats.dtype != torch.float32:
        raise TypeError(f"composite_sky_fwd takes float32, got {alpha.dtype} and {feats.dtype}")
    if alpha.dim() != 2 or feats.dim() != 3 or feats.shape[:2] != alpha.shape:
        raise ValueError(f"composite_sky_fwd: alpha {tuple(alpha.shape)}, feats {tuple(feats.shape)}")
    if not (alpha.is_contiguous() and feats.is_contiguous()):
        raise ValueError("composite_sky_fwd takes contiguous tensors")
    R, S = alpha.shape
    C = feats.shape[-1]
    if S == 0:
        raise ValueError("composite_sky_fwd needs at least one sample per ray")
    lib = build.load()
    w_sky = torch.empty_like(alpha)
    features = torch.empty((R, C), dtype=feats.dtype, device=feats.device)
    accum = torch.empty((R, 1), dtype=alpha.dtype, device=alpha.device)
    stream = torch.cuda.current_stream(alpha.device).cuda_stream
    code = lib.composite_sky_fwd(alpha.data_ptr(), feats.data_ptr(), w_sky.data_ptr(), features.data_ptr(),
                                 accum.data_ptr(), R, S, C, stream)
    build.check(code, "composite_sky_fwd")
    composite_sky_fwd.launches += 1
    return w_sky, features, accum


composite_sky_fwd.launches = 0
