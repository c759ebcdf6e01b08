"""Volume compositing with sky redistribution (kernel K1, forward and backward).

``composite_sky_fwd`` takes per-sample alphas [R, S] and features [R, S, C]
and returns, per ray, the weights with the leftover mass moved onto the last
(sky) sample ``w_sky`` [R, S], the rendered features [R, C] and the
accumulation before redistribution [R, 1]. ``composite_sky_bwd`` maps the
cotangents of those three outputs back to dalpha [R, S] and dfeats [R, S, C].
On CUDA tensors both launch the hand-written kernels in
``csrc/composite_sky.cu``; on CPU tensors they run the plain versions:
``composite_sky_reference`` (the formulation of the JAX package's
models/neuradar.py, the non-Pallas branch of ``_nff_core``) and autograd
through it. ``composite_sky`` is the differentiable entry point.
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


def composite_sky_bwd_reference(alpha, feats, dwsky, df, daccum) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1 backward: autograd through ``composite_sky_reference``."""
    with torch.enable_grad():
        a = alpha.detach().requires_grad_(True)
        f = feats.detach().requires_grad_(True)
        outs = composite_sky_reference(a, f)
        return torch.autograd.grad(outs, (a, f), (dwsky, df, daccum))


def _check(name: str, tensors, shapes) -> None:
    device = tensors[0].device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes float32, got {[t.dtype for t in tensors]}")
    if [tuple(t.shape) for t in tensors] != [tuple(s) for s in shapes]:
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]}, expected {shapes}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def composite_sky_fwd(alpha: torch.Tensor, feats: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """K1 forward: (w_sky [R, S], features [R, C], accum [R, 1])."""
    if alpha.device.type == "cpu" and feats.device.type == "cpu":
        return composite_sky_reference(alpha, feats)
    if alpha.dim() != 2 or feats.dim() != 3:
        raise ValueError(f"composite_sky_fwd: alpha {tuple(alpha.shape)}, feats {tuple(feats.shape)}")
    R, S = alpha.shape
    C = feats.shape[-1]
    _check("composite_sky_fwd", (alpha, feats), ((R, S), (R, S, C)))
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

# the backward kernel keeps two [S] rows per warp in shared memory (csrc/composite_sky.cu)
_MAX_BWD_SAMPLES = 768


def composite_sky_bwd(alpha, feats, dwsky, df, daccum) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 backward: cotangents of (w_sky, features, accum) -> (dalpha [R, S], dfeats [R, S, C])."""
    if all(t.device.type == "cpu" for t in (alpha, feats, dwsky, df, daccum)):
        return composite_sky_bwd_reference(alpha, feats, dwsky, df, daccum)
    if alpha.dim() != 2 or feats.dim() != 3:
        raise ValueError(f"composite_sky_bwd: alpha {tuple(alpha.shape)}, feats {tuple(feats.shape)}")
    R, S = alpha.shape
    C = feats.shape[-1]
    _check("composite_sky_bwd", (alpha, feats, dwsky, df, daccum), ((R, S), (R, S, C), (R, S), (R, C), (R, 1)))
    if not 0 < S <= _MAX_BWD_SAMPLES:
        raise ValueError(f"composite_sky_bwd takes 1 to {_MAX_BWD_SAMPLES} samples per ray, got {S}")
    lib = build.load()
    dalpha = torch.empty_like(alpha)
    dfeats = torch.empty_like(feats)
    stream = torch.cuda.current_stream(alpha.device).cuda_stream
    code = lib.composite_sky_bwd(alpha.data_ptr(), feats.data_ptr(), dwsky.data_ptr(), df.data_ptr(),
                                 daccum.data_ptr(), dalpha.data_ptr(), dfeats.data_ptr(), R, S, C, stream)
    build.check(code, "composite_sky_bwd")
    composite_sky_bwd.launches += 1
    return dalpha, dfeats


composite_sky_bwd.launches = 0


class _CompositeSky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alpha, feats):
        ctx.save_for_backward(alpha, feats)
        return composite_sky_fwd(alpha, feats)

    @staticmethod
    def backward(ctx, dwsky, df, daccum):
        alpha, feats = ctx.saved_tensors
        R, S = alpha.shape

        def cot(g, shape):  # an output without a loss gradient arrives as None
            return torch.zeros(shape, dtype=alpha.dtype, device=alpha.device) if g is None else g.contiguous()

        return composite_sky_bwd(alpha, feats, cot(dwsky, (R, S)), cot(df, (R, feats.shape[-1])), cot(daccum, (R, 1)))


def composite_sky(alpha: torch.Tensor, feats: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Differentiable K1: (w_sky, features, accum); the backward is ``composite_sky_bwd``."""
    return _CompositeSky.apply(alpha.contiguous(), feats.contiguous())
