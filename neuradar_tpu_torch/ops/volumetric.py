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

``fused_composite`` (kernel K3) composites without the sky sample and also
returns the expected depth; it is forward only, as the JAX package's
``fused_composite``, and no path of either package calls it.
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
    return w_sky, features, accum


# The backward kernel's two paths (csrc/composite_sky.cu): the float4 path takes up to 64 samples
# and a multiple of 4 channels up to 128, with 16-byte aligned rows; the general path takes the
# rest, up to 768 samples (two [S] rows per warp in shared memory).
_FLOAT4_MAX_SAMPLES = 64
_FLOAT4_MAX_CHANNELS = 128
_MAX_BWD_SAMPLES = 768


def composite_sky_bwd_path(feats: torch.Tensor, df: torch.Tensor) -> str:
    """Which path of the backward kernel takes these rows: "float4" or "general"."""
    S, C = feats.shape[-2:]
    aligned = feats.data_ptr() % 16 == 0 and df.data_ptr() % 16 == 0
    fits = S <= _FLOAT4_MAX_SAMPLES and C % 4 == 0 and 0 < C <= _FLOAT4_MAX_CHANNELS
    return "float4" if fits and aligned else "general"


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
    # one launch: the float4 launcher (composite_sky_bwd) or the general one
    symbol = "composite_sky_bwd" if composite_sky_bwd_path(feats, df) == "float4" else "composite_sky_bwd_general"
    dalpha = torch.empty_like(alpha)
    dfeats = torch.empty_like(feats)
    stream = torch.cuda.current_stream(alpha.device).cuda_stream
    code = getattr(build.load(), symbol)(alpha.data_ptr(), feats.data_ptr(), dwsky.data_ptr(), df.data_ptr(),
                                         daccum.data_ptr(), dalpha.data_ptr(), dfeats.data_ptr(), R, S, C, stream)
    build.check(code, symbol)
    return dalpha, dfeats


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


def composite_reference(alpha: torch.Tensor, features: torch.Tensor, steps: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch K3: cumprod weights, then the feature, depth and accumulation sums."""
    weights = render_weights_from_alpha(alpha)
    return (weights, (weights[..., None] * features).sum(dim=-2), (weights * steps).sum(dim=-1, keepdim=True),
            weights.sum(dim=-1, keepdim=True))


def fused_composite(alpha: torch.Tensor, features: torch.Tensor, steps: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """K3 (forward only, as the JAX function): alpha [R, S], features [R, S, C], sample midpoints
    steps [R, S] -> (weights [R, S], features [R, C], depth [R, 1], accum [R, 1]), no sky sample."""
    if all(t.device.type == "cpu" for t in (alpha, features, steps)):
        return composite_reference(alpha, features, steps)
    if alpha.dim() != 2 or features.dim() != 3:
        raise ValueError(f"fused_composite: alpha {tuple(alpha.shape)}, features {tuple(features.shape)}")
    R, S = alpha.shape
    C = features.shape[-1]
    _check("fused_composite", (alpha, features, steps), ((R, S), (R, S, C), (R, S)))
    lib = build.load()
    weights = torch.empty_like(alpha)
    out = torch.empty((R, C), dtype=features.dtype, device=features.device)
    depth = torch.empty((R, 1), dtype=alpha.dtype, device=alpha.device)
    accum = torch.empty((R, 1), dtype=alpha.dtype, device=alpha.device)
    stream = torch.cuda.current_stream(alpha.device).cuda_stream
    code = lib.composite_fwd(alpha.data_ptr(), features.data_ptr(), steps.data_ptr(), weights.data_ptr(),
                             out.data_ptr(), depth.data_ptr(), accum.data_ptr(), R, S, C, stream)
    build.check(code, "composite_fwd")
    return weights, out, depth, accum
