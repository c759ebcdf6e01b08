"""Training losses (port of the JAX package's model_components/losses.py: NeuRadar's ZipNeRF
interlevel loss, nerfacto's MipNeRF-360 interlevel loss, the MipNeRF-360 distortion loss and their
helpers, all on dense [R, S(+1)] tensors).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from neuradar_tpu_torch.cameras.rays import RaySamples

EPS = 1e-7


def ray_samples_to_sdist(ray_samples: RaySamples) -> torch.Tensor:
    """Normalized bin edges [R, S+1]."""
    return torch.cat([ray_samples.spacing_starts[..., 0], ray_samples.spacing_ends[..., -1:, 0]], dim=-1)


def lossfun_distortion(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """MipNeRF-360 distortion of the histogram (t edges [R, S+1], w [R, S]) -> [R]."""
    ut = (t[..., 1:] + t[..., :-1]) / 2
    dut = torch.abs(ut[..., :, None] - ut[..., None, :])
    loss_inter = torch.sum(w * torch.sum(w[..., None, :] * dut, dim=-1), dim=-1)
    loss_intra = torch.sum(w**2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3
    return loss_inter + loss_intra


def distortion_loss_sdist(sdist: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return torch.mean(lossfun_distortion(sdist, weights))


def distortion_loss(weights_list: Sequence[torch.Tensor], ray_samples_list: Sequence[RaySamples]) -> torch.Tensor:
    """The distortion of the final round's histogram, averaged over the rays."""
    return distortion_loss_sdist(ray_samples_to_sdist(ray_samples_list[-1]), weights_list[-1][..., 0])


def _outer_measure(t0: torch.Tensor, t1: torch.Tensor, y1: torch.Tensor) -> torch.Tensor:
    """For each bin of the edges t0 [R, S0+1], the y1 mass [R, S1] of every bin of t1 [R, S1+1]
    that overlaps it."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)], dim=-1)
    sr = torch.searchsorted(t1.contiguous(), t0.contiguous(), right=True)
    last = t1.shape[-1] - 1
    cy1_lo = torch.gather(cy1, -1, torch.clamp(sr - 1, 0, last))
    cy1_hi = torch.gather(cy1, -1, torch.clamp(sr, 0, last))
    return cy1_hi[..., 1:] - cy1_lo[..., :-1]


def lossfun_outer(t: torch.Tensor, w: torch.Tensor, t_env: torch.Tensor, w_env: torch.Tensor) -> torch.Tensor:
    """Each bin's penalty for the histogram (t, w) escaping the envelope (t_env, w_env)."""
    return torch.clamp(w - _outer_measure(t, t_env, w_env), min=0.0) ** 2 / (w + EPS)


def interlevel_loss(weights_list: Sequence[torch.Tensor], ray_samples_list: Sequence[RaySamples]) -> torch.Tensor:
    """MipNeRF-360's proposal loss (nerfacto's): each proposal histogram must bound the detached
    final one from above."""
    c = ray_samples_to_sdist(ray_samples_list[-1]).detach()
    w = weights_list[-1][..., 0].detach()
    loss = 0.0
    for ray_samples, weights in zip(ray_samples_list[:-1], weights_list[:-1]):
        loss = loss + torch.mean(lossfun_outer(c, w, ray_samples_to_sdist(ray_samples), weights[..., 0]))
    return loss


def _blur_stepfun(x: torch.Tensor, y: torch.Tensor, r: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Box-blur a step function (edges x [R, n+1], densities y [R, n])."""
    xr, xr_idx = torch.sort(torch.cat([x - r, x + r], dim=-1), dim=-1, stable=True)
    y1 = (torch.cat([y, torch.zeros_like(y[..., :1])], dim=-1)
          - torch.cat([torch.zeros_like(y[..., :1]), y], dim=-1)) / (2 * r)
    y2 = torch.gather(torch.cat([y1, -y1], dim=-1), -1, xr_idx[..., :-1])
    yr = torch.clamp(torch.cumsum((xr[..., 1:] - xr[..., :-1]) * torch.cumsum(y2, dim=-1), dim=-1), min=0.0)
    return xr, torch.cat([torch.zeros_like(yr[..., :1]), yr], dim=-1)


def _sorted_interp_quad(x: torch.Tensor, xp: torch.Tensor, fpdf: torch.Tensor, fcdf: torch.Tensor) -> torch.Tensor:
    """Piecewise-quadratic interpolation of the CDF (fcdf, with density fpdf at knots xp) at x."""
    right_idx = torch.searchsorted(xp.contiguous(), x.contiguous())
    left_idx = torch.clamp(right_idx - 1, min=0)
    right_idx = torch.clamp(right_idx, max=xp.shape[-1] - 1)
    xp0, xp1 = torch.gather(xp, -1, left_idx), torch.gather(xp, -1, right_idx)
    fpdf0, fpdf1 = torch.gather(fpdf, -1, left_idx), torch.gather(fpdf, -1, right_idx)
    fcdf0 = torch.gather(fcdf, -1, left_idx)
    offset = torch.clamp(torch.nan_to_num((x - xp0) / (xp1 - xp0), nan=0.0), 0, 1)
    return fcdf0 + (x - xp0) * (fpdf0 + fpdf1 * offset + fpdf0 * (1 - offset)) * 0.5


def _pulse_width(i: int) -> float:
    """ZipNeRF blur width of proposal round i (0.03, 0.003, then /10 per extra round)."""
    widths = (0.03, 0.003)
    if i < len(widths):
        return widths[i]
    return widths[-1] / (10 ** (i - len(widths) + 1))


def zipnerf_interlevel_loss_sdist(sdist_list: Sequence[torch.Tensor], weights_list: Sequence[torch.Tensor]) -> torch.Tensor:
    """Anti-aliased interlevel loss on raw sdist/weight tensors (final level last): each
    proposal histogram must cover the blurred, detached final histogram."""
    c = sdist_list[-1].detach()
    w = weights_list[-1].detach()
    accum_w = torch.sum(w, dim=-1, keepdim=True)
    w = torch.cat([w[..., :-1], w[..., -1:] + (1 - accum_w)], dim=-1)
    w_norm = w / (c[..., 1:] - c[..., :-1])
    loss = 0.0
    for i, (cp, wp) in enumerate(zip(sdist_list[:-1], weights_list[:-1])):
        c_, w_ = _blur_stepfun(c, w_norm, _pulse_width(i))
        area = 0.5 * (w_[..., 1:] + w_[..., :-1]) * (c_[..., 1:] - c_[..., :-1])
        cdf = torch.cat([torch.zeros_like(area[..., :1]), torch.cumsum(area, dim=-1)], dim=-1)
        c_ = torch.cat([torch.zeros_like(c_[..., :1]), c_, torch.ones_like(c_[..., :1])], dim=-1)
        w_ = torch.cat([torch.zeros_like(w_[..., :1]), w_, torch.zeros_like(w_[..., :1])], dim=-1)
        cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], dim=-1)
        w_s = torch.diff(_sorted_interp_quad(cp, c_, w_, cdf), dim=-1)
        loss = loss + torch.mean(torch.sum(torch.clamp(w_s - wp, min=0.0) ** 2 / (wp + 1e-5), dim=-1))
    return loss


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over the entries where mask is True (0 when none are)."""
    mask = mask.to(x.dtype)
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def binary_cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits, in the JAX package's formulation."""
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))
