"""Ray samplers (port of the JAX package's model_components/ray_samplers.py).

power-function (NeuRAD) or linear-then-disparity (nerfacto) spaced initial samples, then PDF
resampling from each proposal round's weight histogram, raised to the nerfacto anneal's exponent
where one is given. In training the bins are stratified: each sampler
takes its uniform jitter as a tensor, drawn beforehand by ``draw_jitter`` from
the caller's generator (so a recomputed forward reuses the same numbers);
without jitter the samplers are deterministic (eval).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from neuradar_tpu_torch.cameras.rays import RayBundle, RaySamples
from neuradar_tpu_torch.utils import rng as rng_utils
from neuradar_tpu_torch.utils.math import inv_power_fn, power_fn


def draw_jitter(generator: torch.Generator, num_rays: int, num_samples_per_round: Sequence[int],
                single_jitter: bool, device) -> List[torch.Tensor]:
    """The stratification noise of a proposal chain, in the order the JAX package draws it:
    one U[0, 1) tensor per round, [R, 1] with single_jitter, else [R, num_samples + 1]."""
    return [rng_utils.uniform(generator, (num_rays, 1 if single_jitter else n + 1), device)
            for n in num_samples_per_round]


def spaced_sampler(ray_bundle: RayBundle, num_samples: int, spacing_fn: Callable,
                   spacing_fn_inv: Callable, jitter: Optional[torch.Tensor] = None) -> RaySamples:
    """Bins evenly spaced in the spacing function's [0, 1] domain; stratified by ``jitter``
    ([R, 1] or [R, S + 1] uniforms) when given."""
    bins = torch.linspace(0.0, 1.0, num_samples + 1, dtype=ray_bundle.origins.dtype,
                          device=ray_bundle.origins.device)[None, :]
    if jitter is not None:
        centers = (bins[..., 1:] + bins[..., :-1]) / 2.0
        upper = torch.cat([centers, bins[..., -1:]], -1)
        lower = torch.cat([bins[..., :1], centers], -1)
        bins = lower + (upper - lower) * jitter
    else:
        bins = bins.expand(ray_bundle.num_rays, -1)
    s_near = spacing_fn(ray_bundle.nears)
    s_far = spacing_fn(ray_bundle.fars)

    def spacing_to_euclidean_fn(x):
        return spacing_fn_inv(x * s_far + (1 - x) * s_near)

    euclidean_bins = spacing_to_euclidean_fn(bins)  # [R, S+1]
    return ray_bundle.get_ray_samples(
        bin_starts=euclidean_bins[..., :-1, None],
        bin_ends=euclidean_bins[..., 1:, None],
        spacing_starts=bins[..., :-1, None],
        spacing_ends=bins[..., 1:, None],
        spacing_to_euclidean_fn=spacing_to_euclidean_fn,
    )


def power_sampler(ray_bundle: RayBundle, num_samples: int, lambda_: float = -1.0, scaling: float = 0.1,
                  jitter: Optional[torch.Tensor] = None) -> RaySamples:
    """ZipNeRF power-function spacing (NeuRAD: lambda -1, scaling 0.1)."""
    return spaced_sampler(
        ray_bundle,
        num_samples,
        lambda x: power_fn(x * scaling, lambda_),
        lambda x: inv_power_fn(x, lambda_) / scaling,
        jitter,
    )


def lin_disp_piecewise_sampler(ray_bundle: RayBundle, num_samples: int,
                               jitter: Optional[torch.Tensor] = None) -> RaySamples:
    """Half the spacing domain linear in distance up to 1, half linear in disparity beyond
    (nerfacto's initial sampler)."""
    return spaced_sampler(
        ray_bundle,
        num_samples,
        lambda x: torch.where(x < 1, x / 2, 1 - 1 / (2 * x)),
        lambda x: torch.where(x < 0.5, 2 * x, 1 / (2 - 2 * x)),
        jitter,
    )


def pdf_sampler(ray_bundle: RayBundle, ray_samples: RaySamples, weights: torch.Tensor, num_samples: int,
                histogram_padding: float = 0.01, eps: float = 1e-5,
                jitter: Optional[torch.Tensor] = None) -> RaySamples:
    """Resample bins at the mid-quantiles of the padded weight histogram, or at quantiles
    jittered by ``jitter`` ([R, 1] or [R, num_samples + 1] uniforms). No gradient flows
    through the new bins."""
    num_bins = num_samples + 1
    w = weights[..., 0] + histogram_padding  # [R, S]
    w_sum = torch.sum(w, dim=-1, keepdim=True)
    padding = torch.clamp(eps - w_sum, min=0.0)
    w = w + padding / w.shape[-1]
    w_sum = w_sum + padding

    pdf = w / w_sum
    cdf = torch.clamp(torch.cumsum(pdf, dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [R, S+1]

    u = torch.linspace(0.0, 1.0 - 1.0 / num_bins, num_bins, dtype=cdf.dtype, device=cdf.device)
    u = u.expand(*cdf.shape[:-1], num_bins)
    u = (u + jitter / num_bins if jitter is not None else u + 1.0 / (2 * num_bins)).contiguous()

    existing_bins = torch.cat([ray_samples.spacing_starts[..., 0], ray_samples.spacing_ends[..., -1:, 0]], dim=-1)
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, 0, existing_bins.shape[-1] - 1)
    above = torch.clamp(inds, 0, existing_bins.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    bins_g0 = torch.gather(existing_bins, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g1 = torch.gather(existing_bins, -1, above)

    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), nan=0.0), 0, 1)
    bins = (bins_g0 + t * (bins_g1 - bins_g0)).detach()

    euclidean_bins = ray_samples.spacing_to_euclidean_fn(bins)
    return ray_bundle.get_ray_samples(
        bin_starts=euclidean_bins[..., :-1, None],
        bin_ends=euclidean_bins[..., 1:, None],
        spacing_starts=bins[..., :-1, None],
        spacing_ends=bins[..., 1:, None],
        spacing_to_euclidean_fn=ray_samples.spacing_to_euclidean_fn,
    )


def proposal_network_sampler(
    ray_bundle: RayBundle,
    density_fns: Sequence[Callable[[RaySamples], torch.Tensor]],
    num_proposal_samples_per_ray: Tuple[int, ...] = (128, 64),
    num_nerf_samples_per_ray: int = 32,
    initial_sampler: Callable = power_sampler,
    jitter: Optional[Sequence[torch.Tensor]] = None,
    anneal: Optional[float] = None,
) -> Tuple[RaySamples, List[torch.Tensor], List[RaySamples]]:
    """The proposal chain: round i's density_fns[i] weights the samples that
    round i + 1 resamples. ``jitter`` holds one noise tensor per round (see
    ``draw_jitter``), or None for the deterministic chain; ``anneal`` raises
    the weights to that power before each resampling (0 resamples uniformly,
    1 is the plain PDF). Returns the final samples and the per-round proposal
    weights and samples."""
    n_rounds = len(num_proposal_samples_per_ray)
    jitter = list(jitter) if jitter is not None else [None] * (n_rounds + 1)
    weights_list: List[torch.Tensor] = []
    samples_list: List[RaySamples] = []
    ray_samples = initial_sampler(ray_bundle, num_proposal_samples_per_ray[0], jitter=jitter[0])
    for i_level in range(n_rounds):
        weights = ray_samples.get_weights(density_fns[i_level](ray_samples))
        weights_list.append(weights)
        samples_list.append(ray_samples)
        n_next = num_proposal_samples_per_ray[i_level + 1] if i_level + 1 < n_rounds else num_nerf_samples_per_ray
        annealed = weights if anneal is None else weights**anneal
        ray_samples = pdf_sampler(ray_bundle, ray_samples, annealed, n_next, jitter=jitter[i_level + 1])
    return ray_samples, weights_list, samples_list
