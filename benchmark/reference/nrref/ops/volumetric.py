"""Volume compositing with sky redistribution (kernel K1), plain PyTorch only.

The formulation of the port's ``composite_sky_reference`` (cumprod weights, the leftover mass moved
onto the last, sky, sample, the feature sum); its backward is autograd through it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from reference.nrref.cameras.rays import render_weights_from_alpha


def composite_sky(alpha: torch.Tensor, feats: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """alpha [R, S], feats [R, S, C] -> (w_sky [R, S], features [R, C], accum [R, 1])."""
    weights = render_weights_from_alpha(alpha)
    accum = weights.sum(dim=-1, keepdim=True)
    w_sky = torch.cat([weights[..., :-1], weights[..., -1:] + 1 - accum], dim=-1)
    features = (w_sky[..., None] * feats).sum(dim=-2)
    return w_sky, features, accum
