"""The port's one source of training randomness.

Every random number of a train step (sampling jitter, actor flips, dropout
masks, the attention dropout seed) is drawn here from an explicit
``torch.Generator`` that the caller passes; nothing uses torch's global
generator. The numbers are drawn on the generator's device and moved to the
device that uses them, so a CPU generator gives the same numbers to a model on
the CPU and to one on the card.
"""

from __future__ import annotations

from typing import Sequence

import torch


def uniform(generator: torch.Generator, shape: Sequence[int], device) -> torch.Tensor:
    """U[0, 1) float32 of ``shape`` on ``device``."""
    return torch.rand(tuple(shape), generator=generator, device=generator.device).to(device)


def seed32(generator: torch.Generator) -> int:
    """A seed in [0, 2^31 - 1) for a counter-based hash (one host sync on a device generator)."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator, device=generator.device).item())
