"""Learning-rate schedules (port of the JAX package's engine/schedulers.py:
``ExponentialDecaySchedulerConfig``)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class ExponentialDecaySchedulerConfig:
    """Cosine (or linear) warmup from lr_pre_warmup to the initial rate, then log-linear
    decay to lr_final at max_steps."""

    lr_pre_warmup: float = 1e-8
    lr_final: Optional[float] = None
    warmup_steps: int = 0
    max_steps: int = 100000
    ramp: str = "cosine"  # cosine | linear

    def build(self, lr_init: float) -> Callable[[int], float]:
        lr_final = self.lr_final if self.lr_final is not None else lr_init
        pre = self.lr_pre_warmup
        warm = self.warmup_steps
        span = max(self.max_steps - warm, 1)

        def schedule(step: int) -> float:
            if step < warm:
                frac = min(max(step / warm, 0.0), 1.0)
                ramp = math.sin(0.5 * math.pi * frac) if self.ramp == "cosine" else frac
                return pre + (lr_init - pre) * ramp
            t = min(max((step - warm) / span, 0.0), 1.0)
            return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)

        return schedule
