"""Per-parameter-group optimizers (port of the JAX package's engine/optimizers.py).

Parameters are split into named groups by their path (hash tables,
trajectories, the RGB CNN, the radar transformer, everything else), and each
group gets its own Adam or AdamW and learning-rate schedule. eps = 1e-15 sits
outside the square root, as in optax. optax's ``add_decayed_weights`` after
``scale_by_adam``, scaled by -lr, is torch's decoupled AdamW:
p -= lr * (adam + wd * p). A parameter whose label has no group is frozen.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from neuradar_tpu_torch.engine.schedulers import ExponentialDecaySchedulerConfig


@dataclass
class AdamOptimizerConfig:
    lr: float = 1e-3
    eps: float = 1e-15
    weight_decay: float = 0.0

    def build(self, params: List[nn.Parameter]) -> torch.optim.Optimizer:
        if self.weight_decay:
            return torch.optim.AdamW(params, lr=self.lr, eps=self.eps, weight_decay=self.weight_decay)
        return torch.optim.Adam(params, lr=self.lr, eps=self.eps)


@dataclass
class AdamWOptimizerConfig(AdamOptimizerConfig):
    weight_decay: float = 1e-2


@dataclass
class OptimizerGroupConfig:
    optimizer: AdamOptimizerConfig
    scheduler: Optional[ExponentialDecaySchedulerConfig] = None

    def schedule(self) -> Callable[[int], float]:
        if self.scheduler is None:
            return lambda step: self.optimizer.lr
        return self.scheduler.build(self.optimizer.lr)


def param_group_label(path: Tuple[str, ...]) -> str:
    """The optimizer group of a parameter path (module names follow the flax tree)."""
    joined = "/".join(str(p) for p in path)
    if "vgg_loss" in joined:
        return "frozen"
    if "hash_table" in joined:
        return "hashgrids"
    if joined.startswith("dynamic_actors"):
        return "trajectory_opt"
    if joined.startswith("rgb_decoder"):
        return "cnn"
    if joined.startswith("radar_decoder"):
        return "transformer"
    if joined.startswith("camera_optimizer"):
        return "camera_opt"
    return "fields"


def default_optimizer_groups(max_steps: int = 20001) -> Dict[str, OptimizerGroupConfig]:
    """The neuradar method's optimizer table."""
    exp = ExponentialDecaySchedulerConfig
    return {
        "trajectory_opt": OptimizerGroupConfig(
            AdamOptimizerConfig(lr=1e-3, eps=1e-15),
            exp(lr_final=1e-4, max_steps=max_steps, warmup_steps=2500),
        ),
        "cnn": OptimizerGroupConfig(
            AdamWOptimizerConfig(lr=1e-3, eps=1e-15, weight_decay=1e-6),
            exp(lr_final=1e-4, max_steps=max_steps, warmup_steps=2500),
        ),
        "fields": OptimizerGroupConfig(
            AdamWOptimizerConfig(lr=1e-2, eps=1e-15, weight_decay=1e-7),
            exp(lr_final=1e-3, max_steps=max_steps, warmup_steps=500),
        ),
        "hashgrids": OptimizerGroupConfig(
            AdamOptimizerConfig(lr=1e-2, eps=1e-15),
            exp(lr_final=1e-3, max_steps=max_steps, warmup_steps=500),
        ),
        "camera_opt": OptimizerGroupConfig(
            AdamOptimizerConfig(lr=1e-4, eps=1e-15),
            exp(lr_final=1e-5, max_steps=max_steps, warmup_steps=2500),
        ),
        "transformer": OptimizerGroupConfig(
            AdamWOptimizerConfig(lr=1e-3, eps=1e-15, weight_decay=1e-7),
            exp(lr_final=1e-7, max_steps=max(max_steps // 2, 1), warmup_steps=5000),
        ),
    }


class GroupedOptimizer:
    """One torch optimizer and one schedule per parameter group; labels without a group are
    frozen (their parameters stop requiring gradients). ``label`` maps a parameter's path to its
    group (neuradar's table by default)."""

    def __init__(self, model: nn.Module, groups: Dict[str, OptimizerGroupConfig],
                 label: Callable[[Tuple[str, ...]], str] = param_group_label):
        members: Dict[str, List[nn.Parameter]] = {}
        self.labels: Dict[str, str] = {}
        for name, p in model.named_parameters():
            group = label(tuple(name.split(".")))
            if group not in groups:
                group = "frozen"
                p.requires_grad_(False)
            self.labels[name] = group
            if group != "frozen":
                members.setdefault(group, []).append(p)
        self.optimizers = {g: groups[g].optimizer.build(ps) for g, ps in members.items()}
        self.schedules = {g: groups[g].schedule() for g in members}

    def zero_grad(self) -> None:
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=True)

    def step(self, step: int) -> None:
        """Apply update number ``step`` (from 0): each group's rate is its schedule at ``step``,
        as optax's scale_by_learning_rate reads its count before incrementing it."""
        for g, opt in self.optimizers.items():
            for pg in opt.param_groups:
                pg["lr"] = self.schedules[g](step)
            opt.step()
