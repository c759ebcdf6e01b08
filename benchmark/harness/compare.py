"""The numbers that decide ``correct``: each a gap between what the timed path produced and what
the plain reference computes from the same inputs, compared with its limit (``limits/<cell>.json``).

Training (``Trainer.train_step``'s first three steps): ``loss_gap``, the largest relative gap of a
step's total loss; ``grad_gap``, the worst leaf's gap between the norms of the first gradient (the
program's worked out from its Adam state after one step, exp_avg / (1 - beta1)), against the
reference's norm of that leaf or of the median leaf, whichever is larger; ``change_gap``, the same of
the parameters' change over the three steps, leaving out the leaves whose reference gradient is under
a thousandth of the median leaf's (they move by round-off alone under Adam).

Radar requests: ``radar_gap``, over the sampled requests, the largest relative L2 gap of the
[rays, 7] output's existence-probability and variance columns. The mean position follows the NeRF
depth, and the proposal sampler's resampling moves rays' samples across bin edges when a bf16
product rounds otherwise (cuBLAS picks its reduction by alignment). On the card the sound program's
position gaps came within three times of the precision control's smallest, by the columns' L2 gap,
by the median ray's gap and by the gap weighted by existence alike: no limit holds between them, so
the positions are not compared.
Camera requests: ``image_gap``, over the sampled requests, the largest mean absolute gap of the
uint8 images, in levels.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

CHANGE_FLOOR = 1e-3


def worst_leaf_gap(program: Dict[str, float], reference: Dict[str, float],
                   leaves: Iterable[str] = None) -> Tuple[float, str]:
    """(gap, leaf): max over leaves of |p - r| / max(r, median r)."""
    names = list(leaves if leaves is not None else reference)
    med = float(np.median([reference[n] for n in names]))
    gaps = {n: abs(program[n] - reference[n]) / max(reference[n], med, 1e-30) for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient norm is at least CHANGE_FLOOR of the median leaf's."""
    med = float(np.median(list(ref_grad.values())))
    return [n for n, g in ref_grad.items() if g >= CHANGE_FLOOR * med]


def loss_gap(program: List[float], reference: List[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program, reference))


# existence probability and the three variances of a [rays, 7] multi-Bernoulli output; the mean
# position (columns 1-3) is the NeRF depth's, whose proposal resampling jumps with rounding
RADAR_COLUMNS = (0, 4, 5, 6)


def column_gaps(program: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Each column's relative L2 gap of two [rays, 7] outputs (inf where the program's is not
    finite or not of the reference's shape)."""
    if program.shape != reference.shape or not np.all(np.isfinite(program)):
        return np.full(reference.shape[-1], np.inf)
    p, r = program.astype(np.float64), reference.astype(np.float64)
    return np.linalg.norm(p - r, axis=0) / np.maximum(np.linalg.norm(r, axis=0), 1e-30)


def radar_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """The largest relative L2 gap of the existence and variance columns."""
    return float(column_gaps(program, reference)[list(RADAR_COLUMNS)].max())


def image_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """Mean absolute gap of two uint8 images, in levels (inf where the shapes differ)."""
    if program.shape != reference.shape:
        return float("inf")
    return float(np.mean(np.abs(program.astype(np.int16) - reference.astype(np.int16))))
