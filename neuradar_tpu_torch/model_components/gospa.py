"""GOSPA metric (Rahmathullah et al., Fusion 2017), a host-side eval metric (the port's own copy of
the JAX package's model_components/gospa.py: numpy costs and scipy's Hungarian solver)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def calculate_gospa(
    targets: np.ndarray,
    tracks: np.ndarray,
    c: float = 2.0,
    p: float = 1.0,
    alpha: float = 2.0,
) -> Tuple[float, Dict[int, int], float, float, float]:
    """GOSPA and its localization / missed / false decomposition.

    Args:
        targets: [n_targets, d] ground truth points.
        tracks: [n_tracks, d] predicted points.
        c: cutoff distance; p: order; alpha: cardinality penalty factor.

    Returns:
        (gospa, assignment dict target->track, loc, missed, false).
    """
    if alpha <= 0 or alpha > 2:
        raise ValueError("alpha must be in (0, 2]")
    if c <= 0:
        raise ValueError("c must be positive")
    if p < 1:
        raise ValueError("p must be >= 1")

    targets = np.asarray(targets, np.float64).reshape(-1, targets.shape[-1]) if len(targets) else np.zeros((0, 3))
    tracks = np.asarray(tracks, np.float64).reshape(-1, tracks.shape[-1]) if len(tracks) else np.zeros((0, 3))
    n_t, n_k = len(targets), len(tracks)
    miss_cost = c**p / alpha

    if n_t == 0:
        return (miss_cost * n_k) ** (1 / p), {}, 0.0, 0.0, miss_cost * n_k
    if n_k == 0:
        return (miss_cost * n_t) ** (1 / p), {}, 0.0, miss_cost * n_t, 0.0

    from scipy.optimize import linear_sum_assignment

    dists = np.linalg.norm(targets[:, None, :] - tracks[None, :, :], axis=-1)
    cost = np.minimum(dists**p, alpha * miss_cost)
    rows, cols = linear_sum_assignment(cost)

    assignment = {}
    loc = 0.0
    for ti, ki in zip(rows, cols):
        if cost[ti, ki] < alpha * miss_cost:
            loc += cost[ti, ki]
            assignment[int(ti)] = int(ki)
    n_assigned = len(assignment)
    missed = miss_cost * (n_t - n_assigned)
    false = miss_cost * (n_k - n_assigned)
    gospa = (loc + missed + false) ** (1 / p)
    return float(gospa), assignment, float(loc), float(missed), float(false)
