"""Radar requests: one client in a closed loop, each request ``ADNeuRadarPipeline.render_radar`` of
one of the scene's radar scans, ending with its multi-Bernoulli output [rays, 7] on the host. The
scans are asked for in rounds, each round every scan once in an order drawn from the seed, so every
seed asks for the same scans as often, in another order; the first round warms them all up.

Compared (``harness/compare.py``): ``radar_gap``, the existence and variance columns, over the
sampled requests.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from harness import compare, roofline
from harness.runner import Serving
from reference.nrref.models.neuradar import SegmentLayout

RATE_METRIC = "render_rays_per_s"


def requests(traffic: Dict, scene, seed: int, count: int) -> List[int]:
    """The first ``count`` scans asked for under ``seed``."""
    rng, n = np.random.RandomState(seed), len(scene.radar_to_worlds)
    return [int(s) for s in np.concatenate([rng.permutation(n) for _ in range(-(-count // n))])[:count]]


def serving(pipeline, traffic: Dict, cfg, port) -> Serving:
    rays = int(pipeline.tables.radars.rays_per_scan)
    return Serving(rays=rays, unit_flops=roofline.radar_request_flops(cfg, rays),
                   layout=SegmentLayout(num_radar_scans=1, rays_per_scan=rays),
                   serve=lambda scan: port.render_radar(pipeline, scan),
                   reference=lambda ref, scan: ref.render_radar(scan))


def numbers(answers: List[np.ndarray], refs: List[np.ndarray]) -> Dict[str, float]:
    return {"radar_gap": max(compare.radar_gap(a, r) for a, r in zip(answers, refs))}
