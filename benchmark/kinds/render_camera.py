"""Camera requests: one client in a closed loop, each request the closed-loop server's frame,
``render_pose`` of a scene frame's camera pose shifted sideways (in the ground plane, across the
driving direction) by one of ``lane_shifts_m``, at ``hw`` and at that frame's time, ending with the
uint8 image on the host. The poses are asked for in rounds, each round every pair of a frame and a
shift once in an order drawn from the seed. Every request has the same size.

Compared (``harness/compare.py``): ``image_gap``, over the sampled requests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from harness import compare, roofline
from harness.runner import Serving
from reference.nrref.models.neuradar import SegmentLayout

RATE_METRIC = "render_rays_per_s"


@dataclass
class Pose:
    c2w: np.ndarray
    time_s: float


def _right(outputs, frame: int) -> np.ndarray:
    """The unit sideways direction at a camera frame: the driving direction (the difference of the
    neighbouring camera positions) crossed with +z, in the ground plane."""
    pos = outputs.camera_to_worlds[:, :3, 3].astype(np.float64)
    j0, j1 = (frame - 1, frame) if frame == len(pos) - 1 else (frame, frame + 1)
    drive = pos[j1] - pos[j0]
    drive = drive / max(np.linalg.norm(drive), 1e-9)
    right = np.cross(drive, np.array([0.0, 0.0, 1.0]))
    right[2] = 0.0
    return right / max(np.linalg.norm(right), 1e-9)


def requests(traffic: Dict, scene, seed: int, count: int) -> List[Pose]:
    """The first ``count`` poses asked for under ``seed``."""
    rng, shifts = np.random.RandomState(seed), np.asarray(traffic["lane_shifts_m"], np.float64)
    pairs = [(f, d) for f in range(len(scene.camera_to_worlds)) for d in shifts]
    order = np.concatenate([rng.permutation(len(pairs)) for _ in range(-(-count // len(pairs)))])[:count]
    out = []
    for f, d in (pairs[i] for i in order):
        c2w = scene.camera_to_worlds[f].astype(np.float64).copy()
        c2w[:3, 3] += d * float(scene.lane_shift_sign or 1) * _right(scene, int(f))
        out.append(Pose(c2w=c2w.astype(np.float32), time_s=float(scene.camera_times[f])))
    return out


def serving(pipeline, traffic: Dict, cfg, port) -> Serving:
    u = cfg.rgb_upsample_factor
    H, W = traffic["hw"][0] // u * u, traffic["hw"][1] // u * u
    h, w = H // u, W // u
    return Serving(rays=h * w, unit_flops=roofline.camera_request_flops(cfg, h, w),
                   layout=SegmentLayout(num_cam=h * w, patch_size=(h, w)),
                   serve=lambda pose: port.render_camera(pipeline, pose.c2w, (H, W), pose.time_s),
                   reference=lambda ref, pose: ref.render_pose(pose.c2w, (H, W), pose.time_s))


def numbers(answers: List[np.ndarray], refs: List[np.ndarray]) -> Dict[str, float]:
    return {"image_gap": max(compare.image_gap(a, r) for a, r in zip(answers, refs))}
