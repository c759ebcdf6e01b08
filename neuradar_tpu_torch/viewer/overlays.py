"""Projection of world points into a free-pose camera (port of ``project_points`` of the JAX
package's viewer/overlays.py; the viewer's drawing helpers are not ported)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def project_points(c2w: np.ndarray, fx: float, fy: float, cx: float, cy: float,
                   pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """World points [N, 3] -> pixel uv [N, 2] and camera depth [N] (float64; the camera looks down
    -z with y up)."""
    R = np.asarray(c2w[:3, :3], np.float64)
    t = np.asarray(c2w[:3, 3], np.float64)
    local = (np.asarray(pts, np.float64) - t) @ R  # world -> camera
    z = -local[:, 2]
    safe = np.where(np.abs(z) < 1e-6, 1e-6, z)
    u = cx + fx * local[:, 0] / safe
    v = cy - fy * local[:, 1] / safe
    return np.stack([u, v], axis=1), z
