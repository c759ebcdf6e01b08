"""Dataparser outputs and the shared steps of the driving-dataset parsers (port
of the JAX package's data/dataparsers/base.py): the containers, the eval
split, recentring the world on the mean sensor position, the scene box, the
synthesized non-return lidar points and zero-based times. Host-side numpy:
dataparsing happens once at startup; only the resulting sensor tables go to
the device."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class SceneBox:
    aabb: np.ndarray  # [2, 3] min/max


@dataclass
class SensorSplit:
    """Frame indices for train/eval of one modality."""

    train: np.ndarray
    eval: np.ndarray


@dataclass
class DataparserOutputs:
    """Everything the sensor tables and the model need (host-side numpy).

    cameras_*: per camera frame; lidar_*: per lidar scan; radar_*: per radar
    scan. Points are sensor-frame arrays (x, y, z, intensity, time, channel)
    for lidar and (x, y, z, ...) for radar ground truth.
    """

    # cameras
    camera_to_worlds: np.ndarray  # [Nc, 3, 4]
    intrinsics: np.ndarray  # [Nc, 4] fx fy cx cy
    image_size: Tuple[int, int]  # (H, W)
    camera_type: np.ndarray  # [Nc]
    distortion_params: Optional[np.ndarray]  # [Nc, 6]
    camera_times: np.ndarray  # [Nc]
    camera_sensor_idxs: np.ndarray  # [Nc]
    images: np.ndarray  # [Nc, H, W, 3] uint8
    masks: Optional[np.ndarray] = None
    camera_velocities: Optional[np.ndarray] = None  # [Nc, 3]
    rolling_shutter_offsets: Optional[np.ndarray] = None  # [Nc, 2]
    rolling_shutter_horizontal: Optional[np.ndarray] = None

    # lidars
    lidar_to_worlds: np.ndarray = None  # [Nl, 3, 4]
    lidar_times: np.ndarray = None  # [Nl]
    lidar_sensor_idxs: np.ndarray = None  # [Nl]
    lidar_points: List[np.ndarray] = field(default_factory=list)  # per scan [Pi, 6]
    lidar_velocities: Optional[np.ndarray] = None  # [Nl, 3]

    # radars
    radar_to_worlds: np.ndarray = None  # [Nr, 3, 4]
    radar_times: np.ndarray = None  # [Nr]
    radar_sensor_idxs: np.ndarray = None  # [Nr]
    radar_points: List[np.ndarray] = field(default_factory=list)  # per scan [Gi, >=3]
    radar_fov: Dict[str, float] = field(default_factory=dict)

    # scene
    scene_box: SceneBox = None
    trajectories: List[dict] = field(default_factory=list)
    duration: float = 10.0
    sensor_idx_to_name: Dict[int, str] = field(default_factory=dict)
    lane_shift_sign: int = 1

    # splits
    camera_split: SensorSplit = None
    lidar_split: SensorSplit = None
    radar_split: SensorSplit = None


def linspaced_split(n: int, eval_fraction: float = 0.125) -> SensorSplit:
    """Evenly spaced eval frames."""
    if n == 0:
        return SensorSplit(train=np.zeros(0, np.int64), eval=np.zeros(0, np.int64))
    n_eval = max(1, int(round(n * eval_fraction)))
    eval_idx = np.unique(np.linspace(0, n - 1, n_eval).round().astype(np.int64))
    train_idx = np.setdiff1d(np.arange(n, dtype=np.int64), eval_idx)
    if len(train_idx) == 0:
        train_idx = eval_idx
    return SensorSplit(train=train_idx, eval=eval_idx)


def recenter_poses(pose_sets: List[np.ndarray]) -> Tuple[List[np.ndarray], np.ndarray]:
    """Shift all poses so the mean sensor position is the origin; returns the shifted sets and the
    centre."""
    all_pos = np.concatenate([p[..., :3, 3].reshape(-1, 3) for p in pose_sets if p is not None and len(p)], axis=0)
    center = all_pos.mean(axis=0)
    shifted = []
    for p in pose_sets:
        if p is None or len(p) == 0:
            shifted.append(p)
            continue
        q = p.copy()
        q[..., :3, 3] -= center
        shifted.append(q)
    return shifted, center


def scene_box_from_poses(pose_sets: List[np.ndarray], padding: float = 40.0) -> SceneBox:
    """AABB around all sensor positions, padded on every side."""
    all_pos = np.concatenate([p[..., :3, 3].reshape(-1, 3) for p in pose_sets if p is not None and len(p)], axis=0)
    return SceneBox(aabb=np.stack([all_pos.min(axis=0) - padding, all_pos.max(axis=0) + padding], axis=0))


def synthesize_missing_points(
    points: np.ndarray,
    azimuth_resolution_deg: float = 0.2,
    dummy_distance: float = 2e3,
    min_returns_per_channel: int = 32,
    skip_channels: Tuple[int, ...] = (),
) -> np.ndarray:
    """Non-return lidar points on the sensor's scan grid.

    A rotating lidar misses returns on the sky and on absorbing surfaces; those rays still carry
    carving signal, so a far point (``dummy_distance``) is added wherever an (elevation channel,
    azimuth bin) cell has no return. A channel's elevation is the median of its returns'.

    points: [N, 6] (x, y, z, intensity, time, channel) in the sensor frame. Returns [N + M, 6], the
    M synthesized points appended with intensity 0 and the channel's median time."""
    if len(points) == 0:
        return points
    channels = points[:, 5].astype(np.int64)
    az = np.arctan2(points[:, 1], points[:, 0])
    el = np.arcsin(np.clip(points[:, 2] / np.linalg.norm(points[:, :3], axis=1).clip(1e-6), -1, 1))

    az_res = np.deg2rad(azimuth_resolution_deg)
    n_bins = int(np.ceil(2 * np.pi / az_res))
    az_bin = ((az + np.pi) / az_res).astype(np.int64) % n_bins

    new_points = []
    for ch in np.unique(channels):
        if ch in skip_channels:
            continue
        m = channels == ch
        if m.sum() < min_returns_per_channel:
            continue
        ch_el = float(np.median(el[m]))
        have = np.zeros(n_bins, bool)
        have[az_bin[m]] = True
        missing_bins = np.nonzero(~have)[0]
        if len(missing_bins) == 0:
            continue
        miss_az = missing_bins * az_res - np.pi + az_res / 2
        d = np.stack([np.cos(ch_el) * np.cos(miss_az), np.cos(ch_el) * np.sin(miss_az),
                      np.full(len(miss_az), np.sin(ch_el))], axis=1)
        t_med = float(np.median(points[m, 4]))
        pts = np.concatenate([d * dummy_distance, np.zeros((len(d), 1)), np.full((len(d), 1), t_med),
                              np.full((len(d), 1), ch)], axis=1)
        new_points.append(pts.astype(points.dtype))
    if not new_points:
        return points
    return np.concatenate([points] + new_points, axis=0)


def zero_base_times(time_sets: List[np.ndarray], trajectories: List[dict]) -> Tuple[List[np.ndarray], float]:
    """Shift every timestamp (the trajectories' in place) so the earliest is 0; returns the shifted
    sets and the scene duration (the latest shifted time)."""
    t0 = min(float(t.min()) for t in time_sets if t is not None and len(t))
    out = [None if t is None else t - t0 for t in time_sets]
    for traj in trajectories:
        traj["timestamps"] = np.asarray(traj["timestamps"], np.float64) - t0
    t_max = max(float(t.max()) for t in out if t is not None and len(t))
    return out, float(t_max)
