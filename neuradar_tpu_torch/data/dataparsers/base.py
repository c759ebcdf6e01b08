"""Dataparser outputs (port of the JAX package's data/dataparsers/base.py, the
containers and the split helper). Host-side numpy: dataparsing happens once at
startup; only the resulting sensor tables go to the device."""

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
