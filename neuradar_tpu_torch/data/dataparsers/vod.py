"""View-of-Delft (VoD) dataparser (port of the JAX package's data/dataparsers/vod.py).

VoD's KITTI-format tree: the camera (``image_2``), the Velodyne-64 lidar and the 3+1D radar, each
frame's pose chained through the camera's odometry pose (``lidar/training/pose/<frame>.json``,
``odomToCamera``): camera -> world is that pose, lidar -> world is it times the lidar calib's
``Tr_velo_to_cam``, and radar -> world it times the radar calib's ``Tr_velo_to_cam`` (the lidar's
pose where the radar calib or its line is missing). The radar ground truth is each scan's x, y, z.
A sequence is a frame range of ``VOD_SEQUENCES``; times are the frame index at ``FRAME_RATE``.

PIL is imported when the parser runs, so the rest of the port works without it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from neuradar_tpu_torch.cameras.cameras import CameraType
from neuradar_tpu_torch.cameras.radars import VOD_RADAR_FOV
from neuradar_tpu_torch.data.dataparsers.base import (
    DataparserOutputs,
    linspaced_split,
    recenter_poses,
    scene_box_from_poses,
    zero_base_times,
)
from neuradar_tpu_torch.data.dataparsers.zod import OPENCV_TO_NERF

# the frame ranges of the sequences
VOD_SEQUENCES = {
    "00": (0, 540),
    "01": (541, 1060),
    "02": (1061, 1680),
    "03": (1681, 2200),
    "04": (2201, 2920),
}
FRAME_RATE = 10.0


@dataclass
class VodDataParserConfig:
    sequence: str = "00"
    data: str = "data/vod"
    eval_fraction: float = 0.125

    def setup(self) -> "VodDataParser":
        return VodDataParser(self)


def _read_calib(path: Path) -> dict:
    """A KITTI calib file's ``key: numbers`` lines."""
    d = {}
    for line in open(path):
        if ":" in line:
            k, v = line.split(":", 1)
            d[k.strip()] = np.fromstring(v, sep=" ")
    return d


class VodDataParser:
    def __init__(self, config: VodDataParserConfig):
        self.config = config

    def get_dataparser_outputs(self) -> DataparserOutputs:
        cfg = self.config
        root = Path(cfg.data)
        if not root.exists():
            raise FileNotFoundError(
                f"VoD dataset not found at {root}. Use 'neuradar-synthetic' for dataset-free runs."
            )
        lo, hi = VOD_SEQUENCES.get(cfg.sequence, (0, 100))

        import PIL.Image

        pose_dir = root / "lidar" / "training" / "pose"
        img_dir = root / "lidar" / "training" / "image_2"
        lidar_dir = root / "lidar" / "training" / "velodyne"
        radar_dir = root / "radar" / "training" / "velodyne"
        calib_dir = root / "lidar" / "training" / "calib"

        c2ws, l2ws, r2ws, intr, images = [], [], [], [], []
        lidar_points, radar_points, times = [], [], []
        for fi in range(lo, hi + 1):
            pose_file = pose_dir / f"{fi:05d}.json"
            if not pose_file.exists():
                continue
            odom = json.load(open(pose_file))
            key = "odomToCamera" if "odomToCamera" in odom else list(odom)[0]
            cam2odom = np.asarray(odom[key], np.float64).reshape(4, 4)  # the camera's pose in the odom frame
            calib = _read_calib(calib_dir / f"{fi:05d}.txt")
            P2 = calib["P2"].reshape(3, 4)
            l2w = cam2odom @ np.vstack([calib["Tr_velo_to_cam"].reshape(3, 4), [0, 0, 0, 1]])
            r2w = l2w
            radar_calib = root / "radar" / "training" / "calib" / f"{fi:05d}.txt"
            if radar_calib.exists():
                tr = _read_calib(radar_calib).get("Tr_velo_to_cam")  # radar -> camera
                if tr is not None and tr.size == 12:
                    r2w = cam2odom @ np.vstack([tr.reshape(3, 4), [0, 0, 0, 1]])
            c2w = cam2odom[:3, :4].copy()
            c2w[:3, :3] = c2w[:3, :3] @ OPENCV_TO_NERF
            c2ws.append(c2w)
            l2ws.append(l2w[:3, :4])
            r2ws.append(r2w[:3, :4])
            intr.append([P2[0, 0], P2[1, 1], P2[0, 2], P2[1, 2]])
            images.append(np.asarray(PIL.Image.open(img_dir / f"{fi:05d}.jpg")))
            pts = np.fromfile(lidar_dir / f"{fi:05d}.bin", np.float32).reshape(-1, 4)
            lidar_points.append(np.concatenate([pts[:, :3], pts[:, 3:4], np.zeros((len(pts), 2), np.float32)], axis=1))
            radar_points.append(np.fromfile(radar_dir / f"{fi:05d}.bin", np.float32).reshape(-1, 7)[:, :3])
            times.append(fi / FRAME_RATE)

        images = np.stack(images)
        pose_sets = [np.stack(p).astype(np.float32) for p in (c2ws, l2ws, r2ws)]
        trajectories: list = []
        (times,), duration = zero_base_times([np.asarray(times, np.float64)], trajectories)
        pose_sets, _ = recenter_poses(pose_sets)
        c2ws, l2ws, r2ws = pose_sets
        n = len(c2ws)
        return DataparserOutputs(
            camera_to_worlds=c2ws,
            intrinsics=np.asarray(intr, np.float32),
            image_size=(images.shape[1], images.shape[2]),
            camera_type=np.full(n, int(CameraType.PERSPECTIVE)),
            distortion_params=None,
            camera_times=times.astype(np.float32),
            camera_sensor_idxs=np.zeros(n, np.int64),
            images=images,
            lidar_to_worlds=l2ws,
            lidar_times=times.astype(np.float32),
            lidar_sensor_idxs=np.ones(n, np.int64),
            lidar_points=lidar_points,
            radar_to_worlds=r2ws,
            radar_times=times.astype(np.float32),
            radar_sensor_idxs=np.full(n, 2, np.int64),
            radar_points=radar_points,
            radar_fov=dict(VOD_RADAR_FOV),
            scene_box=scene_box_from_poses(pose_sets),
            trajectories=trajectories,
            duration=duration,
            sensor_idx_to_name={0: "camera", 1: "lidar", 2: "radar"},
            camera_split=linspaced_split(n, cfg.eval_fraction),
            lidar_split=linspaced_split(n, cfg.eval_fraction),
            radar_split=linspaced_split(n, cfg.eval_fraction),
        )
