"""PandaSet dataparser, camera and lidar with a rolling shutter (port of the JAX package's
data/dataparsers/pandaset.py).

A sequence directory: ``camera/<name>/`` (NN.jpg, poses.json, intrinsics.json, timestamps.json),
``lidar/`` (NN.pkl[.gz] data frames of world points with x, y, z and, where present, intensity i,
time t and laser d; poses.json, timestamps.json) and ``annotations/cuboids/`` (NN.pkl[.gz]). The
camera reads out top to bottom over ROLLING_SHUTTER_DURATION; its velocities are the pose
differences' gradient over time. Lidar points are moved into the sensor's frame. The actors are the
cuboids of the allowed and deformable labels seen in two frames or more, yawed about z.

PIL and pandas are imported when the parser runs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import numpy as np

from neuradar_tpu_torch.cameras.cameras import CameraType
from neuradar_tpu_torch.data.dataparsers.base import (
    NO_RADAR_FOV,
    DataparserOutputs,
    linspaced_split,
    recenter_poses,
    scene_box_from_poses,
    zero_base_times,
)
from neuradar_tpu_torch.data.dataparsers.zod import OPENCV_TO_NERF

ALLOWED_CATEGORIES = {"Car", "Pickup Truck", "Medium-sized Truck", "Semi-truck", "Bus",
                      "Motorcycle", "Bicycle", "Other Vehicle - Construction Vehicle"}
DEFORMABLE_CATEGORIES = {"Pedestrian", "Pedestrian with Object"}
ROLLING_SHUTTER_DURATION = 0.05  # seconds, top to bottom


@dataclass
class PandasetDataParserConfig:
    sequence: str = "001"
    data: str = "data/pandaset"
    cameras: Tuple[str, ...] = ("front_camera",)
    eval_fraction: float = 0.125

    def setup(self) -> "PandasetDataParser":
        return PandasetDataParser(self)


def _frame_file(directory: Path, i: int) -> Path:
    """A frame's pickle, gzipped or not."""
    f = directory / f"{i:02d}.pkl.gz"
    return f if f.exists() else directory / f"{i:02d}.pkl"


class PandasetDataParser:
    def __init__(self, config: PandasetDataParserConfig):
        self.config = config

    def get_dataparser_outputs(self) -> DataparserOutputs:
        import PIL.Image

        cfg = self.config
        seq_dir = Path(cfg.data) / cfg.sequence
        if not seq_dir.exists():
            raise FileNotFoundError(
                f"PandaSet sequence not found at {seq_dir}. "
                "Use the 'neuradar-synthetic' method for dataset-free runs."
            )

        cam_name = cfg.cameras[0]
        cam_dir = seq_dir / "camera" / cam_name
        poses_j = json.loads((cam_dir / "poses.json").read_text())
        intr_j = json.loads((cam_dir / "intrinsics.json").read_text())
        times_j = json.loads((cam_dir / "timestamps.json").read_text())
        c2ws, images, intr, cam_times = [], [], [], []
        for i, pose in enumerate(poses_j):
            img_path = cam_dir / f"{i:02d}.jpg"
            if not img_path.exists():
                continue
            m = _pose_dict_to_mat(pose)
            m[:3, :3] = m[:3, :3] @ OPENCV_TO_NERF
            c2ws.append(m[:3, :4])
            images.append(np.asarray(PIL.Image.open(img_path)))
            intr.append([intr_j["fx"], intr_j["fy"], intr_j["cx"], intr_j["cy"]])
            cam_times.append(times_j[i])
        images = np.stack(images)
        c2ws = np.stack(c2ws).astype(np.float32)
        cam_times = np.asarray(cam_times)

        # the rolling shutter: velocities from the pose differences, the readout centred on the frame time
        vel = np.gradient(c2ws[:, :3, 3], cam_times, axis=0)
        rs_offsets = np.tile(np.asarray([[-ROLLING_SHUTTER_DURATION / 2, ROLLING_SHUTTER_DURATION / 2]], np.float32),
                             (len(c2ws), 1))

        import pandas as pd

        lid_dir = seq_dir / "lidar"
        lposes = json.loads((lid_dir / "poses.json").read_text())
        ltimes = json.loads((lid_dir / "timestamps.json").read_text())
        l2ws, lidar_points, lidar_times = [], [], []
        for i, pose in enumerate(lposes):
            f = _frame_file(lid_dir, i)
            if not f.exists():
                continue
            df = pd.read_pickle(f)
            m = _pose_dict_to_mat(pose)
            pts_world = df[["x", "y", "z"]].to_numpy()
            pts = (np.concatenate([pts_world, np.ones((len(pts_world), 1))], 1) @ np.linalg.inv(m).T)[:, :3]
            inten = (df["i"].to_numpy() / 255.0)[:, None] if "i" in df else np.zeros((len(pts), 1))
            t_rel = (df["t"].to_numpy() - ltimes[i])[:, None] if "t" in df else np.zeros((len(pts), 1))
            ch = df["d"].to_numpy()[:, None] if "d" in df else np.zeros((len(pts), 1))
            lidar_points.append(np.concatenate([pts, inten, t_rel, ch], 1).astype(np.float32))
            l2ws.append(m[:3, :4])
            lidar_times.append(ltimes[i])
        l2ws = np.stack(l2ws).astype(np.float32)

        trajectories = _trajectories(seq_dir, pd)
        (cam_times, lidar_times), duration = zero_base_times([cam_times, np.asarray(lidar_times)], trajectories)
        pose_sets, center = recenter_poses([c2ws, l2ws])
        c2ws, l2ws = pose_sets
        for traj in trajectories:
            traj["poses"][:, :3, 3] -= center

        n = len(c2ws)
        return DataparserOutputs(
            camera_to_worlds=c2ws,
            intrinsics=np.asarray(intr, np.float32),
            image_size=(images.shape[1], images.shape[2]),
            camera_type=np.full(n, int(CameraType.PERSPECTIVE)),
            distortion_params=None,
            camera_times=cam_times.astype(np.float32),
            camera_sensor_idxs=np.zeros(n, np.int64),
            images=images,
            camera_velocities=vel.astype(np.float32),
            rolling_shutter_offsets=rs_offsets,
            lidar_to_worlds=l2ws,
            lidar_times=lidar_times.astype(np.float32),
            lidar_sensor_idxs=np.ones(len(l2ws), np.int64),
            lidar_points=lidar_points,
            radar_to_worlds=np.zeros((0, 3, 4), np.float32),
            radar_times=np.zeros(0, np.float32),
            radar_sensor_idxs=np.zeros(0, np.int64),
            radar_points=[],
            radar_fov=dict(NO_RADAR_FOV),
            scene_box=scene_box_from_poses(pose_sets),
            trajectories=trajectories,
            duration=duration,
            sensor_idx_to_name={0: cam_name, 1: "pandar64"},
            camera_split=linspaced_split(n, cfg.eval_fraction),
            lidar_split=linspaced_split(len(l2ws), cfg.eval_fraction),
            radar_split=linspaced_split(0),
        )


def _trajectories(seq_dir: Path, pd) -> list:
    """One trajectory per cuboid uuid of an allowed or deformable label seen in two lidar frames or
    more, timed by the lidar frame; dims (dimensions.y, .x, .z)."""
    cub_dir = seq_dir / "annotations" / "cuboids"
    if not cub_dir.exists():
        return []
    by_uuid: dict = {}
    ltimes = json.loads((seq_dir / "lidar" / "timestamps.json").read_text())
    for i in range(len(ltimes)):
        f = _frame_file(cub_dir, i)
        if not f.exists():
            continue
        for _, row in pd.read_pickle(f).iterrows():
            if row["label"] not in ALLOWED_CATEGORIES | DEFORMABLE_CATEGORIES:
                continue
            c, s = np.cos(row["yaw"]), np.sin(row["yaw"])
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            pose[:3, 3] = [row["position.x"], row["position.y"], row["position.z"]]
            rec = by_uuid.setdefault(row["uuid"], {"ts": [], "poses": [], "label": row["label"],
                                                   "dims": [row["dimensions.x"], row["dimensions.y"],
                                                            row["dimensions.z"]]})
            rec["ts"].append(ltimes[i])
            rec["poses"].append(pose)
    return [dict(timestamps=np.asarray(rec["ts"]), poses=np.stack(rec["poses"]),
                 dims=np.asarray(rec["dims"], np.float32)[[1, 0, 2]], symmetric=rec["label"] in ALLOWED_CATEGORIES,
                 deformable=rec["label"] in DEFORMABLE_CATEGORIES)
            for rec in by_uuid.values() if len(rec["ts"]) >= 2]


def _pose_dict_to_mat(pose: dict) -> np.ndarray:
    """PandaSet's {position: {x, y, z}, heading: {w, x, y, z}} -> 4 x 4."""
    q = pose["heading"]
    w, x, y, z = q["w"], q["x"], q["y"], q["z"]
    m = np.eye(4)
    m[:3, :3] = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    m[:3, 3] = [pose["position"]["x"], pose["position"]["y"], pose["position"]["z"]]
    return m
