"""Argoverse 2 (sensor dataset) dataparser, camera and lidar (port of the JAX package's
data/dataparsers/argoverse2.py).

A log directory: the ring camera's ``<ns>.jpg`` frames and the lidar's ``<ns>.feather`` sweeps, each
posed at the nearest ego pose (``read_city_SE3_ego``), the camera through its extrinsic
(``calibration/egovehicle_SE3_sensor.feather``) with its intrinsics
(``calibration/intrinsics.feather``); lidar points carry intensity / 255, ``offset_ns`` in seconds
and ``laser_number``. The actors are ``annotations.feather``'s tracks of the allowed and deformable
categories seen twice or more, sized (l, w, h) as AV2 stores them.

It needs the ``av2`` devkit, pyarrow and PIL, imported when the parser runs.
"""

from __future__ import annotations

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

ALLOWED = {"REGULAR_VEHICLE", "LARGE_VEHICLE", "BUS", "TRUCK", "BOX_TRUCK", "TRUCK_CAB",
           "SCHOOL_BUS", "ARTICULATED_BUS", "MOTORCYCLE", "BICYCLE", "VEHICULAR_TRAILER"}
DEFORMABLE = {"PEDESTRIAN", "OFFICIAL_SIGNALER"}


@dataclass
class Argoverse2DataParserConfig:
    sequence: str = ""
    data: str = "data/av2"
    cameras: Tuple[str, ...] = ("ring_front_center",)
    eval_fraction: float = 0.125

    def setup(self) -> "Argoverse2DataParser":
        return Argoverse2DataParser(self)


class Argoverse2DataParser:
    def __init__(self, config: Argoverse2DataParserConfig):
        self.config = config

    def get_dataparser_outputs(self) -> DataparserOutputs:
        try:
            from av2.datasets.sensor.sensor_dataloader import SensorDataloader  # noqa: F401
            from av2.geometry.geometry import quat_to_mat
            from av2.utils.io import read_city_SE3_ego
        except ImportError as e:
            raise ImportError(
                "The 'av2' devkit is required for Argoverse2DataParser. "
                "Use the 'neuradar-synthetic' method for dataset-free runs."
            ) from e
        import PIL.Image
        import pyarrow.feather as feather

        cfg = self.config
        log_dir = Path(cfg.data) / cfg.sequence
        if not log_dir.exists():
            raise FileNotFoundError(f"AV2 log not found at {log_dir}")

        ego_poses = read_city_SE3_ego(log_dir)  # {timestamp ns: SE3}

        def nearest_ego(ts: int) -> np.ndarray:
            return min(ego_poses.items(), key=lambda kv: abs(kv[0] - ts))[1].transform_matrix

        cam_name = cfg.cameras[0]
        extr = feather.read_feather(log_dir / "calibration" / "egovehicle_SE3_sensor.feather")
        row = extr[extr["sensor_name"] == cam_name].iloc[0]
        cam_ext = np.eye(4)
        cam_ext[:3, :3] = quat_to_mat(np.array([row["qw"], row["qx"], row["qy"], row["qz"]]))
        cam_ext[:3, 3] = [row["tx_m"], row["ty_m"], row["tz_m"]]
        intr_df = feather.read_feather(log_dir / "calibration" / "intrinsics.feather")
        cam_row = intr_df[intr_df["sensor_name"] == cam_name].iloc[0]

        c2ws, intr, images, cam_times = [], [], [], []
        for img_path in sorted((log_dir / "sensors" / "cameras" / cam_name).glob("*.jpg")):
            ts = int(img_path.stem)
            c2w = (nearest_ego(ts) @ cam_ext)[:3, :4].copy()
            c2w[:3, :3] = c2w[:3, :3] @ OPENCV_TO_NERF
            c2ws.append(c2w)
            intr.append([cam_row["fx_px"], cam_row["fy_px"], cam_row["cx_px"], cam_row["cy_px"]])
            images.append(np.asarray(PIL.Image.open(img_path)))
            cam_times.append(ts / 1e9)

        l2ws, lidar_points, lidar_times = [], [], []
        for pc_path in sorted((log_dir / "sensors" / "lidar").glob("*.feather")):
            ts = int(pc_path.stem)
            df = feather.read_feather(pc_path)
            l2ws.append(nearest_ego(ts)[:3, :4])
            offset_s = df["offset_ns"].to_numpy() / 1e9 if "offset_ns" in df else np.zeros(len(df))
            pts = np.stack([df["x"], df["y"], df["z"], df["intensity"].to_numpy() / 255.0, offset_s,
                            df["laser_number"] if "laser_number" in df else np.zeros(len(df))], axis=1)
            lidar_points.append(pts.astype(np.float32))
            lidar_times.append(ts / 1e9)

        trajectories = _trajectories(log_dir, feather, quat_to_mat)
        images = np.stack(images)
        c2ws = np.stack(c2ws).astype(np.float32)
        l2ws = np.stack(l2ws).astype(np.float32)
        (cam_times, lidar_times), duration = zero_base_times([np.asarray(cam_times), np.asarray(lidar_times)],
                                                             trajectories)
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
            sensor_idx_to_name={0: cam_name, 1: "lidar"},
            camera_split=linspaced_split(n, cfg.eval_fraction),
            lidar_split=linspaced_split(len(l2ws), cfg.eval_fraction),
            radar_split=linspaced_split(0),
        )


def _trajectories(log_dir: Path, feather, quat_to_mat) -> list:
    """One trajectory per track uuid of an allowed or deformable category seen twice or more."""
    ann_path = log_dir / "annotations.feather"
    if not ann_path.exists():
        return []
    by_uuid: dict = {}
    for _, row in feather.read_feather(ann_path).iterrows():
        if row["category"] not in ALLOWED | DEFORMABLE:
            continue
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = quat_to_mat(np.array([row["qw"], row["qx"], row["qy"], row["qz"]]))
        pose[:3, 3] = [row["tx_m"], row["ty_m"], row["tz_m"]]
        rec = by_uuid.setdefault(row["track_uuid"], {"ts": [], "poses": [], "cat": row["category"],
                                                     "dims": [row["length_m"], row["width_m"], row["height_m"]]})
        rec["ts"].append(row["timestamp_ns"] / 1e9)
        rec["poses"].append(pose)
    return [dict(timestamps=np.asarray(rec["ts"]), poses=np.stack(rec["poses"]),
                 dims=np.asarray(rec["dims"], np.float32), symmetric=rec["cat"] in ALLOWED,
                 deformable=rec["cat"] in DEFORMABLE)
            for rec in by_uuid.values() if len(rec["ts"]) >= 2]
