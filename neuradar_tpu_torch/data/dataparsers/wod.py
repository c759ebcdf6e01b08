"""Waymo Open Dataset (WOD) dataparser, camera and lidar with a horizontal rolling shutter (port of
the JAX package's data/dataparsers/wod.py).

A segment's TFRecord frames: the configured camera (its image, pose ego @ extrinsic turned from
WOD's camera axes to OpenCV's, its velocity and its readout window; WOD cameras read out column by
column, LEFT_TO_RIGHT (2) or RIGHT_TO_LEFT (4), the latter with the offsets reversed), the TOP
lidar's range image as points in the ego frame (intensity min-max normalised), and the laser labels
of vehicles and pedestrians seen in two frames or more, each box yawed -90 degrees so that its x is
the width, with dims (w, l, h).

It needs ``waymo-open-dataset`` and ``tensorflow``, imported when the parser runs.
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

ALLOWED_TYPES = {1}  # TYPE_VEHICLE
DEFORMABLE_TYPES = {2}  # TYPE_PEDESTRIAN
CAMERA_NAMES = ("UNKNOWN", "FRONT", "FRONT_LEFT", "FRONT_RIGHT", "SIDE_LEFT", "SIDE_RIGHT")
# rolling_shutter_direction of the column readouts
LEFT_TO_RIGHT, RIGHT_TO_LEFT = 2, 4

# -90 degrees of yaw: WOD's box frame (x along the length) -> the box frame of every parser (x across)
_ROT_MINUS_90 = np.eye(4)
_ROT_MINUS_90[:3, :3] = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
# WOD's camera frame (x forward, y left, z up) -> OpenCV's
_WOD_CAM_TO_OPENCV = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float64)


@dataclass
class WodDataParserConfig:
    sequence: str = ""  # tfrecord path or segment name
    data: str = "data/wod"
    cameras: Tuple[str, ...] = ("FRONT",)
    eval_fraction: float = 0.125

    def setup(self) -> "WodDataParser":
        return WodDataParser(self)


class WodDataParser:
    def __init__(self, config: WodDataParserConfig):
        self.config = config

    def get_dataparser_outputs(self) -> DataparserOutputs:
        try:
            import tensorflow as tf
            from waymo_open_dataset import dataset_pb2
            from waymo_open_dataset.utils import frame_utils
        except ImportError as e:
            raise ImportError(
                "waymo-open-dataset + tensorflow are required for WodDataParser. "
                "Use the 'neuradar-synthetic' method for dataset-free runs."
            ) from e

        cfg = self.config
        record = Path(cfg.data) / cfg.sequence
        if not record.exists():
            raise FileNotFoundError(f"WOD tfrecord not found at {record}")

        c2ws, intr, images, cam_times, vels, rs_offsets, rs_horiz = [], [], [], [], [], [], []
        l2ws, lidar_points, lidar_times = [], [], []
        by_track: dict = {}
        want_cam = CAMERA_NAMES.index(cfg.cameras[0])
        for data in tf.data.TFRecordDataset(str(record), compression_type=""):
            frame = dataset_pb2.Frame()
            frame.ParseFromString(bytes(data.numpy()))
            ego = np.asarray(frame.pose.transform).reshape(4, 4)
            t_frame = frame.timestamp_micros / 1e6

            for img in frame.images:
                if img.name != want_cam:
                    continue
                calib = next(c for c in frame.context.camera_calibrations if c.name == img.name)
                extr = np.asarray(calib.extrinsic.transform).reshape(4, 4)
                c2w = (ego @ extr @ np.linalg.inv(_WOD_CAM_TO_OPENCV))[:3, :4].copy()
                c2w[:3, :3] = c2w[:3, :3] @ OPENCV_TO_NERF
                c2ws.append(c2w)
                f = calib.intrinsic
                intr.append([f[0], f[1], f[2], f[3]])
                images.append(np.asarray(tf.io.decode_jpeg(img.image)))
                cam_times.append(t_frame)
                vels.append([img.velocity.v_x, img.velocity.v_y, img.velocity.v_z])
                readout = (getattr(img, "camera_readout_done_time", t_frame)
                           - getattr(img, "camera_trigger_time", t_frame))
                rs_dir = getattr(calib, "rolling_shutter_direction", 0)
                half = abs(readout) / 2
                rs_offsets.append([half, -half] if rs_dir == RIGHT_TO_LEFT else [-half, half])
                rs_horiz.append(rs_dir in (LEFT_TO_RIGHT, RIGHT_TO_LEFT))

            range_images, camera_projections, _, range_image_top_pose = (
                frame_utils.parse_range_image_and_camera_projection(frame))
            points, _ = frame_utils.convert_range_image_to_point_cloud(
                frame, range_images, camera_projections, range_image_top_pose, keep_polar_features=True)
            pts_ego = points[0]  # the TOP lidar, in the ego frame
            if pts_ego.shape[1] >= 6:  # the polar features first: range, intensity, elongation, x, y, z
                xyz = pts_ego[:, 3:6]
                raw = pts_ego[:, 1:2]
                lo, hi = raw.min(), raw.max()
                intensity = (raw - lo) / max(hi - lo, 1e-6)
            else:  # an API without polar features
                xyz = pts_ego[:, :3]
                intensity = np.zeros((len(pts_ego), 1), np.float32)
            l2ws.append(ego[:3, :4])
            lidar_points.append(np.concatenate([xyz, intensity, np.zeros((len(pts_ego), 2), np.float32)],
                                               axis=1).astype(np.float32))
            lidar_times.append(t_frame)

            for label in frame.laser_labels:
                if label.type not in ALLOWED_TYPES | DEFORMABLE_TYPES:
                    continue
                b = label.box
                c, s = np.cos(b.heading), np.sin(b.heading)
                pose = np.eye(4)
                pose[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
                pose[:3, 3] = [b.center_x, b.center_y, b.center_z]
                rec = by_track.setdefault(label.id, {"ts": [], "poses": [], "type": label.type,
                                                     "dims": [b.width, b.length, b.height]})
                rec["ts"].append(t_frame)
                rec["poses"].append((ego @ pose @ _ROT_MINUS_90).astype(np.float32))

        trajectories = [dict(timestamps=np.asarray(r["ts"]), poses=np.stack(r["poses"]),
                             dims=np.asarray(r["dims"], np.float32), symmetric=r["type"] in ALLOWED_TYPES,
                             deformable=r["type"] in DEFORMABLE_TYPES)
                        for r in by_track.values() if len(r["ts"]) >= 2]
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
            camera_velocities=np.asarray(vels, np.float32),
            rolling_shutter_offsets=np.asarray(rs_offsets, np.float32),
            rolling_shutter_horizontal=np.asarray(rs_horiz, bool),
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
            sensor_idx_to_name={0: cfg.cameras[0], 1: "lidar_top"},
            camera_split=linspaced_split(n, cfg.eval_fraction),
            lidar_split=linspaced_split(len(l2ws), cfg.eval_fraction),
            radar_split=linspaced_split(0),
        )
