"""KITTI MOT (tracking) dataparser, camera and lidar (port of the JAX package's
data/dataparsers/kittimot.py).

The ``training`` tree of a sequence: ``image_02``, ``velodyne``, ``calib`` (P2 and the
velodyne -> camera ``Tr_velo_cam``), ``oxts`` (the IMU/GPS poses, Mercator-projected and made
relative to the first) and ``label_02`` (tracklets). The lidar sits at the IMU pose, the camera
at it times the inverse calib; frames run until an image or a sweep is missing, and are cropped to
their smallest size. The actors are the tracks of the allowed and deformable types seen in two
frames or more, chained object -> camera -> velodyne -> world.

PIL is imported when the parser runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

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

ALLOWED = {"Car", "Van", "Truck", "Tram", "Cyclist"}
DEFORMABLE = {"Pedestrian", "Person_sitting"}
FRAME_RATE = 10.0


@dataclass
class KittiMotDataParserConfig:
    sequence: str = "0006"
    data: str = "data/kittimot"
    eval_fraction: float = 0.125

    def setup(self) -> "KittiMotDataParser":
        return KittiMotDataParser(self)


class KittiMotDataParser:
    def __init__(self, config: KittiMotDataParserConfig):
        self.config = config

    def get_dataparser_outputs(self) -> DataparserOutputs:
        import PIL.Image

        cfg = self.config
        root = Path(cfg.data) / "training"
        if not root.exists():
            raise FileNotFoundError(f"KITTI MOT not found at {root}")

        calib = _read_kitti_calib(root / "calib" / f"{cfg.sequence}.txt")
        P2 = calib["P2"].reshape(3, 4)
        Tr = np.vstack([calib["Tr_velo_cam"].reshape(3, 4), [0, 0, 0, 1]])
        cam2velo = np.linalg.inv(Tr)
        img_dir = root / "image_02" / cfg.sequence
        vel_dir = root / "velodyne" / cfg.sequence

        c2ws, l2ws, images, intr, lidar_points, times = [], [], [], [], [], []
        for i, l2w in enumerate(_read_oxts_poses(root / "oxts" / f"{cfg.sequence}.txt")):
            img_path = img_dir / f"{i:06d}.png"
            vel_path = vel_dir / f"{i:06d}.bin"
            if not img_path.exists() or not vel_path.exists():
                break
            c2w = (l2w @ cam2velo)[:3, :4].copy()
            c2w[:3, :3] = c2w[:3, :3] @ OPENCV_TO_NERF
            c2ws.append(c2w)
            l2ws.append(l2w[:3, :4])
            images.append(np.asarray(PIL.Image.open(img_path)))
            intr.append([P2[0, 0], P2[1, 1], P2[0, 2], P2[1, 2]])
            pts = np.fromfile(vel_path, np.float32).reshape(-1, 4)
            lidar_points.append(np.concatenate([pts[:, :3], pts[:, 3:4], np.zeros((len(pts), 2), np.float32)], axis=1))
            times.append(i / FRAME_RATE)

        # KITTI frames vary by a few pixels: crop all to the smallest
        h = min(im.shape[0] for im in images)
        w = min(im.shape[1] for im in images)
        images = np.stack([im[:h, :w] for im in images])
        c2ws = np.stack(c2ws).astype(np.float32)
        l2ws = np.stack(l2ws).astype(np.float32)
        times = np.asarray(times)

        trajectories = _trajectories(root / "label_02" / f"{cfg.sequence}.txt", l2ws, times, cam2velo)
        (times,), duration = zero_base_times([times], trajectories)
        pose_sets, center = recenter_poses([c2ws, l2ws])
        c2ws, l2ws = pose_sets
        for traj in trajectories:
            traj["poses"][:, :3, 3] -= center

        n = len(c2ws)
        return DataparserOutputs(
            camera_to_worlds=c2ws,
            intrinsics=np.asarray(intr, np.float32),
            image_size=(h, w),
            camera_type=np.full(n, int(CameraType.PERSPECTIVE)),
            distortion_params=None,
            camera_times=times.astype(np.float32),
            camera_sensor_idxs=np.zeros(n, np.int64),
            images=images,
            lidar_to_worlds=l2ws,
            lidar_times=times.astype(np.float32),
            lidar_sensor_idxs=np.ones(n, np.int64),
            lidar_points=lidar_points,
            radar_to_worlds=np.zeros((0, 3, 4), np.float32),
            radar_times=np.zeros(0, np.float32),
            radar_sensor_idxs=np.zeros(0, np.int64),
            radar_points=[],
            radar_fov=dict(NO_RADAR_FOV),
            scene_box=scene_box_from_poses(pose_sets),
            trajectories=trajectories,
            duration=duration,
            sensor_idx_to_name={0: "image_02", 1: "velodyne"},
            camera_split=linspaced_split(n, cfg.eval_fraction),
            lidar_split=linspaced_split(n, cfg.eval_fraction),
            radar_split=linspaced_split(0),
        )


def _trajectories(label_path: Path, l2ws: np.ndarray, times: np.ndarray, cam2velo: np.ndarray) -> list:
    """One trajectory per track of an allowed or deformable type seen in two frames or more. KITTI's
    object frame (camera axes: x along the heading, y down, z across) turns into the box frame (x
    lateral, y longitudinal, z up); dims (w, l, h)."""
    if not label_path.exists():
        return []
    obj_to_box = np.eye(4)
    obj_to_box[:3, :3] = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, -1.0], [-1.0, 0.0, 0.0]])
    cam2velo4 = np.eye(4)
    cam2velo4[:3, :4] = cam2velo[:3, :4]
    by_track: dict = {}
    for line in open(label_path):
        f = line.split()
        frame, track_id, typ = int(f[0]), int(f[1]), f[2]
        if typ not in ALLOWED | DEFORMABLE or frame >= len(times):
            continue
        h, w, l = float(f[10]), float(f[11]), float(f[12])
        x, y, z = float(f[13]), float(f[14]), float(f[15])  # the box's bottom centre in the camera frame
        c, s = np.cos(float(f[16])), np.sin(float(f[16]))
        pose_cam = np.eye(4)
        pose_cam[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pose_cam[:3, 3] = [x, y - h / 2, z]
        pose_world = np.vstack([l2ws[frame], [0, 0, 0, 1]]) @ cam2velo4 @ pose_cam @ obj_to_box
        rec = by_track.setdefault(track_id, {"ts": [], "poses": [], "type": typ, "dims": [w, l, h]})
        rec["ts"].append(times[frame])
        rec["poses"].append(pose_world.astype(np.float32))
    return [dict(timestamps=np.asarray(rec["ts"]), poses=np.stack(rec["poses"]),
                 dims=np.asarray(rec["dims"], np.float32), symmetric=rec["type"] in ALLOWED,
                 deformable=rec["type"] in DEFORMABLE)
            for rec in by_track.values() if len(rec["ts"]) >= 2]


def _read_kitti_calib(path: Path) -> dict:
    """A KITTI calib file's ``key: numbers`` or ``key numbers`` lines."""
    d = {}
    for line in open(path):
        if ":" in line:
            k, v = line.split(":", 1)
        elif " " in line:
            k, v = line.split(" ", 1)
        else:
            continue
        try:
            d[k.strip().replace(":", "")] = np.fromstring(v, sep=" ")
        except ValueError:
            pass
    return d


def _read_oxts_poses(path: Path) -> list:
    """IMU/GPS -> world 4 x 4 poses from the oxts lines (the KITTI devkit's Mercator projection at the
    first latitude's scale), relative to the first pose."""
    lines = [np.fromstring(line, sep=" ") for line in open(path)]
    scale = np.cos(lines[0][0] * np.pi / 180.0)
    er = 6378137.0
    poses = []
    origin = None
    for ox in lines:
        lat, lon, alt, roll, pitch, yaw = ox[:6]
        t = np.array([scale * lon * np.pi * er / 180.0, scale * er * np.log(np.tan((90.0 + lat) * np.pi / 360.0)),
                      alt])
        Rx = np.array([[1, 0, 0], [0, np.cos(roll), -np.sin(roll)], [0, np.sin(roll), np.cos(roll)]])
        Ry = np.array([[np.cos(pitch), 0, np.sin(pitch)], [0, 1, 0], [-np.sin(pitch), 0, np.cos(pitch)]])
        Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        m = np.eye(4)
        m[:3, :3] = Rz @ Ry @ Rx
        m[:3, 3] = t
        if origin is None:
            origin = np.linalg.inv(m)
        poses.append(origin @ m)
    return poses
