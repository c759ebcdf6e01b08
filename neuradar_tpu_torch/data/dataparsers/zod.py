"""ZOD (Zenseact Open Dataset) dataparser (port of the JAX package's data/dataparsers/zod.py).

The front fisheye camera (its hood cropped), the VLS-128 top lidar, the front 4D radar (one .npy
a sequence, rows of quality at or above the threshold dropped), the auto-annotated actor boxes, and
the shared steps of base.py (zero-based times, the world recentred on the mean sensor position,
the scene box, the linspaced eval split).

It needs the ``zod`` devkit and a sequence on disk; the devkit is imported when the parser runs,
so the rest of the port works without it.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import numpy as np

from neuradar_tpu_torch.cameras.cameras import CameraType
from neuradar_tpu_torch.cameras.radars import ZOD_RADAR_FOV
from neuradar_tpu_torch.data.dataparsers.base import (
    DataparserOutputs,
    linspaced_split,
    recenter_poses,
    scene_box_from_poses,
    synthesize_missing_points,
    zero_base_times,
)

# OpenCV camera (x right, y down, z forward) -> the port's convention (x right, y up, z backward)
OPENCV_TO_NERF = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)
# the devkit's box frame (width, length, height axes) -> (length, width, height)
WLH_TO_LWH = np.array([[0, 1, 0, 0], [-1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)

HOOD_HEIGHT = 750  # image rows cropped from the bottom (the ego vehicle's hood)
MAX_INTENSITY = 255.0
ALLOWED_CATEGORIES = {"Vehicle", "LargeVehicle", "Motorcyclist", "Bicyclist", "Trailer"}
DEFORMABLE_CATEGORIES = {"Pedestrian"}

# per sequence, the side "one lane over" lies on for the lane-shift eval: +1 right, -1 left; an
# unknown sequence gets -1
ZOD_LANE_SHIFT_SIGN = {
    "000784": -1, "000005": 1, "000030": -1, "000221": -1, "000231": 1,
    "000387": -1, "001186": -1, "000657": -1, "000581": -1, "000619": 1,
    "000546": -1, "000244": 1, "000811": -1,
}


@dataclass
class ZodDataParserConfig:
    sequence: str = "000581"
    data: str = "data/zod"
    version: str = "full"  # mini | full
    cameras: Tuple[str, ...] = ("front",)
    lidars: Tuple[str, ...] = ("top",)
    radars: Tuple[str, ...] = ("front",)
    add_missing_points: bool = True
    radar_quality_threshold: int = 3
    min_lidar_dist: Tuple[float, float, float] = (1.5, 3.0, 1.5)
    eval_fraction: float = 0.125
    image_downscale: int = 1  # declared and unused, as in the JAX package

    def setup(self) -> "ZodDataParser":
        return ZodDataParser(self)


class ZodDataParser:
    def __init__(self, config: ZodDataParserConfig):
        self.config = config

    def get_dataparser_outputs(self) -> DataparserOutputs:
        try:
            from zod import ZodSequences
            from zod.constants import Anonymization, Camera as ZodCamera, Lidar as ZodLidar
        except ImportError as e:
            raise ImportError(
                "The 'zod' devkit is required for ZodDataParser (pip install zod). "
                "Use the 'neuradar-synthetic' method for dataset-free runs."
            ) from e

        cfg = self.config
        seq = ZodSequences(dataset_root=str(cfg.data), version=cfg.version)[cfg.sequence]

        # cameras: the front fisheye, its hood cropped
        calib = seq.calibration
        cam_calib = calib.cameras[ZodCamera.FRONT]
        c2ws, intr, times, images, dists = [], [], [], [], []
        for frame in seq.info.get_camera_frames(anonymization=Anonymization.BLUR):
            pose = seq.ego_motion.get_poses(frame.time.timestamp())  # ego -> world, 4 x 4
            c2w = (pose @ cam_calib.extrinsics.transform)[:3, :4].copy()  # camera -> world (OpenCV)
            c2w[:3, :3] = c2w[:3, :3] @ OPENCV_TO_NERF
            images.append(frame.read()[:-HOOD_HEIGHT])
            c2ws.append(c2w)
            k = cam_calib.intrinsics
            intr.append([k[0, 0], k[1, 1], k[0, 2], k[1, 2]])
            dists.append(np.concatenate([cam_calib.distortion, np.zeros(2)])[:6])
            times.append(frame.time.timestamp())
        images = np.stack(images)
        c2ws = np.stack(c2ws).astype(np.float32)
        cam_times = np.asarray(times, np.float64)

        # lidar: the top VLS-128; points in the sensor frame with their time from the scan's median
        lidar_calib = calib.lidars[ZodLidar.VELODYNE]
        l2ws, lidar_times, lidar_points = [], [], []
        for frame in seq.info.get_lidar_frames():
            data = frame.read()
            t_mid = float(np.median(data.timestamps))
            pose = seq.ego_motion.get_poses(np.median(data.timestamps))
            l2ws.append((pose @ lidar_calib.extrinsics.transform)[:3, :4])
            lidar_times.append(t_mid)
            pts = np.concatenate([data.points.astype(np.float32),
                                  (data.intensity[:, None] / MAX_INTENSITY).astype(np.float32),
                                  (data.timestamps - t_mid).astype(np.float32)[:, None],
                                  data.diode_idx[:, None].astype(np.float32)], axis=1)
            # the ego vehicle's own points: inside the ellipsoid of min_lidar_dist
            pts = pts[np.linalg.norm(pts[:, :3] / np.asarray(cfg.min_lidar_dist), axis=-1) > 1.0]
            if cfg.add_missing_points:
                pts = synthesize_missing_points(pts, azimuth_resolution_deg=0.2)
            lidar_points.append(pts)
        l2ws = np.stack(l2ws).astype(np.float32)
        lidar_times = np.asarray(lidar_times, np.float64)

        # radar: the front sensor's sequence file split into scans
        radar_scans = _read_zod_radar(cfg)
        radar_extr = _zod_radar_extrinsics(calib)
        radar_times = np.asarray([t for t, _ in radar_scans], np.float64)
        radar_points = [p for _, p in radar_scans]
        r2ws = [(seq.ego_motion.get_poses(float(t)) @ radar_extr)[:3, :4] for t in radar_times]
        r2ws = np.stack(r2ws).astype(np.float32) if r2ws else np.zeros((0, 3, 4), np.float32)

        trajectories = _zod_trajectories(seq)

        (cam_times, lidar_times, radar_times), duration = zero_base_times([cam_times, lidar_times, radar_times],
                                                                          trajectories)
        pose_sets, center = recenter_poses([c2ws, l2ws, r2ws])
        c2ws, l2ws, r2ws = pose_sets
        for traj in trajectories:
            traj["poses"][:, :3, 3] -= center

        n_cam = len(c2ws)
        return DataparserOutputs(
            camera_to_worlds=c2ws,
            intrinsics=np.asarray(intr, np.float32),
            image_size=(images.shape[1], images.shape[2]),
            camera_type=np.full(n_cam, int(CameraType.FISHEYE)),
            distortion_params=np.asarray(dists, np.float32),
            camera_times=cam_times.astype(np.float32),
            camera_sensor_idxs=np.zeros(n_cam, np.int64),
            images=images,
            lidar_to_worlds=l2ws,
            lidar_times=lidar_times.astype(np.float32),
            lidar_sensor_idxs=np.ones(len(l2ws), np.int64),
            lidar_points=lidar_points,
            radar_to_worlds=r2ws,
            radar_times=radar_times.astype(np.float32),
            radar_sensor_idxs=np.full(len(r2ws), 2, np.int64),
            radar_points=radar_points,
            radar_fov=dict(ZOD_RADAR_FOV),
            scene_box=scene_box_from_poses(pose_sets),
            trajectories=trajectories,
            duration=duration,
            sensor_idx_to_name={0: "camera_front", 1: "lidar_velodyne", 2: "radar_front"},
            camera_split=linspaced_split(n_cam, cfg.eval_fraction),
            lidar_split=linspaced_split(len(l2ws), cfg.eval_fraction),
            radar_split=linspaced_split(len(r2ws), cfg.eval_fraction),
            lane_shift_sign=ZOD_LANE_SHIFT_SIGN.get(cfg.sequence, -1),
        )


def _read_zod_radar(cfg: ZodDataParserConfig) -> list:
    """(time, [G, 3] points) per scan from the sequence's radar file, whose rows are [timestamp, x,
    y, z, snr, range_rate, mode, quality] (or a structured array with those fields); rows of quality
    at or above ``radar_quality_threshold`` are dropped."""
    radar_path = next(iter((Path(cfg.data) / "sequences" / cfg.sequence / "radar_front").glob("*.npy")), None)
    if radar_path is None:
        return []
    arr = np.asarray(np.load(radar_path, allow_pickle=True))
    if arr.dtype.fields is not None:
        ts = arr["timestamp"]
        xyz = np.stack([arr["x"], arr["y"], arr["z"]], axis=1)
        quality = arr["quality"] if "quality" in arr.dtype.fields else np.zeros(len(arr))
    else:
        ts, xyz, quality = arr[:, 0], arr[:, 1:4], arr[:, -1]
    good = quality < cfg.radar_quality_threshold
    ts, xyz = ts[good], xyz[good]
    return [(float(t), xyz[ts == t].astype(np.float32)) for t in np.unique(ts)]


def _zod_radar_extrinsics(calib) -> np.ndarray:
    try:
        from zod.constants import Radar as ZodRadar

        return calib.radars[ZodRadar.FRONT].extrinsics.transform
    except Exception:  # noqa: BLE001 - older devkits carry no radar calibration
        return np.eye(4)


def _zod_trajectories(seq) -> list:
    """Actor trajectories from the auto-annotations: one per object uuid of an allowed category, its
    box poses turned from the devkit's (w, l, h) frame to (l, w, h) and its size reordered so."""
    try:
        from zod.constants import AnnotationProject

        annos = seq.get_annotation(AnnotationProject.OBJECT_DETECTION)
    except Exception:  # noqa: BLE001 - older devkits take the project's name
        try:
            annos = seq.get_annotation("object_detection")
        except Exception as e:  # noqa: BLE001
            print(f"[zod] WARNING: could not load object annotations ({e}); "
                  "training proceeds WITHOUT dynamic actors")
            return []

    def field(o, key, default=None):
        return o.get(key, default) if isinstance(o, dict) else getattr(o, key, default)

    by_uuid = {}
    for frame in annos:  # raw json frames (dicts) or the devkit's dataclasses
        f_ts = frame["timestamp"] if isinstance(frame, dict) else getattr(frame, "timestamp", 0.0)
        for obj in field(frame, "objects", []):
            if field(obj, "name") in ALLOWED_CATEGORIES | DEFORMABLE_CATEGORIES:
                by_uuid.setdefault(field(obj, "uuid"), []).append((f_ts, obj))

    trajectories = []
    for items in by_uuid.values():
        items.sort(key=lambda x: x[0])
        poses = np.stack([np.asarray(field(o, "pose"), np.float64) @ WLH_TO_LWH for _, o in items])
        name = field(items[0][1], "name")
        trajectories.append(dict(
            timestamps=np.asarray([t for t, _ in items], np.float64), poses=poses.astype(np.float32),
            dims=np.asarray(field(items[0][1], "size"), np.float32)[[1, 0, 2]],
            symmetric=name in ALLOWED_CATEGORIES, deformable=name in DEFORMABLE_CATEGORIES))
    return trajectories
