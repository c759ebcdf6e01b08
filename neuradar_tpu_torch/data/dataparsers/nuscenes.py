"""nuScenes dataparser, camera and lidar (port of the JAX package's data/dataparsers/nuscenes.py).

The scene's samples chained by ``next``: at each, the LIDAR_TOP sweep (x, y, z, intensity / 255, a
zero time, the ring as channel) and the configured cameras (``CAM_<name>``), each pose the ego pose
times the sensor's calibration. The actors are the annotated vehicles and pedestrians seen at two
samples or more, their boxes turned from the devkit's (w, l, h) frame to (l, w, h). With
``mask_dir`` each camera frame takes the mask ``masks/CAM_<name>/<frame>.png`` (above 127 keeps a
pixel; a missing file keeps all).

It needs the ``nuscenes`` devkit, ``pyquaternion`` and PIL, imported when the parser runs.
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
from neuradar_tpu_torch.data.dataparsers.zod import OPENCV_TO_NERF, WLH_TO_LWH

ALLOWED_CATEGORIES = {"vehicle.car", "vehicle.truck", "vehicle.bus", "vehicle.bicycle", "vehicle.motorcycle"}
DEFORMABLE_CATEGORIES = {"human.pedestrian"}


@dataclass
class NuScenesDataParserConfig:
    sequence: str = "scene-0103"
    data: str = "data/nuscenes"
    version: str = "v1.0-trainval"
    cameras: Tuple[str, ...] = ("FRONT",)
    eval_fraction: float = 0.125
    mask_dir: str = ""  # masks/CAM_<name>/<frame>.png under it, 255 keeps a pixel; empty: no masks

    def setup(self) -> "NuScenesDataParser":
        return NuScenesDataParser(self)


class NuScenesDataParser:
    def __init__(self, config: NuScenesDataParserConfig):
        self.config = config

    def get_dataparser_outputs(self) -> DataparserOutputs:
        try:
            from nuscenes.nuscenes import NuScenes as NuScenesDB
            from pyquaternion import Quaternion
        except ImportError as e:
            raise ImportError(
                "The 'nuscenes-devkit' is required for NuScenesDataParser. "
                "Use the 'neuradar-synthetic' method for dataset-free runs."
            ) from e
        import PIL.Image

        cfg = self.config
        nusc = NuScenesDB(version=cfg.version, dataroot=str(cfg.data), verbose=False)
        scene = next(s for s in nusc.scene if s["name"] == cfg.sequence)

        def pose_to_mat(rec):
            m = np.eye(4)
            m[:3, :3] = Quaternion(rec["rotation"]).rotation_matrix
            m[:3, 3] = rec["translation"]
            return m

        c2ws, intr, images, cam_times, masks = [], [], [], [], []
        l2ws, lidar_points, lidar_times = [], [], []
        sample = nusc.get("sample", scene["first_sample_token"])
        while True:
            sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
            ego = pose_to_mat(nusc.get("ego_pose", sd["ego_pose_token"]))
            calib = pose_to_mat(nusc.get("calibrated_sensor", sd["calibrated_sensor_token"]))
            pts = np.fromfile(str(nusc.get_sample_data_path(sd["token"])), np.float32).reshape(-1, 5)
            # x, y, z, intensity, ring -> x, y, z, intensity, time, channel
            l2ws.append((ego @ calib)[:3, :4])
            lidar_points.append(np.concatenate(
                [pts[:, :3], pts[:, 3:4] / 255.0, np.zeros((len(pts), 1), np.float32), pts[:, 4:5]], axis=1))
            lidar_times.append(sd["timestamp"] / 1e6)

            for cam in cfg.cameras:
                sd_c = nusc.get("sample_data", sample["data"][f"CAM_{cam}"])
                ego_c = pose_to_mat(nusc.get("ego_pose", sd_c["ego_pose_token"]))
                calib_c = nusc.get("calibrated_sensor", sd_c["calibrated_sensor_token"])
                c2w = (ego_c @ pose_to_mat(calib_c))[:3, :4].copy()
                c2w[:3, :3] = c2w[:3, :3] @ OPENCV_TO_NERF
                K = np.asarray(calib_c["camera_intrinsic"])
                c2ws.append(c2w)
                intr.append([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
                images.append(np.asarray(PIL.Image.open(nusc.get_sample_data_path(sd_c["token"]))))
                cam_times.append(sd_c["timestamp"] / 1e6)
                if cfg.mask_dir:
                    mp = Path(cfg.mask_dir) / "masks" / f"CAM_{cam}" / Path(sd_c["filename"]).name.replace("jpg", "png")
                    masks.append(np.asarray(PIL.Image.open(mp)) > 127 if mp.exists()
                                 else np.ones(images[-1].shape[:2], bool))

            if not sample["next"]:
                break
            sample = nusc.get("sample", sample["next"])

        trajectories = _trajectories(nusc, scene, Quaternion)
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
            masks=np.stack(masks) if masks else None,
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
            sensor_idx_to_name={0: "camera_front", 1: "lidar_top"},
            camera_split=linspaced_split(n, cfg.eval_fraction),
            lidar_split=linspaced_split(len(l2ws), cfg.eval_fraction),
            radar_split=linspaced_split(0),
        )


def _trajectories(nusc, scene, Quaternion) -> list:
    """One trajectory per annotated instance of an allowed or deformable category seen at two samples
    or more, in the order of first sight."""
    by_instance: dict = {}
    sample = nusc.get("sample", scene["first_sample_token"])
    while True:
        t = sample["timestamp"] / 1e6
        for ann_token in sample["anns"]:
            ann = nusc.get("sample_annotation", ann_token)
            base = ".".join(ann["category_name"].split(".")[:2])
            if base not in ALLOWED_CATEGORIES | DEFORMABLE_CATEGORIES:
                continue
            pose = np.eye(4)
            pose[:3, :3] = Quaternion(ann["rotation"]).rotation_matrix
            pose[:3, 3] = ann["translation"]
            rec = by_instance.setdefault(ann["instance_token"], {"ts": [], "poses": [], "cat": base,
                                                                 "wlh": ann["size"]})
            rec["ts"].append(t)
            rec["poses"].append(pose @ WLH_TO_LWH)
        if not sample["next"]:
            break
        sample = nusc.get("sample", sample["next"])
    trajectories = []
    for rec in by_instance.values():
        if len(rec["ts"]) < 2:
            continue
        wlh = np.asarray(rec["wlh"], np.float32)
        trajectories.append(dict(timestamps=np.asarray(rec["ts"]), poses=np.stack(rec["poses"]).astype(np.float32),
                                 dims=wlh[[1, 0, 2]], symmetric=rec["cat"] in ALLOWED_CATEGORIES,
                                 deformable=rec["cat"] in DEFORMABLE_CATEGORIES))
    return trajectories
