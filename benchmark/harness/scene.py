"""The scenes of the benchmark's configurations, made from the seed on the host (numpy only).

A frozen copy of the port's synthetic scene generator (``data/dataparsers/synthetic.py``: a ground
plane, two walls and box actors moving beside the ego path; shaded depth images, analytic lidar ray
casts, radar points on actors and wall clutter) and of its sensor stand-ins
(``configs/bench_program.py``: the coarse images repeated up to a real camera's size, that camera's
model and intrinsics, and a radar's field of view). ``make_scene`` returns the reference's
``DataparserOutputs``; the harness hands the same arrays to the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from reference.nrref.cameras.cameras import CameraType
from reference.nrref.data.dataparsers.base import DataparserOutputs, SceneBox, linspaced_split


@dataclass
class SceneSettings:
    num_frames: int = 24
    image_height: int = 96
    image_width: int = 156
    lidar_points_per_scan: int = 8192
    num_actors: int = 2
    ego_speed: float = 5.0  # m/s along +x
    frame_dt: float = 0.5
    seed: int = 0
    radar_fov: Optional[Dict[str, float]] = None


def _ray_cast_scene(origins: np.ndarray, dirs: np.ndarray, t: float, actors: List[dict]) -> np.ndarray:
    """Analytic nearest-hit distance for ground plane (z=-2), side walls
    (y=+-12) and actor boxes. Returns distances [N] (1e4 where no hit)."""
    n = len(dirs)
    dist = np.full(n, 1e4, np.float64)

    # ground plane z = -2
    dz = dirs[:, 2]
    tt = (-2.0 - origins[:, 2]) / np.where(np.abs(dz) < 1e-9, 1e-9, dz)
    hit = (tt > 0.1) & (tt < dist)
    dist = np.where(hit, tt, dist)

    # walls y = +-12
    for wy in (-12.0, 12.0):
        dy = dirs[:, 1]
        tt = (wy - origins[:, 1]) / np.where(np.abs(dy) < 1e-9, 1e-9, dy)
        hit = (tt > 0.1) & (tt < dist)
        dist = np.where(hit, tt, dist)

    # axis-aligned actor boxes (slab method)
    for actor in actors:
        center = actor["center_fn"](t)
        half = actor["half"]
        lo, hi = center - half, center + half
        safe = np.where(np.abs(dirs) < 1e-9, 1e-9, dirs)
        t0 = (lo - origins) / safe
        t1 = (hi - origins) / safe
        tmin = np.minimum(t0, t1).max(axis=1)
        tmax = np.maximum(t0, t1).min(axis=1)
        hit = (tmin < tmax) & (tmin > 0.1) & (tmin < dist)
        dist = np.where(hit, tmin, dist)
    return dist


def synthetic_scene(cfg: SceneSettings) -> DataparserOutputs:
    """The synthetic scene of ``cfg``: cameras, lidar scans, radar scans, actors, box and splits."""
    rng = np.random.RandomState(cfg.seed)
    n = cfg.num_frames
    times = np.arange(n, dtype=np.float64) * cfg.frame_dt

    # ego trajectory along +x at z=0
    ego_pos = np.stack([times * cfg.ego_speed, np.zeros(n), np.zeros(n)], axis=1)

    # actors: boxes moving parallel to ego in the adjacent lane
    actors = []
    trajectories = []
    for a in range(cfg.num_actors):
        lane_y = 4.0 * (1 if a % 2 == 0 else -1)
        speed = cfg.ego_speed * (0.6 + 0.3 * a)
        x0 = 15.0 + 10.0 * a
        half = np.array([2.2, 1.0, 0.8])

        def center_fn(t, x0=x0, speed=speed, lane_y=lane_y):
            return np.array([x0 + speed * t, lane_y, -1.0])

        actors.append(dict(center_fn=center_fn, half=half))
        poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        for i, t in enumerate(times):
            poses[i, :3, 3] = center_fn(t)
        trajectories.append(
            dict(timestamps=times.copy(), poses=poses, dims=(half * 2).astype(np.float32),
                 symmetric=True, deformable=False)
        )

    # ---- cameras: forward-facing pinhole
    H, W = cfg.image_height, cfg.image_width
    fx = fy = 0.8 * W
    cx, cy = W / 2, H / 2
    c2ws = np.zeros((n, 3, 4), np.float32)
    # camera looks down -z in camera frame; world forward is +x:
    # cam x -> world -y (right), cam y -> world +z (up), cam -z -> world +x
    # columns are the camera axes in world coordinates:
    # col0 (cam x/right) = -y, col1 (cam y/up) = +z, col2 (cam z) = -x
    # so the camera's -z forward is world +x (the driving direction)
    R = np.array([[0.0, 0.0, -1.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    for i in range(n):
        c2ws[i, :3, :3] = R
        c2ws[i, :3, 3] = ego_pos[i] + np.array([0.0, 0.0, 1.5])

    images = np.zeros((n, H, W, 3), np.uint8)
    rows, cols = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    u = (cols + 0.5 - cx) / fx
    v = -(rows + 0.5 - cy) / fy
    dirs_cam = np.stack([u, v, -np.ones_like(u)], axis=-1).reshape(-1, 3)
    dirs_cam /= np.linalg.norm(dirs_cam, axis=-1, keepdims=True)
    for i in range(n):
        d_world = dirs_cam @ c2ws[i, :3, :3].T
        o = np.broadcast_to(c2ws[i, :3, 3], d_world.shape)
        dist = _ray_cast_scene(o, d_world, times[i], actors)
        hitpts = o + d_world * dist[:, None]
        shade = np.clip(1.0 - dist / 80.0, 0, 1)
        rgbf = np.stack(
            [shade, 0.5 + 0.5 * np.sin(hitpts[:, 0] * 0.3), 0.5 + 0.5 * np.cos(hitpts[:, 1] * 0.4)], axis=-1
        )
        rgbf = np.where(dist[:, None] > 9e3, 0.55, rgbf)  # sky
        images[i] = (rgbf.reshape(H, W, 3) * 255).astype(np.uint8)

    # ---- lidar: random az/el ray cast per scan
    l2ws = np.zeros((n, 3, 4), np.float32)
    l2ws[:, :3, :3] = np.eye(3)
    l2ws[:, :3, 3] = ego_pos + np.array([0.0, 0.0, 1.8])
    lidar_points = []
    for i in range(n):
        az = rng.uniform(-np.pi, np.pi, cfg.lidar_points_per_scan)
        el = rng.uniform(-0.35, 0.1, cfg.lidar_points_per_scan)
        d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=1)
        o = np.broadcast_to(l2ws[i, :3, 3].astype(np.float64), d.shape)
        dist = _ray_cast_scene(o, d, times[i], actors)
        returned = dist < 9e3
        # non-returns synthesized at a dummy far distance (cf.
        # ad_dataparser.py:482-621 missing-point synthesis at 2e3 m)
        dist = np.where(returned, dist, 2e3)
        pts_sensor = d * dist[:, None]  # sensor frame (identity rotation)
        intensity = np.where(returned, np.clip(1.0 / (1 + 0.05 * dist), 0, 1), 0.0)
        pt_time = np.zeros(len(d))
        channel = np.zeros(len(d))
        lidar_points.append(
            np.stack([*pts_sensor.T, intensity, pt_time, channel], axis=1).astype(np.float32)
        )

    # ---- radar: gt points on actor surfaces + wall clutter
    r2ws = np.zeros((n, 3, 4), np.float32)
    r2ws[:, :3, :3] = np.eye(3)
    r2ws[:, :3, 3] = ego_pos + np.array([2.0, 0.0, 0.5])
    radar_points = []
    for i in range(n):
        pts = []
        for actor in actors:
            c = actor["center_fn"](times[i])
            rel = c - r2ws[i, :3, 3]
            if rel[0] > 1.0 and abs(np.arctan2(rel[1], rel[0])) < 0.8:
                jitter = rng.randn(4, 3) * np.array([0.5, 0.3, 0.1])
                pts.append(rel[None] + jitter)
        n_clutter = rng.randint(2, 6)
        az = rng.uniform(-0.7, 0.7, n_clutter)
        dist = rng.uniform(8, 60, n_clutter)
        pts.append(np.stack([dist * np.cos(az), dist * np.sin(az), rng.randn(n_clutter) * 0.2], axis=1))
        radar_points.append(np.concatenate(pts, axis=0).astype(np.float32))

    all_pos = np.concatenate([c2ws[:, :3, 3], l2ws[:, :3, 3], r2ws[:, :3, 3]])
    lo, hi = all_pos.min(0) - 40.0, all_pos.max(0) + 40.0

    return DataparserOutputs(
        camera_to_worlds=c2ws,
        intrinsics=np.tile(np.array([[fx, fy, cx, cy]], np.float32), (n, 1)),
        image_size=(H, W),
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
        radar_fov=dict(cfg.radar_fov),
        scene_box=SceneBox(aabb=np.stack([lo, hi])),
        trajectories=trajectories,
        duration=float(times[-1]) + cfg.frame_dt,
        sensor_idx_to_name={0: "camera_front", 1: "lidar_top", 2: "radar_front"},
        camera_split=linspaced_split(n),
        lidar_split=linspaced_split(n),
        radar_split=linspaced_split(n),
    )


def make_scene(spec: Dict) -> DataparserOutputs:
    """The scene of a configuration file's ``scene`` entry, drawn from its ``seed``: the synthetic scene
    at its coarse size, its images repeated (nearest neighbour) up to the camera's ``image`` size,
    the camera's ``intrinsics`` (fx, fy, cx, cy), ``camera_type`` and ``distortion`` on every frame,
    and the radar's ``radar_fov``."""
    settings = SceneSettings(num_frames=spec["num_frames"], image_height=spec["coarse_image"][0],
                             image_width=spec["coarse_image"][1],
                             lidar_points_per_scan=spec["lidar_points_per_scan"], num_actors=spec["num_actors"],
                             seed=int(spec["seed"]), radar_fov=dict(spec["radar_fov"]))
    out = synthetic_scene(settings)
    n, (H, W) = len(out.camera_to_worlds), tuple(spec["image"])
    h, w = out.image_size
    out.images = out.images[:, (np.arange(H) * h // H)[:, None], (np.arange(W) * w // W)[None, :]]
    out.image_size = (H, W)
    out.intrinsics = np.tile(np.array([spec["intrinsics"]], np.float32), (n, 1))
    out.camera_type = np.full(n, int(CameraType[spec["camera_type"]]))
    if spec.get("distortion") is not None:
        out.distortion_params = np.tile(np.array([spec["distortion"]], np.float32), (n, 1))
    return out
