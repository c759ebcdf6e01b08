"""The JAX package's benchmark program (port of its configs/bench_program.py): the reference batch
on the bench scene, with the production model knobs.

    cfg = bench_pipeline_config("full", chunks=8)   # bf16, hoisted table cast, radar in 4 groups
    trainer = Trainer(TrainerConfig(pipeline=cfg), bench_scene_outputs(), "cuda")

The batch of a rung (``bench_datamanager_config``): "full" is 40 x 32^2 camera patches, 16,384
lidar rays and 16 radar scans (113,840 rays with the ZOD radar FoV); "half", "three8", "quarter",
"eighth" and "micro" are the JAX package's smaller rungs, each total divisible by 8 chunks. The
scene (``bench_scene_outputs``): the synthetic scene at 24 frames of 96 x 156 with 32,768 lidar
points a scan. The model: compute_dtype bfloat16, ``chunks`` nff chunks recomputed in the
backward pass, the hash tables cast once a step, no VGG loss (the JAX program has no pretrained
VGG either). Its remat policies and packed cells wait for the hash-grid encode as one kernel
(ROADMAP, K4); the TPU roofline constants of the JAX module are not carried over.

``zod_camera_scene_outputs`` is the synthetic scene in ZOD's front camera, the stand-in scene of
the paper's presets (neuradar, neurad) until a ZOD sequence is at hand:

    trainer = Trainer(get_method("neuradar"), zod_camera_scene_outputs(), "cuda")

``vod_sensor_scene_outputs`` is the synthetic scene in View-of-Delft's sensors (its camera and its
radar FoV), the stand-in scene of ``neuradar-vod`` until a VoD sequence is at hand.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from neuradar_tpu_torch.cameras.cameras import CameraType
from neuradar_tpu_torch.cameras.radars import VOD_RADAR_FOV
from neuradar_tpu_torch.data.datamanager import ADDataManagerConfig
from neuradar_tpu_torch.data.dataparsers.synthetic import SyntheticDataParser, SyntheticDataParserConfig
from neuradar_tpu_torch.pipelines.ad_neuradar_pipeline import ADNeuRadarPipelineConfig

_RUNGS = {  # num_rgb_patches, patch_size, num_lidar_rays, num_radar_scans, max_radar_gt
    "full": (40, 32, 16384, 16, 256),
    "half": (20, 32, 8192, 8, 256),
    "three8": (15, 32, 6150, 6, 256),
    "quarter": (10, 32, 4100, 4, 256),
    "eighth": (5, 32, 2050, 2, 256),
    "micro": (2, 32, 1029, 1, 128),
}


# ZOD's front camera after the hood crop (2168 rows less 750): an equidistant fisheye whose 3848
# columns span 120 degrees (fx = fy = 1924 / (pi / 3)), the principal point at the uncropped image's
# centre (the crop removes rows below it), and six OpenCV coefficients (k1 k2 k3 k4 p1 p2) of fisheye
# strength, those of the JAX package's Newton undistortion test
ZOD_IMAGE = (2168 - 750, 3848)
ZOD_INTRINSICS = (1924 / (math.pi / 3), 1924 / (math.pi / 3), 1924.0, 1084.0)
ZOD_DIST = (-0.2, 0.05, 0.001, 0.0, 0.01, -0.01)


def zod_camera_scene_outputs():
    """The synthetic scene (24 frames, rendered at 96 x 156, seed 0) in ZOD's front camera model:
    FISHEYE with ZOD_DIST, at ZOD_IMAGE with ZOD_INTRINSICS (fx, fy, cx, cy). The images are rendered
    on the coarse grid and repeated up to the camera's size (nearest neighbour): their content does
    not change the work."""
    return _camera_scene(ZOD_IMAGE, ZOD_INTRINSICS, CameraType.FISHEYE, ZOD_DIST)


# VoD's camera: a 1936 x 1216 pinhole without distortion; its intrinsics a stand-in near those of VoD's
# P2 calibration (fx = fy, principal point near the image centre)
VOD_IMAGE = (1216, 1936)
VOD_INTRINSICS = (1495.5, 1495.5, 961.3, 624.9)


def _camera_scene(image_size, intrinsics, camera_type: CameraType, distortion=None):
    """The synthetic scene (24 frames, rendered at 96 x 156, seed 0) in another camera: its images
    rendered on the coarse grid and repeated up to ``image_size`` (nearest neighbour; their content does
    not change the work), ``intrinsics`` (fx, fy, cx, cy) and ``camera_type`` on every frame."""
    out = SyntheticDataParser(SyntheticDataParserConfig()).get_dataparser_outputs()
    n, (H, W) = len(out.camera_to_worlds), image_size
    h, w = out.image_size
    out.images = out.images[:, (np.arange(H) * h // H)[:, None], (np.arange(W) * w // W)[None, :]]
    out.image_size = (H, W)
    out.intrinsics = np.tile(np.array([intrinsics], np.float32), (n, 1))
    out.camera_type = np.full(n, int(camera_type))
    if distortion is not None:
        out.distortion_params = np.tile(np.array([distortion], np.float32), (n, 1))
    return out


def vod_sensor_scene_outputs():
    """The synthetic scene in VoD's sensors: a PERSPECTIVE camera at VOD_IMAGE with VOD_INTRINSICS
    (stand-ins near VoD's P2, no distortion) and VoD's radar FoV, 100 x 44 = 4,400 rays a scan.
    Geometry, lidar, radar points and actors are the synthetic scene's."""
    out = _camera_scene(VOD_IMAGE, VOD_INTRINSICS, CameraType.PERSPECTIVE)
    out.radar_fov = dict(VOD_RADAR_FOV)
    return out


def bench_scene_outputs():
    """The reference-scale synthetic scene every rung trains on."""
    return SyntheticDataParser(SyntheticDataParserConfig(num_frames=24, image_height=96, image_width=156,
                                                         lidar_points_per_scan=32768)).get_dataparser_outputs()


def bench_datamanager_config(scale: str) -> ADDataManagerConfig:
    """The batch of a rung."""
    if scale not in _RUNGS:
        raise ValueError(f"unknown bench scale {scale!r}")
    patches, size, lidar, scans, gt = _RUNGS[scale]
    return ADDataManagerConfig(num_rgb_patches=patches, patch_size=size, num_lidar_rays=lidar,
                               num_radar_scans=scans, max_radar_gt=gt)


def bench_pipeline_config(scale: str = "full", chunks: int = 8, remat_policy: Optional[str] = None,
                          hoist: Optional[bool] = None, radar_chunks: int = 0,
                          packed_cells: bool = False) -> ADNeuRadarPipelineConfig:
    """The JAX package's ``bench_pipeline`` as a config (a Trainer or ``ADNeuRadarPipeline``
    takes it with ``bench_scene_outputs()``). ``hoist`` None and ``radar_chunks`` 0 keep the
    model's defaults (hoisted cast, 4 radar groups)."""
    if remat_policy is not None:
        raise NotImplementedError("nff_remat_policy waits for the hash-grid encode as one kernel (ROADMAP, K4)")
    if packed_cells:
        raise NotImplementedError("packed dense cells wait for the hash-grid encode as one kernel (ROADMAP, K4)")
    cfg = ADNeuRadarPipelineConfig(datamanager=bench_datamanager_config(scale))
    m = cfg.model
    m.loss.vgg_mult = 0.0
    m.nff_chunks = chunks
    m.compute_dtype = "bfloat16"
    if radar_chunks:
        m.radar_decode_chunks = radar_chunks
    if hoist is not None:
        m.hoist_table_cast = hoist
    return cfg

