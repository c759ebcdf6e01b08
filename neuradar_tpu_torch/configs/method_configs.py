"""Method presets of the port (the JAX package's configs/method_configs.py).

``neuradar`` is the paper's preset: ZOD (front fisheye camera, top lidar, front radar) with the
synthesized non-return lidar points, bf16 in 8 chunks, the VGG loss, the camera optimizer off;
``neuradar-set`` its set radar decoder. ``neurad`` drops the radar and turns the SO3xR3 camera
optimizer on; ``neurad-scaleopt`` weights its degrees of freedom; ``neurader`` and ``neuradest``
train longer (2.5x, 7.5x) at halved rates on finer grids, each with its ``-scaleopt``;
``neurad-paper`` and ``neurad-2x-paper`` are neurad and neurader with the paper's settings (no
temporal appearance, no actor flips). ``neuradar-synthetic`` is the data-free preset, float32,
without the VGG loss. ``neuradar-vod`` is neuradar on View-of-Delft; ``neurad-nuscenes``,
``neurad-pandaset``, ``neurad-kittimot``, ``neurad-argoverse2`` and ``neurad-wod`` are neurad on
those datasets' parsers. ``splatfacto`` is 3D Gaussian splatting on the synthetic scene (262,144
gaussians, 256 a tile) with its own trainer (``engine/splatfacto_trainer.py``: the config's
``setup(outputs, device)`` builds it), and ``splatfacto-big`` the same at 1,048,576 gaussians and
512 a tile. The nerfacto family is not here.
"""

from __future__ import annotations

from typing import Callable, Dict

from neuradar_tpu_torch.cameras.camera_optimizers import CameraOptimizerConfig, ScaledCameraOptimizerConfig
from neuradar_tpu_torch.data.datamanager import ADDataManagerConfig
from neuradar_tpu_torch.data.dataparsers.argoverse2 import Argoverse2DataParserConfig
from neuradar_tpu_torch.data.dataparsers.kittimot import KittiMotDataParserConfig
from neuradar_tpu_torch.data.dataparsers.nuscenes import NuScenesDataParserConfig
from neuradar_tpu_torch.data.dataparsers.pandaset import PandasetDataParserConfig
from neuradar_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
from neuradar_tpu_torch.data.dataparsers.vod import VodDataParserConfig
from neuradar_tpu_torch.data.dataparsers.wod import WodDataParserConfig
from neuradar_tpu_torch.data.dataparsers.zod import ZodDataParserConfig
from neuradar_tpu_torch.engine.optimizers import default_optimizer_groups
from neuradar_tpu_torch.engine.splatfacto_trainer import SplatfactoTrainerConfig
from neuradar_tpu_torch.engine.trainer import TrainerConfig
from neuradar_tpu_torch.models.splatfacto import SplatfactoConfig
from neuradar_tpu_torch.pipelines.ad_neuradar_pipeline import ADNeuRadarPipelineConfig


def _neuradar() -> TrainerConfig:
    cfg = TrainerConfig(
        method_name="neuradar",
        steps_per_eval_batch=500,
        steps_per_eval_image=2000,
        steps_per_eval_all_images=20000,
        steps_per_eval_all_radars=20000,
        steps_per_save=10000,
        max_num_iterations=20001,
        pipeline=ADNeuRadarPipelineConfig(datamanager=ADDataManagerConfig()),
        optimizers=default_optimizer_groups(20001),
        dataparser=ZodDataParserConfig(add_missing_points=True),
    )
    cfg.pipeline.model.camera_optimizer = CameraOptimizerConfig(mode="off")
    cfg.pipeline.model.nff_chunks = 8
    cfg.pipeline.model.compute_dtype = "bfloat16"
    return cfg


def _neuradar_set() -> TrainerConfig:
    cfg = _neuradar()
    cfg.method_name = "neuradar-set"
    cfg.pipeline.model.radar_decoder_type = "set"
    cfg.pipeline.model.loss.radar_set_loss = "detr"
    return cfg


def _neuradar_vod() -> TrainerConfig:
    cfg = _neuradar()
    cfg.method_name = "neuradar-vod"
    cfg.dataparser = VodDataParserConfig()
    return cfg


def _neuradar_synthetic() -> TrainerConfig:
    cfg = TrainerConfig(
        method_name="neuradar-synthetic",
        steps_per_eval_batch=500,
        steps_per_eval_image=0,
        steps_per_eval_all_images=2000,
        steps_per_eval_all_radars=2000,
        steps_per_save=1000,
        max_num_iterations=2001,
        pipeline=ADNeuRadarPipelineConfig(datamanager=ADDataManagerConfig()),
        optimizers=default_optimizer_groups(2001),
        dataparser=SyntheticDataParserConfig(),
    )
    cfg.pipeline.model.loss.vgg_mult = 0.0
    return cfg


def _neurad() -> TrainerConfig:
    """Camera and lidar: no radar scans, the SO3xR3 camera optimizer on."""
    cfg = _neuradar()
    cfg.method_name = "neurad"
    cfg.pipeline.datamanager.num_radar_scans = 0
    cfg.pipeline.model.camera_optimizer = CameraOptimizerConfig(mode="SO3xR3")
    return cfg


def _neurad_on(dataparser: Callable[[], object], name: str) -> Callable[[], TrainerConfig]:
    """neurad on another dataset's parser."""

    def make() -> TrainerConfig:
        cfg = _neurad()
        cfg.method_name = name
        cfg.dataparser = dataparser()
        return cfg

    return make


def _scale_camera_optimizer(cfg: TrainerConfig) -> TrainerConfig:
    """The *-scaleopt camera optimizer: z rotation and x, y translation weighted down 100x, with a
    per-axis translation penalty."""
    cfg.pipeline.model.camera_optimizer = ScaledCameraOptimizerConfig(
        mode="SO3xR3", weights=(1.0, 1.0, 0.01, 0.01, 0.01, 1.0), trans_l2_penalty=(1e-2, 1e-2, 1e-3))
    return cfg


def _with_name(cfg: TrainerConfig, name: str) -> TrainerConfig:
    cfg.method_name = name
    return cfg


def _scaled(base: Callable[[], TrainerConfig], scale: float, name: str) -> Callable[[], TrainerConfig]:
    """``base`` with its iterations, cadences and schedules stretched by ``scale``; the schedules are
    stretched in place, so the base's rates stay."""

    def make() -> TrainerConfig:
        cfg = _with_name(base(), name)
        cfg.max_num_iterations = int((cfg.max_num_iterations - 1) * scale + 1)
        cfg.steps_per_eval_batch = int(cfg.steps_per_eval_batch * scale)
        cfg.steps_per_eval_image = int(cfg.steps_per_eval_image * scale)
        cfg.steps_per_eval_all_images = int(cfg.steps_per_eval_all_images * scale)
        cfg.steps_per_eval_all_radars = int(cfg.steps_per_eval_all_radars * scale)
        cfg.steps_per_save = int(cfg.steps_per_save * scale)
        for g in cfg.optimizers.values():
            if g.scheduler is not None:
                g.scheduler.max_steps = int(g.scheduler.max_steps * scale)
                g.scheduler.warmup_steps = int(g.scheduler.warmup_steps * scale)
        return cfg

    return make


def _neurader() -> TrainerConfig:
    """neurad at 2.5x the schedule, halved rates, twice the static grids' resolution and one more
    hashmap bit on every grid."""
    cfg = _scaled(_neurad, 2.5, "neurader")()
    for g in cfg.optimizers.values():
        g.optimizer.lr *= 0.5
        if g.scheduler is not None:
            g.scheduler.lr_final *= 0.5
    m = cfg.pipeline.model
    for f in (m.field, m.sampling.proposal_field_1, m.sampling.proposal_field_2):
        f.grid.static.max_res *= 2
        f.grid.static.base_res *= 2
        f.grid.static.log2_hashmap_size += 1
        f.grid.actor.log2_hashmap_size += 1
    return cfg


def _neuradest() -> TrainerConfig:
    """neurader stretched another 3x."""
    return _scaled(_neurader, 3.0, "neuradest")()


def _paperize(cfg: TrainerConfig, name: str) -> TrainerConfig:
    """The paper's settings: no temporal appearance, no actor flips."""
    cfg.method_name = name
    cfg.pipeline.model.use_temporal_appearance = False
    m = cfg.pipeline.model
    for f in (m.field, m.sampling.proposal_field_1, m.sampling.proposal_field_2):
        f.grid.actor.flip_prob = 0.0
    return cfg


def _splatfacto() -> SplatfactoTrainerConfig:
    return SplatfactoTrainerConfig(dataparser=SyntheticDataParserConfig())


def _splatfacto_big() -> SplatfactoTrainerConfig:
    cfg = _splatfacto()
    cfg.method_name = "splatfacto-big"
    cfg.model = SplatfactoConfig(max_gaussians=1_048_576, tile_top_k=512)
    return cfg


method_configs: Dict[str, Callable[[], object]] = {
    "neuradar": _neuradar,
    "neuradar-set": _neuradar_set,
    "neuradar-vod": _neuradar_vod,
    "neuradar-synthetic": _neuradar_synthetic,
    "neurad": _neurad,
    "neurad-scaleopt": lambda: _scale_camera_optimizer(_with_name(_neurad(), "neurad-scaleopt")),
    "neurader": _neurader,
    "neuradest": _neuradest,
    "neurader-scaleopt": lambda: _scale_camera_optimizer(_with_name(_neurader(), "neurader-scaleopt")),
    "neuradest-scaleopt": lambda: _scale_camera_optimizer(_with_name(_neuradest(), "neuradest-scaleopt")),
    "neurad-paper": lambda: _paperize(_neurad(), "neurad-paper"),
    "neurad-2x-paper": lambda: _paperize(_neurader(), "neurad-2x-paper"),
    "neurad-nuscenes": _neurad_on(NuScenesDataParserConfig, "neurad-nuscenes"),
    "neurad-pandaset": _neurad_on(PandasetDataParserConfig, "neurad-pandaset"),
    "neurad-kittimot": _neurad_on(KittiMotDataParserConfig, "neurad-kittimot"),
    "neurad-argoverse2": _neurad_on(Argoverse2DataParserConfig, "neurad-argoverse2"),
    "neurad-wod": _neurad_on(WodDataParserConfig, "neurad-wod"),
    "splatfacto": _splatfacto,
    "splatfacto-big": _splatfacto_big,
}
method_descriptions = {
    "neuradar": "NeuRadar, the paper's preset: ZOD camera + lidar + radar, bf16 in 8 chunks (needs zod data).",
    "neuradar-set": "NeuRadar with the set-based (DETR) radar decoder on ZOD (needs zod data).",
    "neuradar-vod": "NeuRadar on View-of-Delft: camera + lidar + 3+1D radar, 4,400 rays a radar scan (needs VoD data).",
    "neuradar-synthetic": "NeuRadar on the built-in synthetic scene (no dataset needed).",
    "neurad": "NeuRAD: camera + lidar on ZOD, SO3xR3 camera optimizer (needs zod data).",
    "neurad-scaleopt": "NeuRAD with the per-axis scaled camera optimizer (needs zod data).",
    "neurader": "NeuRAD, bigger grids and a 2.5x schedule (needs zod data).",
    "neuradest": "NeuRAD, bigger grids and a 7.5x schedule (needs zod data).",
    "neurader-scaleopt": "neurader with the scaled camera optimizer (needs zod data).",
    "neuradest-scaleopt": "neuradest with the scaled camera optimizer (needs zod data).",
    "neurad-paper": "NeuRAD with the paper's settings: no temporal appearance, no actor flips (needs zod data).",
    "neurad-2x-paper": "neurader with the paper's settings (needs zod data).",
    "neurad-nuscenes": "NeuRAD on nuScenes: the front camera and the top lidar (needs the nuscenes devkit and data).",
    "neurad-pandaset": "NeuRAD on PandaSet: the front camera with its rolling shutter and the Pandar64 (needs data).",
    "neurad-kittimot": "NeuRAD on KITTI MOT: image_02 and the velodyne, oxts poses (needs data).",
    "neurad-argoverse2": "NeuRAD on Argoverse 2: the front ring camera and the lidar (needs the av2 devkit and data).",
    "neurad-wod": "NeuRAD on the Waymo Open Dataset: front camera, column rolling shutter, top lidar (needs data).",
    "splatfacto": "3D Gaussian splatting on the synthetic scene: 262,144 gaussians, SH degree 3, 256 a tile.",
    "splatfacto-big": "3D Gaussian splatting at 1,048,576 gaussians and 512 a tile (splatfacto-big).",
}


def get_method(name: str):
    """A fresh config of the preset ``name``: a ``TrainerConfig``, or a ``SplatfactoTrainerConfig``
    for the splatfacto presets."""
    if name not in method_configs:
        raise KeyError(f"unknown method {name!r}; the port has {sorted(method_configs)}")
    return method_configs[name]()
