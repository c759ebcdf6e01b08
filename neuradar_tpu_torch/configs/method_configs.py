"""Method presets of the port (the JAX package's configs/method_configs.py).
Only ``neuradar-synthetic`` is ported: the data-free preset, float32, with the
VGG loss and the camera optimizer off, as in the JAX package."""

from __future__ import annotations

from typing import Callable, Dict

from neuradar_tpu_torch.data.datamanager import ADDataManagerConfig
from neuradar_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
from neuradar_tpu_torch.engine.optimizers import default_optimizer_groups
from neuradar_tpu_torch.engine.trainer import TrainerConfig
from neuradar_tpu_torch.pipelines.ad_neuradar_pipeline import ADNeuRadarPipelineConfig


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


method_configs: Dict[str, Callable[[], TrainerConfig]] = {"neuradar-synthetic": _neuradar_synthetic}
method_descriptions = {"neuradar-synthetic": "NeuRadar on the built-in synthetic scene (no dataset needed)."}


def get_method(name: str) -> TrainerConfig:
    if name not in method_configs:
        raise KeyError(f"unknown method {name!r}; the port has {sorted(method_configs)}")
    return method_configs[name]()
