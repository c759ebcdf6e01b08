"""Method presets of the port (the JAX package's configs/method_configs.py).
Only ``neuradar-synthetic`` is ported: the data-free preset, float32, with the
VGG loss and the camera optimizer off."""

from __future__ import annotations

from typing import Callable, Dict

from neuradar_tpu_torch.data.datamanager import ADDataManagerConfig
from neuradar_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
from neuradar_tpu_torch.engine.optimizers import default_optimizer_groups
from neuradar_tpu_torch.engine.trainer import TrainerConfig
from neuradar_tpu_torch.pipelines.ad_neuradar_pipeline import ADNeuRadarPipelineConfig


def _neuradar_synthetic() -> TrainerConfig:
    return TrainerConfig(
        max_num_iterations=2001,
        pipeline=ADNeuRadarPipelineConfig(datamanager=ADDataManagerConfig()),
        optimizers=default_optimizer_groups(2001),
        dataparser=SyntheticDataParserConfig(),
    )


method_configs: Dict[str, Callable[[], TrainerConfig]] = {"neuradar-synthetic": _neuradar_synthetic}
