"""A tiny configuration of the benchmark's model for the CPU tests: the paper's preset with small
hash grids, few samples, a small batch, a 24 x 36 fisheye scene and a 48-ray radar, so that a whole
run (set-up, window, reference) takes seconds on the CPU."""

from __future__ import annotations

import copy
import json
import math
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent.parent

OVERRIDES = {
    "field.grid.static.log2_hashmap_size": 12,
    "field.grid.actor.log2_hashmap_size": 10,
    "sampling.proposal_field_1.grid.static.log2_hashmap_size": 11,
    "sampling.proposal_field_1.grid.actor.log2_hashmap_size": 9,
    "sampling.proposal_field_2.grid.static.log2_hashmap_size": 11,
    "sampling.proposal_field_2.grid.actor.log2_hashmap_size": 9,
    "sampling.num_proposal_samples": [16, 8],
    "sampling.num_nerf_samples": 6,
    "nff_chunks": 2,
    "radar_decode_chunks": 2,
    "eval_num_rays_per_chunk": 96,
}
BATCH = {"num_rgb_patches": 2, "patch_size": 8, "num_lidar_rays": 32, "num_radar_scans": 2, "max_radar_gt": 16}


def tiny_config() -> dict:
    """The neuradar configuration file, shrunk."""
    cfg = json.loads((BENCH / "configs" / "neuradar.json").read_text())
    cfg["model"] = dict(cfg["model"], nff_chunks=2, radar_decode_chunks=2, eval_num_rays_per_chunk=96)
    cfg["batch"] = dict(BATCH)
    f = 18 / (math.pi / 3)
    cfg["scene"].update(num_frames=8, coarse_image=[24, 36], image=[24, 36], lidar_points_per_scan=256,
                        intrinsics=[f, f, 18.0, 12.0],
                        radar_fov={"min_azimuth": -0.16, "max_azimuth": 0.16, "min_elevation": -0.02,
                                   "max_elevation": 0.04, "azimuth_step": 0.02, "elevation_step": 0.02})
    return cfg


def tiny_traffic(name: str) -> dict:
    tr = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    if name == "render_camera":
        tr["hw"] = [24, 36]
    return tr


def _shrink(model) -> None:
    """``OVERRIDES`` set on a model configuration (the port's or the reference's)."""
    for path, value in OVERRIDES.items():
        *head, last = path.split(".")
        obj = model
        for part in head:
            obj = getattr(obj, part)
        if not hasattr(obj, last):
            raise AttributeError(f"no setting {path!r}")
        setattr(obj, last, tuple(value) if isinstance(value, list) else value)


def patch_port(monkeypatch, port):
    """The port's registry gives the preset with the tiny model and batch, and the harness's
    reference the tiny model."""
    from harness import runner

    real, real_ref = port.get_method, runner.model_config

    def shrunk(name):
        cfg = real(name)
        _shrink(cfg.pipeline.model)
        for k, v in BATCH.items():
            setattr(cfg.pipeline.datamanager, k, v)
        return cfg

    def shrunk_ref(spec):
        cfg = real_ref(spec)
        _shrink(cfg)
        return cfg

    monkeypatch.setattr(port, "get_method", shrunk)
    monkeypatch.setattr(runner, "model_config", shrunk_ref)


def tiny_cell(kind: str, limits: dict):
    from harness.runner import Cell

    workload = {"name": f"tiny.{kind}", "config": "neuradar", "traffic": kind, "chips": 1, "why": "test"}
    return Cell(workload=workload, config=tiny_config(), traffic=tiny_traffic(kind), limits=copy.deepcopy(limits))


def cpu_args(seed: int = 7, trace: bool = False, control: bool = False, seconds: float = 0.3):
    from harness.runner import RunArgs

    return RunArgs(seed=seed, seconds=seconds, trace=trace, device=torch.device("cpu"), control=control)
