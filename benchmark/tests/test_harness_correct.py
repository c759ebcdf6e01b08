"""``correct`` comes out false where it should: the precision control (the reference one precision
below the configuration's) and faults planted in the program underneath a whole run, each judged by
the committed limits of the cell it stands for. Tiny size, on the CPU, the look for a card left out."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from harness.runner import run_cell
from tiny import cpu_args, tiny_cell

BENCH = Path(__file__).resolve().parents[1]
CELLS = {"train": "neuradar.train", "render_radar": "neuradar.render_radar", "render_camera": "neuradar.render_camera"}


def _limits(kind):
    return json.loads((BENCH / "limits" / f"{CELLS[kind]}.json").read_text())


@pytest.mark.parametrize("seed", [3, 2**31 + 5, 77])
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_the_control_fails_the_committed_limits(kind, seed, port):
    limits = _limits(kind)
    result = run_cell(tiny_cell(kind, limits), cpu_args(seed=seed, control=True), port)
    assert result["correct"]
    assert any(result["control"][k] > limit for k, limit in limits.items()), result["control"]


def _halve(batch):
    """Each per-row array's second half replaced by its first: the loss's mean is over half."""
    out = {}
    for k, v in batch.items():
        v = v.clone()
        h = v.shape[0] // 2
        v[h:2 * h] = v[:h]
        out[k] = v
    return out


def _fault_train_unchanged(monkeypatch):
    from neuradar_tpu_torch.engine import optimizers

    monkeypatch.setattr(optimizers.GroupedOptimizer, "step", lambda self, step: None)


def _fault_train_half_batch(monkeypatch):
    from neuradar_tpu_torch.pipelines import ad_neuradar_pipeline as p

    real = p.batch_to_device
    monkeypatch.setattr(p, "batch_to_device", lambda batch, device: _halve(real(batch, device)))


def _wrap_render_radar(monkeypatch, change):
    from neuradar_tpu_torch.pipelines.ad_neuradar_pipeline import ADNeuRadarPipeline

    real = ADNeuRadarPipeline.render_radar

    def broken(self, scan_idx, actor_edits=None):
        out = real(self, scan_idx, actor_edits)
        return {"radar_output": change(out["radar_output"].clone())}

    monkeypatch.setattr(ADNeuRadarPipeline, "render_radar", broken)


def _fault_radar_half(monkeypatch):
    def change(ro):
        h = ro.shape[0] // 2
        ro[h:2 * h] = ro[:h]
        return ro
    _wrap_render_radar(monkeypatch, change)


def _fault_radar_altered(monkeypatch):
    """Each request answered with the neighbouring scan's output (a misrouted answer)."""
    from neuradar_tpu_torch.pipelines.ad_neuradar_pipeline import ADNeuRadarPipeline

    real = ADNeuRadarPipeline.render_radar

    def misrouted(self, scan_idx, actor_edits=None):
        return real(self, (int(scan_idx) + 1) % len(self.outputs.radar_to_worlds), actor_edits)

    monkeypatch.setattr(ADNeuRadarPipeline, "render_radar", misrouted)


def _wrap_render_pose(monkeypatch, change):
    from neuradar_tpu_torch.pipelines.ad_neuradar_pipeline import ADNeuRadarPipeline

    real = ADNeuRadarPipeline.render_pose
    monkeypatch.setattr(ADNeuRadarPipeline, "render_pose", lambda self, *a, **k: change(real(self, *a, **k).copy()))


def _fault_camera_half(monkeypatch):
    def change(img):
        h = img.shape[0] // 2
        img[h:2 * h] = img[:h]
        return img
    _wrap_render_pose(monkeypatch, change)


def _fault_camera_altered(monkeypatch):
    _wrap_render_pose(monkeypatch, lambda img: np.clip(img.astype(np.int16) + 8, 0, 255).astype(np.uint8))


FAULTS = {
    ("train", "state_unchanged"): _fault_train_unchanged,
    ("train", "half_batch"): _fault_train_half_batch,
    ("render_radar", "half_batch"): _fault_radar_half,
    ("render_radar", "answer_altered"): _fault_radar_altered,
    ("render_camera", "half_batch"): _fault_camera_half,
    ("render_camera", "answer_altered"): _fault_camera_altered,
}


@pytest.mark.parametrize("kind,fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(kind, fault, port, monkeypatch):
    FAULTS[(kind, fault)](monkeypatch)
    result = run_cell(tiny_cell(kind, _limits(kind)), cpu_args(seed=19), port)
    assert result["correct"] is False, result["checks"]


def test_the_fp8_rounding_is_scaled_and_passes_gradients():
    from reference.nrref import lowp

    x = (torch.randn(1000, dtype=torch.bfloat16) * 1e-3).requires_grad_(True)
    assert lowp.round_fp8(x) is x
    with lowp.float8_weights():
        y = lowp.round_fp8(x)
        y.sum().backward()
    rel = ((y - x).float().norm() / x.float().norm()).item()
    assert 1e-3 < rel < 0.1  # e4m3's 3 mantissa bits, scaled: no flush to zero
    assert torch.equal(x.grad, torch.ones_like(x))
