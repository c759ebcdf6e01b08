"""The splatfacto cell at a tiny size on the CPU: a whole run reads ``correct`` true, and the bf16
control, a timed path that drops the SH bands and one whose optimizer leaves the state unchanged
fail the committed limits (the control by one of them at least: at this size a gaussian covers few
pixels, and the card's runs at the cell's size hold it to every limit); and the yardstick's counts
by hand."""

import copy
import json
import math
from pathlib import Path

import pytest

from harness.runner import Cell, run_cell
from harness.splat_count import RASTER_BWD_OPS, RASTER_FWD_OPS, SplatLayout, raster_bwd, raster_fwd, sh_ops, step_flops
from tiny import cpu_args

BENCH = Path(__file__).resolve().parents[1]
CELL = "splatfacto-big.train"
TINY_MODEL = {"max_gaussians": 3072, "tile_top_k": 48}


def _limits():
    return json.loads((BENCH / "limits" / f"{CELL}.json").read_text())


def _config():
    """The cell's configuration file at 3,072 gaussians, 48 a tile, on an 8-frame 48 x 64 scene."""
    cfg = json.loads((BENCH / "configs" / "splatfacto-big.json").read_text())
    cfg["model"].update(TINY_MODEL)
    f = 64 / (math.pi / 3)
    cfg["scene"].update(num_frames=8, coarse_image=[24, 32], image=[48, 64], lidar_points_per_scan=128,
                        intrinsics=[f, f, 32.0, 24.0])
    return cfg


@pytest.fixture
def splat_port(monkeypatch):
    from harness import port

    real = port.get_method

    def shrunk(name):
        cfg = real(name)
        for k, v in TINY_MODEL.items():
            setattr(cfg.model, k, v)
        return cfg

    monkeypatch.setattr(port, "get_method", shrunk)
    return port


def _cell(limits):
    workload = {"name": "tiny.train_splat", "config": "splatfacto-big", "traffic": "train_splat", "chips": 1,
                "why": "test"}
    traffic = json.loads((BENCH / "traffic" / "train_splat.json").read_text())
    return Cell(workload=workload, config=_config(), traffic=traffic, limits=copy.deepcopy(limits))


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_a_tiny_run_is_correct_and_the_control_fails(seed, splat_port):
    limits = _limits()
    result = run_cell(_cell(limits), cpu_args(seed=seed, control=True, seconds=0.2), splat_port)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert any(result["control"][k] > limit for k, limit in limits.items()), result["control"]


def _fault_no_sh(monkeypatch):
    from neuradar_tpu_torch.models import splatfacto as sf

    real = sf.gaussian_colors
    monkeypatch.setattr(sf, "gaussian_colors", lambda params, origin, degree: real(params, origin, 0))


def _fault_state_unchanged(monkeypatch):
    from neuradar_tpu_torch.engine import optimizers

    monkeypatch.setattr(optimizers.GroupedOptimizer, "step", lambda self, step: None)


@pytest.mark.parametrize("fault", [_fault_no_sh, _fault_state_unchanged])
def test_a_fault_in_the_timed_path_is_not_correct(fault, splat_port, monkeypatch):
    fault(monkeypatch)
    result = run_cell(_cell(_limits()), cpu_args(seed=11, seconds=0.2), splat_port)
    assert result["correct"] is False, result["checks"]


def test_the_traced_window_gives_every_splat_metric(splat_port):
    """On the CPU the device readers have no kernels to read; the program's counters and spans are
    there."""
    from harness import manifest as mf

    manifest = mf.load_manifest(BENCH.parent)
    cell = _cell(_limits())
    cell.per_layer = mf.cell_metrics(manifest, CELL, "per_layer")
    result = run_cell(cell, cpu_args(seed=3, trace=True), splat_port)
    assert result["correct"], result["checks"]
    got = set(result["metrics"])
    assert {"step_mfu.splat", "idle_share.splat"} <= got, got
    assert result["metrics"]["step_mfu.splat"]["value"] > 0


def test_the_counts_by_hand():
    layout = SplatLayout(gaussians=1_048_576, height=1216, width=1936, top_k=512, sh_degree=3)
    assert layout.tiles == 76 * 121 == 9196 and layout.pixels == 2_354_176
    assert layout.params_per_gaussian == 59 and layout.gaussians * layout.params_per_gaussian == 61_865_984
    pairs = 9196 * 512  # every tile full
    nbytes, ops = raster_fwd(pairs, layout)
    assert ops == pairs * 256 * 26 == RASTER_FWD_OPS * 1_205_338_112
    assert nbytes == pairs * 44 + 9196 * 12 + 2_354_176 * 20
    nbytes, ops = raster_bwd(pairs, layout, launches=2)
    assert ops == pairs * 256 * RASTER_BWD_OPS
    assert nbytes == pairs * 84 + 2 * (9196 * 12 + 2_354_176 * 40)
    assert sh_ops(3) == 10 + 45 + 90 + 9 and sh_ops(0) == 19
    gaussians = 1_048_576 * 3 * (300 + 154)
    raster = pairs * 256 * (26 + 64)
    ssim = 3 * 5 * 49 * 3 * 2_354_176
    adam = 12 * 61_865_984
    assert step_flops(layout, pairs) == gaussians + raster + ssim + adam
    # the raster is most of it: a step of 9196 full tiles is about 112 GFLOP
    assert 1.0e11 < step_flops(layout, pairs) < 1.2e11
