"""The nerfacto cell at a tiny size on the CPU: a whole run reads ``correct`` true, and the bf16
control, a timed path that drops the proposal anneal's exponent and one whose optimizer leaves the
state unchanged fail the committed limits (the control by one of them at least); the traced window
gives the program's spans and counters; and the yardstick's counts by hand."""

import copy
import json
import math
from pathlib import Path

import pytest

from harness.nerfacto_count import Grid, encode_fwd_bytes, k4_fwd_bytes, layout_of, step_flops
from harness.runner import Cell, run_cell
from tiny import cpu_args

BENCH = Path(__file__).resolve().parents[1]
CELL = "nerfacto-huge.train"
TINY_MODEL = {
    "num_levels": 4, "log2_hashmap_size": 12, "max_res": 256, "hidden_dim": 32, "hidden_dim_color": 32,
    "num_proposal_samples_per_ray": [24, 16], "num_nerf_samples_per_ray": 12, "num_rgb_patches": 2,
    "proposal_net_args_list": [
        {"hidden_dim": 16, "log2_hashmap_size": 10, "num_levels": 3, "max_res": 64, "use_linear": False},
        {"hidden_dim": 16, "log2_hashmap_size": 10, "num_levels": 4, "max_res": 128, "use_linear": False}],
}


def _limits():
    return json.loads((BENCH / "limits" / f"{CELL}.json").read_text())


def _config():
    """The cell's configuration file shrunk (small grids and MLPs, 2 patches, a few samples a round), on
    an 8-frame 48 x 64 scene."""
    cfg = json.loads((BENCH / "configs" / "nerfacto-huge.json").read_text())
    cfg["model"].update(copy.deepcopy(TINY_MODEL))
    f = 64 / (math.pi / 3)
    cfg["scene"].update(num_frames=8, coarse_image=[24, 32], image=[48, 64], lidar_points_per_scan=128,
                        intrinsics=[f, f, 32.0, 24.0])
    return cfg


@pytest.fixture
def nerfacto_port(monkeypatch):
    from harness import port

    real = port.get_method

    def shrunk(name):
        cfg = real(name)
        for k, v in TINY_MODEL.items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
            else:
                setattr(cfg.model, k, tuple(v) if isinstance(v, list) else v)
        return cfg

    monkeypatch.setattr(port, "get_method", shrunk)
    return port


def _cell(limits):
    workload = {"name": "tiny.train_nerfacto", "config": "nerfacto-huge", "traffic": "train_nerfacto", "chips": 1,
                "why": "test"}
    traffic = json.loads((BENCH / "traffic" / "train_nerfacto.json").read_text())
    return Cell(workload=workload, config=_config(), traffic=traffic, limits=copy.deepcopy(limits))


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_a_tiny_run_is_correct_and_the_control_fails(seed, nerfacto_port):
    limits = _limits()
    result = run_cell(_cell(limits), cpu_args(seed=seed, control=True, seconds=0.2), nerfacto_port)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert any(result["control"][k] > limit for k, limit in limits.items()), result["control"]


def _fault_no_anneal(monkeypatch):
    from neuradar_tpu_torch.models import nerfacto

    monkeypatch.setattr(nerfacto.NerfactoModel, "anneal_for_step", lambda self, step: 0.5)


def _fault_state_unchanged(monkeypatch):
    from neuradar_tpu_torch.engine import optimizers

    monkeypatch.setattr(optimizers.GroupedOptimizer, "step", lambda self, step: None)


@pytest.mark.parametrize("fault", [_fault_no_anneal, _fault_state_unchanged])
def test_a_fault_in_the_timed_path_is_not_correct(fault, nerfacto_port, monkeypatch):
    fault(monkeypatch)
    result = run_cell(_cell(_limits()), cpu_args(seed=11, seconds=0.2), nerfacto_port)
    assert result["correct"] is False, result["checks"]


def test_the_traced_window_gives_the_program_metrics(nerfacto_port):
    """On the CPU the device readers have no kernels to read; the program's counters are there."""
    from harness import manifest as mf

    manifest = mf.load_manifest(BENCH.parent)
    cell = _cell(_limits())
    cell.per_layer = mf.cell_metrics(manifest, CELL, "per_layer")
    assert {m["name"] for m in cell.per_layer} == {
        "step_mfu.nerfacto", "proposal_ms.nerfacto", "hash_encode_ms.nerfacto", "hash_scatter_ms.nerfacto",
        "losses_ms.nerfacto", "k4_roofline.nerfacto", "idle_share.nerfacto"}
    result = run_cell(cell, cpu_args(seed=3, trace=True), nerfacto_port)
    assert result["correct"], result["checks"]
    got = set(result["metrics"])
    assert {"step_mfu.nerfacto", "idle_share.nerfacto"} <= got, got
    assert result["metrics"]["step_mfu.nerfacto"]["value"] > 0


def test_the_counts_by_hand():
    model = json.loads((BENCH / "configs" / "nerfacto-huge.json").read_text())["model"]
    layout = layout_of(model)
    R = 16384
    assert layout.rays == R and layout.field_grid.resolutions()[-1] == 8191.0
    proposal, field = R * 1024, R * 64
    # per sample: round 0 10 -> 16 -> 1, round 1 14 -> 16 -> 1; field 32 -> 256 -> 16 and 63 -> 256 -> 256 -> 3
    fwd = R * 512 * 2 * (10 * 16 + 16) + R * 512 * 2 * (14 * 16 + 16)
    fwd += field * 2 * (32 * 256 + 256 * 16 + 63 * 256 + 256 * 256 + 256 * 3)
    assert step_flops(layout, proposal, field) == 3 * fwd
    assert 6.0e11 < step_flops(layout, proposal, field) < 6.4e11
    g = Grid(levels=2, rows=1 << 10, features=2, base_res=4, max_res=64)
    assert g.resolutions() == [4.0, 64.0]
    # 100 samples: positions 12 and output 16 bytes each; level 0 reaches 5^3 = 125 rows, level 1 the
    # 800 corner rows of its lookups (under its 1,024 rows and 65^3 corners)
    assert encode_fwd_bytes(g, 100) == 100 * 28 + (125 + 800) * 8
    nbytes, encodes = k4_fwd_bytes(layout, proposal, field)
    assert encodes == 3 and 1.3e9 < nbytes < 1.4e9
