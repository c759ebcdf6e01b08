"""A whole run on the CPU at the tiny size, the look for a card left out: the result line's keys,
its metrics, and the program against the reference (the same code on the CPU: no gap)."""

import json
import shutil
from pathlib import Path

import pytest
import torch

import run
from tiny import tiny_config, tiny_traffic

ROOT = Path(__file__).resolve().parents[2]
KINDS = {"train": "neuradar.train", "render_radar": "neuradar.render_radar", "render_camera": "neuradar.render_camera"}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A checkout whose manifest's neuradar configuration is the tiny one."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "benchmark" / "configs" / "neuradar.json").write_text(json.dumps(tiny_config()))
    for name in ("train", "render_radar", "render_camera"):
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(tiny_traffic(name)))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_last_line(kind, trace, tiny_root, port):
    workload = KINDS[kind]
    line, err = run.execute(workload, 2**31 + 11, 0.3, bool(trace), torch.device("cpu"), tiny_root,
                            bench=tiny_root / "benchmark")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert ("breakdown" in line) == bool(trace)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    section = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in manifest[section] if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) <= set(allowed)
    if not trace:
        assert set(line["metrics"]) == set(allowed)
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == allowed[name]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, check in line["checks"].items():
        assert check["value"] == 0.0, name  # the same code on the CPU
        assert f"check {name}:" in "\n".join(err)
    json.dumps(line)
