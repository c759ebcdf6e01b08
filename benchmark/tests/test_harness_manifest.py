"""The manifest against its format's rules, and finding every file of a cell by name."""

import copy
import json
import shutil
from pathlib import Path

import pytest

from harness import manifest as mf

ROOT = Path(__file__).resolve().parents[2]


def _manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_holds_its_format_rules():
    assert mf.check_manifest(_manifest(), ROOT) == []


@pytest.mark.parametrize("section,key,bad", [
    ("workloads", "name", "neuradar train"),
    ("workloads", "name", "a/b"),
    ("end_to_end", "unit", "rays per second"),
    ("per_layer", "unit", "µs"),
    ("per_layer", "better", "up"),
    ("configs", "why", "two\nlines"),
    ("per_layer", "layer", "x" * 201),
])
def test_bad_names_and_units_are_refused(section, key, bad):
    m = _manifest()
    m[section][0][key] = bad
    assert mf.check_manifest(m, ROOT)


def test_an_extra_key_and_a_repeated_pair_are_refused():
    m = _manifest()
    m["per_layer"][0]["why"] = "no"
    m["workloads"].append(dict(m["workloads"][0], name="again"))
    faults = mf.check_manifest(m, ROOT)
    assert any("keys" in f for f in faults) and any("repeat" in f for f in faults)


@pytest.mark.parametrize("workload", [w["name"] for w in _manifest()["workloads"]])
def test_every_cell_finds_its_files_by_name(workload):
    m = _manifest()
    w = mf.find(m["workloads"], workload, "workload")
    config = json.loads((ROOT / mf.find(m["configs"], w["config"], "configuration")["file"]).read_text())
    assert config["name"] == w["config"]
    assert mf.load_kind(mf.load_json("traffic", w["traffic"])["kind"])
    assert mf.load_json("limits", workload)
    metrics = mf.cell_metrics(m, workload, "per_layer")
    assert metrics
    for metric in metrics:
        assert callable(mf.load_reader(metric["name"]))


SWEEP_KIND = '''"""Radar scans asked for in order, from a start drawn by the seed."""

import numpy as np

from harness import roofline
from harness.runner import Serving
from reference.nrref.models.neuradar import SegmentLayout

RATE_METRIC = "render_rays_per_s"


def requests(traffic, scene, seed, count):
    n = len(scene.radar_to_worlds)
    start = int(np.random.RandomState(seed).randint(n))
    return [(start + i) % n for i in range(count)]


def serving(pipeline, traffic, cfg, port):
    rays = int(pipeline.tables.radars.rays_per_scan)
    return Serving(rays=rays, unit_flops=roofline.radar_request_flops(cfg, rays),
                   layout=SegmentLayout(num_radar_scans=1, rays_per_scan=rays),
                   serve=lambda scan: port.render_radar(pipeline, scan),
                   reference=lambda ref, scan: ref.render_radar(scan))


def numbers(answers, refs):
    return {"existence_gap": max(float(np.abs(a[:, 0] - r[:, 0]).max()) for a, r in zip(answers, refs))}
'''


def test_a_cell_and_a_metric_are_added_by_new_files_alone(tmp_path, port):
    """A copy of the benchmark gains a configuration, a kind of traffic with a mix of it, limits
    and a per-layer reader as new files, and the manifest new entries; no file that was there
    changes, and a traced run and a timed run of the new cell report the new metrics."""
    import run
    from tiny import tiny_config, tiny_traffic

    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "configs" / "tiny.json").write_text(json.dumps(dict(tiny_config(), name="tiny")))
    (bench / "kinds" / "radar_sweep.py").write_text(SWEEP_KIND)
    (bench / "traffic" / "sweep_few.json").write_text(
        json.dumps(dict(tiny_traffic("render_radar"), kind="radar_sweep", trace_units=3)))
    (bench / "limits" / "tiny.sweep_few.json").write_text(json.dumps({"existence_gap": 1e-6}))
    (bench / "layer_metrics" / "requests_traced.sweep_few.py").write_text(
        '"""Requests in the traced window."""\n\n\ndef read(view):\n    return float(view.units)\n')
    m = copy.deepcopy(_manifest())
    m["configs"].append({"name": "tiny", "source": "https://github.com/mrafidashti/neuradar",
                         "file": "benchmark/configs/tiny.json", "reduced": ["scene"], "why": "test"})
    m["workloads"].append({"name": "tiny.sweep_few", "config": "tiny", "traffic": "sweep_few", "chips": 1,
                           "why": "test"})
    for e in m["end_to_end"]:
        if "workloads" in e and e["name"] in ("render_rays_per_s", "request_ms_p95"):
            e["workloads"].append("tiny.sweep_few")
    m["per_layer"].append({"name": "requests_traced.sweep_few", "unit": "requests", "better": "higher",
                           "source": "host_clock", "layer": "render request (pipelines/ad_neuradar_pipeline.py)",
                           "moves": "request_ms_p95", "workloads": ["tiny.sweep_few"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    assert mf.check_manifest(m, tmp_path) == []
    assert all(p.read_bytes() == data for p, data in before.items())

    import torch

    line, _ = run.execute("tiny.sweep_few", 5, 0.2, True, torch.device("cpu"), tmp_path, bench=bench)
    assert line["metrics"]["requests_traced.sweep_few"]["value"] == 3.0
    assert line["correct"] and set(line["checks"]) == {"existence_gap"}
    line, _ = run.execute("tiny.sweep_few", 6, 0.2, False, torch.device("cpu"), tmp_path, bench=bench)
    assert {"render_rays_per_s", "request_ms_p95", "setup_s", "peak_mem_gb"} == set(line["metrics"])
    assert line["correct"]
