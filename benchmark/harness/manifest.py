"""The manifest (``BENCHMARK.json`` at the checkout's root) and the files it names.

Everything that belongs to one configuration, one traffic mix or one per-layer metric sits in a
file of its own, found by name, so that a new cell or metric is new files and new entries:

* ``configs/<config>.json``: the configuration's file of sizes (the manifest's ``file``);
* ``traffic/<traffic>.json``: the parameters of a traffic mix, whose ``kind`` names its driver;
* ``kinds/<kind>.py``: the driver of a kind of traffic: its requests, the program's and the
  reference's answers and the numbers that compare them (``harness/runner.py`` says what it gives);
* ``layer_metrics/<metric>.py``: a reader ``read(view) -> float | None`` of a traced window;
* ``limits/<workload>.json``: the limits of the cell's correctness numbers.

``check_manifest`` holds a manifest to its format's naming and shape rules.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def load_manifest(root: Path) -> Dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json in {root}")
    return json.loads(path.read_text())


def find(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}")


def load_json(kind: str, name: str, bench: Path = HERE) -> Dict:
    """``<kind>/<name>.json`` of the benchmark's folder ``bench``."""
    return json.loads((bench / kind / f"{name}.json").read_text())


def _load_module(folder: str, name: str, bench: Path) -> ModuleType:
    path = bench / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder}/{name}.py in {bench}")
    spec = importlib.util.spec_from_file_location(f"bench_{folder}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # a dataclass looks its module up there
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str, bench: Path = HERE) -> Callable:
    """The ``read`` function of ``layer_metrics/<metric>.py`` of the benchmark's folder ``bench``."""
    return _load_module("layer_metrics", metric, bench).read


def load_kind(kind: str, bench: Path = HERE) -> ModuleType:
    """The module ``kinds/<kind>.py`` of the benchmark's folder ``bench``."""
    return _load_module("kinds", kind, bench)


def cell_metrics(manifest: Dict, workload: str, section: str) -> List[Dict]:
    """The metrics of ``section`` that a cell reports: those listing it, and those listing none."""
    return [m for m in manifest[section] if workload in m.get("workloads", [workload])]


def _line(text: str) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def check_manifest(manifest: Dict, root: Path) -> List[str]:
    """The manifest's faults against its format's rules (empty when it holds)."""
    bad: List[str] = []
    if set(manifest) != TOP_KEYS:
        bad.append(f"top-level keys {sorted(manifest)}")
    cmd, paths = manifest.get("command", []), manifest.get("paths", [])
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)):
        bad.append("command")
    if not (1 <= len(paths) <= 16 and all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in paths)):
        bad.append("paths")
    if not (isinstance(manifest.get("run_seconds"), int) and 1 <= manifest["run_seconds"] <= 51):
        bad.append("run_seconds")
    names = {}
    for section, keys in (("configs", CONFIG_KEYS), ("workloads", WORKLOAD_KEYS), ("end_to_end", E2E_KEYS),
                          ("per_layer", LAYER_KEYS)):
        for e in manifest.get(section, []):
            allowed = keys | ({"workloads"} if section in ("end_to_end", "per_layer") else set())
            if not keys <= set(e) <= allowed:
                bad.append(f"{section}: {e.get('name')} keys {sorted(e)}")
            if not NAME.match(str(e.get("name", ""))):
                bad.append(f"{section}: name {e.get('name')!r}")
            kind = "metric" if section in ("end_to_end", "per_layer") else section
            if (kind, e.get("name")) in names:
                bad.append(f"{section}: {e.get('name')} twice")
            names[(kind, e.get("name"))] = e
            if "unit" in e and not UNIT.match(e["unit"]):
                bad.append(f"{e['name']}: unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                bad.append(f"{e['name']}: better")
            for key in ("why", "layer", "source"):
                if key in e and not _line(e[key]):
                    bad.append(f"{e['name']}: {key}")
    configs = {c["name"]: c for c in manifest.get("configs", [])}
    workloads = {w["name"]: w for w in manifest.get("workloads", [])}
    used = set()
    for c in configs.values():
        if not any((root / c["file"]).resolve().is_relative_to((root / p).resolve()) for p in paths):
            bad.append(f"{c['name']}: file outside paths")
        if len(c["reduced"]) > 16 or not all(NAME.match(k) for k in c["reduced"]):
            bad.append(f"{c['name']}: reduced")
    for w in workloads.values():
        if w["config"] not in configs or not NAME.match(w["traffic"]) or w["chips"] not in (1, 4):
            bad.append(f"{w['name']}: config, traffic or chips")
        used.add(w["config"])
        if (w["config"], w["traffic"]) in {(v["config"], v["traffic"]) for v in workloads.values() if v is not w}:
            bad.append(f"{w['name']}: config and traffic repeat")
    if set(configs) - used:
        bad.append(f"configs without a cell: {sorted(set(configs) - used)}")
    e2e = {m["name"]: m for m in manifest.get("end_to_end", [])}
    if "setup_s" not in e2e or e2e["setup_s"].get("bound", 1) > 0.25:
        bad.append("setup_s")
    for m in e2e.values():
        if not 0.01 <= m.get("bound", 0) <= 0.25 or m["source"] not in ("host_clock", "device_trace"):
            bad.append(f"{m['name']}: bound or source")
    for m in manifest.get("per_layer", []):
        if m["moves"] not in e2e or m["source"] not in ("device_trace", "program_span", "program_counter",
                                                        "host_clock"):
            bad.append(f"{m['name']}: moves or source")
        for w in m.get("workloads", []):
            if w not in workloads or w not in e2e[m["moves"]].get("workloads", [w]):
                bad.append(f"{m['name']}: cell {w} does not report {m['moves']}")
    for w in workloads:
        reported = [m for m in e2e.values() if w in m.get("workloads", [w])]
        layered = [m for m in manifest.get("per_layer", []) if w in m.get("workloads", [w])]
        if len(reported) < 2 or not layered:
            bad.append(f"{w}: needs setup_s, another end-to-end metric and a per-layer metric")
    return bad
