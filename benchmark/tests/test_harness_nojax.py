"""No JAX in a run: the top-level names are compared whole, and the reference imports nothing of
the port."""

import ast
import subprocess
import sys
from pathlib import Path

import run

BENCH = Path(__file__).resolve().parents[1]


def test_top_level_names_are_compared_whole(monkeypatch):
    for name in ("neuradar_tpu_torch", "neuradar_tpu_torch.ops.attention", "jaxtyping", "flaxen", "neuradar_tpu2"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.loaded_forbidden() == [m for m in run.loaded_forbidden() if m.split(".")[0] in run.FORBIDDEN]
    assert not {"neuradar_tpu_torch", "jaxtyping", "flaxen", "neuradar_tpu2"} & set(run.loaded_forbidden())
    for name in ("jax", "jax.numpy", "jaxlib", "flax.linen", "neuradar_tpu", "neuradar_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, sys)
        assert name in run.loaded_forbidden()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_port_or_jax():
    files = list((BENCH / "reference").rglob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in ("neuradar_tpu_torch", "neuradar_tpu", "jax", "jaxlib", "flax"), (path, name)


def test_only_the_port_adapter_imports_the_port():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("neuradar_tpu", "jax", "jaxlib", "flax"), (path, name)
            if top == "neuradar_tpu_torch":
                assert path.name == "port.py", path


def test_a_run_loads_no_jax():
    """A tiny run in a fresh interpreter leaves no JAX module loaded."""
    code = (
        "import sys, torch; sys.path[:0] = [%r, %r, %r]; torch.set_num_threads(2)\n"
        "import run, tiny\n"
        "from harness import port, runner\n"
        "class MP:\n"
        "    setattr = staticmethod(setattr)\n"
        "tiny.patch_port(MP(), port)\n"
        "runner.run_cell(tiny.tiny_cell('render_radar', {'radar_gap': 1.0}), tiny.cpu_args(), port)\n"
        "print(run.loaded_forbidden())\n"
    ) % (str(BENCH / "tests"), str(BENCH), str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
