"""The benchmark's CPU tests: the harness's modules and the port on the import path, torch on two
threads, and the port's registry shrunk to the tiny configuration (``tiny.py``).

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent), str(HERE.parent.parent)]
torch.set_num_threads(2)


@pytest.fixture
def port(monkeypatch):
    """``harness.port`` with the registry's presets at the tiny batch."""
    from harness import port as port_module
    from tiny import patch_port

    patch_port(monkeypatch, port_module)
    return port_module
