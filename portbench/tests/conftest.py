"""The benchmark's own tests: `python -m pytest portbench/tests -q` from
the repository's root. Tests that need a CUDA card carry the `chip`
marker and skip elsewhere; whether there is a card is decided inside the
`cuda_device` fixture, never while a module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skipped on a machine without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
