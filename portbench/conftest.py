"""pytest settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the repository's sources on the path, and the ``card``
marker for tests that need a CUDA card. A card test takes the ``card``
fixture, which skips it where there is none; nothing is decided while a
module is imported."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (run on the chip)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
