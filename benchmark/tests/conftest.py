"""The benchmark's own tests (python -m pytest benchmark/tests). They run
the harness on the CPU through the port's plain twins at 60x80; the tests
marked cuda run it on the card and skip where torch finds none (on the
chip: python3 -m pytest -m cuda benchmark/tests). Nothing here imports
jax: tests/conftest.py does, and this folder does not use it."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips where torch finds none")


@pytest.fixture
def card():
    """The CUDA card, or a skip where torch finds none (decided here, not
    at import, so every worker collects the same tests)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch finds none")
    return torch.device("cuda", 0)
