"""Settings of the benchmark's own tests (``python -m pytest
mpcbench/tests``): the repository root on the path, the ``gpu`` marker for
tests that need a CUDA card, decided inside a fixture, and PyTorch on few
threads."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card machine with "
                    "python -m pytest mpcbench/tests -m gpu")
    return "cuda"


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
