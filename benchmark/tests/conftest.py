"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``cuda`` that skip without a CUDA device.  Run them from the repository's
root: ``python -m pytest benchmark/tests -q``."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs on a CUDA device; skipped without one")


@pytest.fixture()
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs on the card")
    return torch.device("cuda", 0)
