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


@pytest.fixture()
def kinds(monkeypatch):
    """The request kinds of ``benchmark/tests/kinds/``, found as modules of
    ``benchmark.entries`` for the test's length: registered by the test,
    with no file added to ``benchmark/entries/``."""
    import importlib

    import benchmark.entries as entries

    here = pathlib.Path(__file__).resolve().parent / "kinds"
    monkeypatch.setattr(entries, "__path__", [*entries.__path__, str(here)])
    importlib.invalidate_caches()
    yield
    for name in [n for n, m in sys.modules.items()
                 if n.startswith("benchmark.entries.")
                 and str(getattr(m, "__file__", "")).startswith(str(here))]:
        del sys.modules[name]
